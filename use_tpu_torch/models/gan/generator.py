"""LSGAN generator: NCSN++ (discriminative) behind the STFT front-end.

Port of use_tpu/models/gan/generator.py::NCSNPPWrapper (reference
GAN/generator/ncsnpp/model_wrapper.py:19-123), inference: the compressed
spectrogram, its frame axis padded to a multiple of 64, goes through the
discriminative NCSN++ (2 input channels, no time conditioning, no 1/sigma
scaling) and back to a wav of the original length. The random-crop
training path comes with the training slice.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Union

import torch

from use_tpu_torch.models.registry import BackboneRegistry, GeneratorRegistry
from use_tpu_torch.ops import STFTConfig, istft, pad_spec, spec_back, spec_fwd, stft
from use_tpu_torch.utils.device import resolve_device

Batch = Dict[str, torch.Tensor]


@GeneratorRegistry.register("ncsnpp_wrapper")
@dataclass
class NCSNPPWrapper:
    """Shipping LSGAN G config: configs/model/LSGAN.yaml:44-50.

    device: 'cuda' (default) or 'cpu'; CUDA without a card raises.
    seed: seed of the backbone's random initialization.
    """

    n_fft: int = 1022
    hop_length: int = 160
    num_frames: int = 480
    window: str = "hann"
    spec_factor: float = 0.15
    spec_abs_exponent: float = 0.5
    backbone: str = "ncsnpp"
    backbone_kwargs: Dict[str, Any] = field(default_factory=dict)
    device: Union[str, torch.device] = "cuda"
    seed: int = 0

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.net = BackboneRegistry.get_by_name(self.backbone)(
            discriminative=True, seed=self.seed, **self.backbone_kwargs
        ).to(self.device)
        self.stft_cfg = STFTConfig(
            n_fft=self.n_fft, hop_length=self.hop_length, window=self.window
        )
        self.target_len = (self.num_frames - 1) * self.hop_length

    def _spec(self, wav: torch.Tensor) -> torch.Tensor:
        return spec_fwd(stft(wav, self.stft_cfg), self.spec_factor, self.spec_abs_exponent)

    def _inv(self, spec: torch.Tensor, length: int) -> torch.Tensor:
        return istft(
            spec_back(spec, self.spec_factor, self.spec_abs_exponent), self.stft_cfg,
            length=length,
        )

    def forward_train(self, batch: Batch, generator=None) -> Batch:
        raise NotImplementedError(
            "NCSNPPWrapper.forward_train (the random-crop training path) is not ported yet "
            "(ROADMAP queue 1)"
        )

    @torch.inference_mode()
    def forward_infer(self, batch: Batch) -> Batch:
        """Full-utterance enhancement (model_wrapper.py:114-122): writes
        batch['fake'], [B, L] as batch['perturbed']."""
        y = torch.as_tensor(batch["perturbed"], device=self.device)
        y_spec = pad_spec(self._spec(y))
        fake_spec = self.net(y_spec, None)[..., 0, :]  # [B, F, T, 2]
        out = dict(batch)
        out["fake"] = self._inv(fake_spec, y.shape[-1])
        return out

    def __call__(self, batch: Batch, generator=None, train: bool = False) -> Batch:
        if train and "clean" in batch:
            return self.forward_train(batch, generator)
        return self.forward_infer(batch)
