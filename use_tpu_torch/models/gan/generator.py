"""LSGAN generator: NCSN++ (discriminative) behind the STFT front-end.

Port of use_tpu/models/gan/generator.py::NCSNPPWrapper (reference
GAN/generator/ncsnpp/model_wrapper.py:19-123), inference: the compressed
spectrogram, its frame axis padded to a multiple of 64, goes through the
discriminative NCSN++ (2 input channels, no time conditioning, no 1/sigma
scaling) and back to a wav of the original length. Training
(``forward_train``): clean and perturbed clips cropped to
(num_frames - 1) * hop samples at one start (or centre-padded when
shorter), the net on the unpadded spectrogram, the fake back to a wav.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Protocol, Union

import torch

from use_tpu_torch.models.ncsnpp.ncsnpp import cast_backbone_for_inference
from use_tpu_torch.models.registry import BackboneRegistry, GeneratorRegistry
from use_tpu_torch.ops import STFTConfig, istft, pad_spec, spec_back, spec_fwd, stft
from use_tpu_torch.utils.device import resolve_device

Batch = Dict[str, torch.Tensor]


class Generator(Protocol):
    """What the LSGAN task, the engine and the CLI ask of a generator
    (NCSNPPWrapper, csmgan.CSMGANWrapper): its trainable network, the clip
    length its discriminator is built for, its device, a crop start for a
    training clip, the training pass (``__call__`` with train=True and that
    start), serving (``forward_infer``) and the serving cast."""

    net: torch.nn.Module
    target_len: int
    device: torch.device

    def draw_start(self, length: int, generator: Optional[torch.Generator] = None) -> int: ...

    def forward_infer(self, batch: Batch) -> Batch: ...

    def cast_for_inference(self) -> None: ...

    def __call__(self, batch: Batch, generator: Optional[torch.Generator] = None,
                 train: bool = False, start: Optional[int] = None) -> Batch: ...


# the methods the CLI checks a registered generator class for, before it
# builds one (HifiganGenerator and BandwidthExtender are registered too,
# and lack them)
GENERATOR_INTERFACE = ("draw_start", "forward_infer", "cast_for_inference")


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

    def cast_for_inference(self) -> None:
        """Cast the backbone to its compute dtype, in place, as ScoreModel
        serves its own (``cast_backbone_for_inference``)."""
        cast_backbone_for_inference(self.net)

    def draw_start(self, length: int, generator: Optional[torch.Generator] = None) -> int:
        """The crop start of a clip of `length` samples, uniform in
        [0, max(length - target_len, 1)) (use_tpu's jax.random.randint),
        from `generator` (on its device)."""
        dev = self.device if generator is None else generator.device
        return int(torch.randint(0, max(length - self.target_len, 1), (), generator=generator,
                                 device=dev))

    def forward_train(self, batch: Batch, generator: Optional[torch.Generator] = None,
                      start: Optional[int] = None) -> Batch:
        """Random crop and enhance (model_wrapper.py:88-113): clean and
        perturbed cropped to target_len at `start` (drawn from `generator`
        where not given), or centre-padded when shorter; the net on their
        spectrogram, with no padding of the frame axis; writes the cropped
        'clean' and 'perturbed' and 'fake' [B, target_len]."""
        x, y = batch["clean"], batch["perturbed"]
        current_len = x.shape[-1]
        if current_len >= self.target_len:
            if start is None:
                start = self.draw_start(current_len, generator)

            def take(w):
                return w[..., start : start + self.target_len]
        else:
            pad = self.target_len - current_len

            def take(w):
                return torch.nn.functional.pad(w, (pad // 2, pad - pad // 2))
        x, y = take(x), take(y)
        fake_spec = self.net(self._spec(y), None)[..., 0, :]  # [B, F, T, 2]
        out = dict(batch)
        out["clean"], out["perturbed"] = x, y
        out["fake"] = self._inv(fake_spec, self.target_len)
        return out

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

    def __call__(self, batch: Batch, generator: Optional[torch.Generator] = None,
                 train: bool = False, start: Optional[int] = None) -> Batch:
        if train and "clean" in batch:
            return self.forward_train(batch, generator, start)
        return self.forward_infer(batch)
