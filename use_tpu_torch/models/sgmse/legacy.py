"""Legacy sp-uhh model family (the reference's programmatic API).

Port of use_tpu/models/sgmse/legacy.py (reference
src/models/components/sgmse/model.py:25-1010):

- LegacyScoreModel: the score model with an EMA of its weights (torch_ema
  semantics, model.py:63,106-139) and ``enhance()`` with RTF timing
  (model.py:357-402).
- DiscriminativeModel: the NCSN++ generator run deterministically, trained
  on the waveform error (model.py:405-461).
- StochasticRegenerationModel: a denoiser and a score model composed; the
  denoiser's output conditions the reverse SDE and is its prior mean
  (condition='both', sde_input='denoised'), N=30 by default
  (model.py:464-1010).

The NCSN++ inside each runs the port's kernels on the card (K1's GroupNorm
statistics and apply, K2's shortcut); nothing here normalizes on its own.
There is no CLI verb for these, as in use_tpu: they are a Python API.
Entry points run on ``device`` ('cuda' by default; 'cpu' as the tests
ask), with draws from an explicit ``torch.Generator`` where use_tpu takes
an rng.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple, Union

import torch

from use_tpu_torch.models.gan.generator import NCSNPPWrapper
from use_tpu_torch.models.sgmse.sampling import NoiseFn
from use_tpu_torch.models.sgmse.score_model import Batch, ScoreModel, TrainDraws

State = Dict[str, torch.Tensor]
RTF_SAMPLE_RATE = 24000  # use_tpu's enhance() reads the clip's seconds at this rate


@dataclass
class EMA:
    """Exponential moving average of a state_dict (torch_ema semantics:
    ema = decay * ema + (1 - decay) * param, after each optimizer step)."""

    decay: float = 0.999

    def init(self, state: State) -> State:
        return {k: v.detach().clone() for k, v in state.items()}

    def update(self, ema: State, state: State) -> State:
        d = self.decay
        return {k: d * e + (1 - d) * state[k].detach() for k, e in ema.items()}


@dataclass
class LegacyScoreModel(ScoreModel):
    """ScoreModel + EMA bookkeeping + enhance(timeit) (model.py:25-402)."""

    ema_decay: float = 0.999

    def __post_init__(self):
        super().__post_init__()
        self.ema = EMA(self.ema_decay)

    def enhance(self, y: torch.Tensor, generator: Optional[torch.Generator] = None,
                sampler_type: str = "pc", N: int = 30, corrector_steps: int = 1,
                snr: float = 0.5, timeit: bool = False, noise_fn: Optional[NoiseFn] = None):
        """Enhance one utterance [L] (or a batch [B, L]); with `timeit`
        -> (x_hat, nfe, rtf), the clock read after the card has finished
        (model.py:357-402)."""
        start = time.time()
        y = torch.as_tensor(y, device=self.device)
        batch = {"perturbed": y if y.dim() == 2 else y[None]}
        out = self.sample(batch, generator, noise_fn, sampler_type=sampler_type, N=N,
                          corrector_steps=corrector_steps, snr=snr)
        x_hat = out["enhanced"]
        if y.dim() == 1:
            x_hat = x_hat[0]
        if timeit and x_hat.is_cuda:
            torch.cuda.synchronize(x_hat.device)
        nfe = N * (corrector_steps + 1) if self.corrector != "none" else N
        if timeit:
            rtf = (time.time() - start) / (y.shape[-1] / RTF_SAMPLE_RATE)
            return x_hat, nfe, rtf
        return x_hat


@dataclass
class DiscriminativeModel:
    """Deterministic enhancement by the NCSN++ generator, trained on the
    waveform error: mean over the batch of 0.5 x the sum over samples of
    (fake - clean)^2 (model.py:405-461)."""

    backbone: str = "ncsnpp"
    n_fft: int = 510
    hop_length: int = 128
    num_frames: int = 256
    spec_factor: float = 0.15
    spec_abs_exponent: float = 0.5
    backbone_kwargs: Dict[str, Any] = field(default_factory=dict)
    device: Union[str, torch.device] = "cuda"
    seed: int = 0

    def __post_init__(self):
        self.wrapper = NCSNPPWrapper(
            n_fft=self.n_fft, hop_length=self.hop_length, num_frames=self.num_frames,
            spec_factor=self.spec_factor, spec_abs_exponent=self.spec_abs_exponent,
            backbone=self.backbone, backbone_kwargs=self.backbone_kwargs, device=self.device,
            seed=self.seed,
        )
        self.device = self.wrapper.device

    def train_loss(self, batch: Batch, generator: Optional[torch.Generator] = None,
                   start: Optional[int] = None) -> torch.Tensor:
        """The loss on a random crop (`start`, else drawn from `generator`)."""
        out = self.wrapper.forward_train(batch, generator, start)
        err = out["fake"] - out["clean"]
        return torch.mean(0.5 * torch.sum(err * err, dim=-1))

    def enhance(self, y: torch.Tensor) -> torch.Tensor:
        return self.wrapper.forward_infer({"perturbed": y})["fake"]


@dataclass
class StochasticRegenerationModel:
    """Denoiser -> score model (model.py:464-1010). The denoiser's output
    becomes batch['fake'], which the score model takes as conditioning
    (condition='both') and as the reverse SDE's prior mean
    (sde_input='denoised'): the reference's regeneration mode. Without
    them, the denoiser is NCSNPPWrapper() and the score model
    ScoreModel(condition='both', sde_input='denoised'), seeded from `seed`
    and `seed` + 1."""

    denoiser: Any = None  # NCSNPPWrapper-like: forward_train, forward_infer -> batch['fake']
    score: Optional[ScoreModel] = None
    device: Union[str, torch.device] = "cuda"
    seed: int = 0

    def __post_init__(self):
        if self.denoiser is None:
            self.denoiser = NCSNPPWrapper(device=self.device, seed=self.seed)
        if self.score is None:
            self.score = ScoreModel(condition="both", sde_input="denoised", device=self.device,
                                    seed=self.seed + 1)

    def train_loss(self, batch: Batch, generator: Optional[torch.Generator] = None,
                   start: Optional[int] = None, draws: Optional[TrainDraws] = None
                   ) -> torch.Tensor:
        """Joint training: the score loss conditioned on the denoiser's
        output (model.py's regeneration joint training). The denoiser's
        crop (`start`), then the score loss's draws (`draws`: crop, t, z),
        each drawn from `generator` where not given."""
        batch = self.denoiser.forward_train(batch, generator, start)
        return self.score.train_loss(batch, generator, draws)

    def enhance(self, y: torch.Tensor, generator: Optional[torch.Generator] = None,
                N: int = 30, noise_fn: Optional[NoiseFn] = None, **kw) -> torch.Tensor:
        """Two-stage enhancement (model.py:939, N=30 by default): [B, L] ->
        the score stage's 'fake_sde_enhanced' [B, L]."""
        batch = self.denoiser.forward_infer({"perturbed": y})
        return self.score.sample(batch, generator, noise_fn, N=N, **kw)["fake_sde_enhanced"]
