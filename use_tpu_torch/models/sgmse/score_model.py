"""ScoreModel: the SGMSE task head (backbone + SDE + STFT + sampler).

Port of use_tpu/models/sgmse/score_model.py (reference
src/models/components/sgmse/model_wrapper.py:23-329). The backbone is a torch
module held by the model (``score_net``) on ``device``; sampling runs under
``torch.inference_mode``. Batch convention as use_tpu's: a dict with
'perturbed' (and optionally 'fake') wavs [B, L], returning 'enhanced' or
'fake_sde_enhanced'; training adds 'clean'. ``train_loss`` is the
denoising score-matching loss, drawn from an explicit ``torch.Generator``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from use_tpu_torch.models.ncsnpp.ncsnpp import cast_backbone_for_inference
from use_tpu_torch.models.registry import BackboneRegistry, SDERegistry
from use_tpu_torch.models.sgmse import sampling
from use_tpu_torch.models.sgmse.sampling import NoiseAt, NoiseFn
from use_tpu_torch.models.sgmse.sdes import batch_broadcast, crandn
from use_tpu_torch.ops import STFTConfig, istft, pad_spec, spec_back, spec_fwd, stft
from use_tpu_torch.utils.device import resolve_device

Batch = Dict[str, torch.Tensor]
TrainDraws = Tuple[int, torch.Tensor, torch.Tensor]  # (crop start, t [B], z [B, F, T, 2])


@dataclass
class ScoreModel:
    """SGMSE score model (model_wrapper.py:23-143).

    condition: 'noisy' | 'denoised' | 'both' — which spectra condition the
        score network (input channels 4 / 4 / 6).
    sde_input: 'noisy' | 'denoised' — prior mean y of the OU process.
    device: 'cuda' (default) or 'cpu'; CUDA without a card raises.
    seed: seed of the backbone's random initialization.
    """

    backbone: str = "ncsnpp"
    sde: str = "ouve"
    t_eps: float = 3e-2
    condition: str = "both"
    loss_type: str = "mse"
    n_fft: int = 510
    hop_length: int = 128
    num_frames: int = 256
    window: str = "hann"
    spec_factor: float = 0.15
    spec_abs_exponent: float = 0.5
    sde_input: str = "denoised"
    predictor: str = "reverse_diffusion"
    corrector: str = "none"
    backbone_kwargs: Dict[str, Any] = field(default_factory=dict)
    sde_kwargs: Dict[str, Any] = field(default_factory=dict)
    device: Union[str, torch.device] = "cuda"
    seed: int = 0

    def __post_init__(self):
        self.device = resolve_device(self.device)
        input_channels = 6 if self.condition == "both" else 4
        self.score_net = BackboneRegistry.get_by_name(self.backbone)(
            input_channels=input_channels, seed=self.seed, **self.backbone_kwargs
        ).to(self.device)
        self.sde_obj = SDERegistry.get_by_name(self.sde)(**self.sde_kwargs)
        self.stft_cfg = STFTConfig(
            n_fft=self.n_fft, hop_length=self.hop_length, window=self.window
        )

    # -- setup ------------------------------------------------------------
    def cast_params_for_inference(self) -> None:
        """Cast the backbone's weights to its compute dtype, in place
        (``cast_backbone_for_inference``)."""
        cast_backbone_for_inference(self.score_net)

    # -- pieces -----------------------------------------------------------
    def _spec(self, wav: torch.Tensor) -> torch.Tensor:
        """wav [B, L] -> compressed spec [B, F, T, 2]."""
        return spec_fwd(stft(wav, self.stft_cfg), self.spec_factor, self.spec_abs_exponent)

    def _inv_spec(self, spec: torch.Tensor, length: int) -> torch.Tensor:
        return istft(
            spec_back(spec, self.spec_factor, self.spec_abs_exponent), self.stft_cfg,
            length=length,
        )

    def forward_score(self, x: torch.Tensor, t: torch.Tensor,
                      conditioning: List[torch.Tensor]) -> torch.Tensor:
        """score = -net(cat([x] + conditioning), t) (model_wrapper.py:135-141)."""
        dnn_input = torch.cat([x] + list(conditioning), dim=-1)
        out = self.score_net(dnn_input, t)  # [B, F, T, 1, 2]
        return -out[..., 0, :]

    def _select_cond(self, y, y_denoised):
        if self.condition == "noisy":
            return [y]
        if self.condition == "denoised":
            if y_denoised is None:
                raise ValueError("condition='denoised' requires batch['fake']")
            return [y_denoised]
        if self.condition == "both":
            if y_denoised is None:
                raise ValueError("condition='both' requires batch['fake']")
            return [y, y_denoised]
        raise NotImplementedError(f"Unknown conditioning: {self.condition}")

    def _select_sde_input(self, y, y_denoised):
        if self.sde_input == "noisy":
            return y
        if self.sde_input == "denoised":
            if y_denoised is None:
                raise ValueError("sde_input='denoised' requires batch['fake']")
            return y_denoised
        raise NotImplementedError(f"Unknown sde input: {self.sde_input}")

    # -- training ---------------------------------------------------------
    @property
    def target_len(self) -> int:
        """Samples of a training crop: num_frames STFT frames."""
        return (self.num_frames - 1) * self.hop_length

    def draw_train(self, batch_size: int, length: int,
                   generator: Optional[torch.Generator] = None) -> TrainDraws:
        """The loss's random draws, in use_tpu's order (crop, t, z): the crop
        start in [0, max(length - target_len, 1)), t ~ U[t_eps, T) per item,
        z the complex-normal noise of the cropped spectra [B, F, num_frames, 2];
        t and z on the generator's device (the model's without one)."""
        dev = self.device if generator is None else generator.device
        start = int(torch.randint(0, max(length - self.target_len, 1), (), generator=generator,
                                  device=dev))
        t = (torch.rand((batch_size,), generator=generator, device=dev)
             * (self.sde_obj.T - self.t_eps) + self.t_eps)
        z = crandn((batch_size, self.stft_cfg.freqs, self.num_frames, 2), generator, dev)
        return start, t, z

    def train_loss(self, batch: Batch, generator: Optional[torch.Generator] = None,
                   draws: Optional[TrainDraws] = None) -> torch.Tensor:
        """Denoising score-matching loss (model_wrapper.py:147-208;
        use_tpu score_model.py:140-193): a random num_frames crop (or centred
        zero padding) -> STFT -> t ~ U[t_eps, T] -> perturb with the SDE
        marginal -> 0.5 |sigma * score + z|^2 summed per item, mean over the
        batch. ``draws`` = (start, t, z) replaces ``draw_train``'s, so that a
        test can feed use_tpu's; t and z may lie on another device than the
        batch (a CPU generator's draws) and are moved to it."""
        x, y = batch["clean"], batch["perturbed"]
        y_denoised = batch.get("fake")
        current_len = x.shape[-1]
        start, t, z = draws if draws is not None else self.draw_train(
            x.shape[0], current_len, generator)
        t, z = t.to(x.device), z.to(x.device)
        if current_len >= self.target_len:
            def take(w):
                return w[..., start : start + self.target_len]
        else:
            pad = self.target_len - current_len

            def take(w):
                return torch.nn.functional.pad(w, (pad // 2, pad - pad // 2))
        x = self._spec(take(x))
        y = self._spec(take(y))
        if y_denoised is not None:
            y_denoised = self._spec(take(y_denoised))

        sde_input = self._select_sde_input(y, y_denoised)
        mean, std = self.sde_obj.marginal_prob(x, t, sde_input)
        sigmas = batch_broadcast(std, x)
        perturbed = mean + sigmas * z
        score = self.forward_score(perturbed, t, self._select_cond(y, y_denoised))
        err = score * sigmas + z
        if self.loss_type == "mse":
            losses = torch.sum(err * err, dim=-1)  # |err|^2
        elif self.loss_type == "mae":
            losses = torch.sqrt(torch.sum(err * err, dim=-1) + 1e-12)
        else:
            raise NotImplementedError(self.loss_type)
        return torch.mean(0.5 * torch.sum(losses.reshape(losses.shape[0], -1), dim=-1))

    # -- inference --------------------------------------------------------
    def sample_spec(
        self,
        y_spec: torch.Tensor,
        conditioning: List[torch.Tensor],
        generator: Optional[torch.Generator] = None,
        noise_fn: Optional[NoiseFn] = None,
        sampler_type: str = "pc",
        N: int = 50,
        corrector_steps: int = 1,
        snr: float = 0.5,
        noise_at: Optional[NoiseAt] = None,
        **sampler_kwargs,
    ) -> Tuple[torch.Tensor, Dict[str, int]]:
        """Run the reverse process on padded spectra -> (sample, counts):
        counts['nfe'] is the network evaluations, and for parallel_pc
        counts['sweeps'] its sweeps.

        sampler_type 'pc' and 'ode' draw through ``noise_fn``, 'parallel_pc'
        through ``noise_at`` and takes ``window`` and ``tol`` from
        ``sampler_kwargs`` (score_model.py:194-238)."""
        sde = self.sde_obj.copy(N=N)
        if sampler_type == "pc":
            sampler = sampling.get_pc_sampler(
                self.predictor, self.corrector, sde,
                lambda xt, t: self.forward_score(xt, t, conditioning), y_spec,
                eps=self.t_eps, snr=snr, corrector_steps=corrector_steps,
            )
            sample, nfe = sampler(generator, noise_fn)
            return sample, {"nfe": nfe}
        if sampler_type == "parallel_pc":
            # the window multiplies the batch the score network sees; the
            # conditioning tiles window-major, as the sampler's [W, B] -> [W*B]
            base = y_spec.shape[0]

            def score_fn_tiled(xt, t):
                k = xt.shape[0] // base
                cond = [c.repeat((k,) + (1,) * (c.dim() - 1)) if k > 1 else c
                        for c in conditioning]
                return self.forward_score(xt, t, cond)

            sampler = sampling.get_parallel_pc_sampler(
                self.predictor, self.corrector, sde, score_fn_tiled, y_spec,
                eps=self.t_eps, **sampler_kwargs,
            )
            sample, nfe, sweeps = sampler(generator, noise_at)
            return sample, {"nfe": nfe, "sweeps": sweeps}
        if sampler_type == "ode":
            sampler = sampling.get_ode_sampler(
                sde, lambda xt, t: self.forward_score(xt, t, conditioning), y_spec,
                eps=self.t_eps,
            )
            sample, nfe = sampler(generator, noise_fn)
            return sample, {"nfe": nfe}
        raise ValueError(f"{sampler_type} is not a valid sampler type!")

    @torch.inference_mode()
    def sample(
        self,
        batch: Batch,
        generator: Optional[torch.Generator] = None,
        noise_fn: Optional[NoiseFn] = None,
        sampler_type: str = "pc",
        N: int = 50,
        corrector_steps: int = 1,
        snr: float = 0.5,
        **sampler_kwargs,
    ) -> Batch:
        """Batch-dict enhancement (model_wrapper.py:262-329).

        Writes batch['enhanced'] (sde_input='noisy') or
        batch['fake_sde_enhanced'] (sde_input='denoised', GAN-first hybrid),
        and batch['nfe'], the sampler's network evaluations (parallel_pc:
        also batch['sweeps']).
        """
        y = torch.as_tensor(batch["perturbed"], device=self.device)
        y_denoised_wav = batch.get("fake")
        t_orig = y.shape[-1]

        y_spec = pad_spec(self._spec(y))
        y_denoised = (
            pad_spec(self._spec(torch.as_tensor(y_denoised_wav, device=self.device)))
            if y_denoised_wav is not None else None
        )
        conditioning = self._select_cond(y_spec, y_denoised)
        sde_in = self._select_sde_input(y_spec, y_denoised)

        sample, counts = self.sample_spec(
            sde_in, conditioning, generator, noise_fn, sampler_type, N, corrector_steps,
            snr, **sampler_kwargs,
        )
        enhanced = self._inv_spec(sample, t_orig)
        out = dict(batch)
        out["fake_sde_enhanced" if self.sde_input == "denoised" else "enhanced"] = enhanced
        out.update(counts)
        return out

    @torch.inference_mode()
    def sample_chunked(
        self,
        batch: Batch,
        generator: Optional[torch.Generator] = None,
        noise_fn: Optional[NoiseFn] = None,
        n_chunks: int = 8,
        overlap_frames: int = 32,
        **sample_kwargs,
    ) -> Batch:
        """Single-utterance enhancement as ONE batched sampler call over
        overlapped, hop-aligned time chunks, linearly crossfaded
        (score_model.py:281-350). Falls back to full-clip sampling when the
        clip is too short for the chunking."""
        y = torch.as_tensor(batch["perturbed"], device=self.device)
        if y.dim() != 2 or y.shape[0] != 1:
            raise ValueError(
                f"sample_chunked is the single-utterance path (got batch {y.shape[0]})"
            )
        length = y.shape[-1]
        overlap = int(overlap_frames) * self.hop_length
        hop = -(-length // int(n_chunks))  # ceil
        hop = -(-hop // self.hop_length) * self.hop_length  # hop-aligned starts
        n = -(-length // hop)  # actual lanes after alignment
        if n <= 1 or hop <= overlap or overlap <= 0:
            return self.sample(batch, generator, noise_fn, **sample_kwargs)
        win = hop + overlap
        padded = torch.nn.functional.pad(
            y[None], (overlap // 2, (n - 1) * hop + win - overlap // 2 - length), mode="reflect"
        )[0, 0]
        idx = (torch.arange(n, device=y.device)[:, None] * hop
               + torch.arange(win, device=y.device)[None, :])
        chunks = padded[idx]  # [n, win]

        out = self.sample({"perturbed": chunks}, generator, noise_fn, **sample_kwargs)
        key = "fake_sde_enhanced" if self.sde_input == "denoised" else "enhanced"
        enhanced = out[key]  # [n, win]

        ramp = torch.linspace(0.0, 1.0, overlap + 2, device=y.device)[1:-1]
        w = torch.ones((win,), device=y.device)
        w[:overlap] = ramp
        w[-overlap:] = ramp.flip(0)
        total = (n - 1) * hop + win
        acc = torch.zeros((total,), device=y.device)
        wacc = torch.zeros((total,), device=y.device)
        for i in range(n):
            acc[i * hop : i * hop + win] += enhanced[i] * w
            wacc[i * hop : i * hop + win] += w
        joined = acc / torch.clamp(wacc, min=1e-8)
        res = dict(batch)
        res[key] = joined[overlap // 2 : overlap // 2 + length][None]
        res.update({k: out[k] for k in ("nfe", "sweeps") if k in out})
        return res


def sgmse_large(**overrides) -> ScoreModel:
    """The shipping SGMSE_Large config (configs/model/SGMSE_Large.yaml:1-17)."""
    kw: Dict[str, Any] = dict(
        backbone="ncsnpplarge", sde="ouve", t_eps=3e-2, condition="noisy",
        sde_input="noisy", loss_type="mse", n_fft=1022, hop_length=160,
        num_frames=512, spec_factor=0.15, spec_abs_exponent=0.5,
        predictor="reverse_diffusion", corrector="none",
    )
    kw.update(overrides)
    return ScoreModel(**kw)
