"""Predictor-Corrector sampler as a Python loop over the reverse process.

Port of use_tpu/models/sgmse/sampling.py::get_pc_sampler (sampling.py:119-170;
reference sampling/__init__.py:59-73, predictors.py:40-79,
correctors.py:37-111). A Python loop over ``linspace(T, eps, N)`` replaces
``lax.scan`` and keeps its (x_mean, gain) carry: the next sample is
``x_mean + gain * z`` with z drawn at the start of the following step.

Noise: every draw goes through ``noise_fn(shape) -> tensor`` in this order,
per step: the z that materializes x, then one draw per corrector iteration.
The default draws ``crandn`` from a torch.Generator; tests pass a
``noise_fn`` that replays use_tpu's JAX draws.

Registries keep the reference's names: predictors 'euler_maruyama' |
'reverse_diffusion' | 'none'; correctors 'langevin' | 'ald' | 'none'.
The ODE and parallel samplers are not ported yet.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from use_tpu_torch.models.registry import CorrectorRegistry, PredictorRegistry
from use_tpu_torch.models.sgmse.sdes import batch_broadcast, crandn, reverse_sde

# score_fn(x, t) -> score; x [B, F, T, C], t [B]
ScoreFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
NoiseFn = Callable[[Sequence[int]], torch.Tensor]


# ---------------------------------------------------------------------------
# Predictors (one reverse step; return (x_mean, gain) with
# x_next = x_mean + gain * z)
# ---------------------------------------------------------------------------

@PredictorRegistry.register("euler_maruyama")
def euler_maruyama_predictor(sde, score_fn: ScoreFn, x, t, y):
    rsde_sde, _ = reverse_sde(sde, score_fn)
    dt = -1.0 / sde.N
    f, g = rsde_sde(x, t, y)
    return x + f * dt, batch_broadcast(g, x) * np.sqrt(-dt)


@PredictorRegistry.register("reverse_diffusion")
def reverse_diffusion_predictor(sde, score_fn: ScoreFn, x, t, y):
    _, rsde_discretize = reverse_sde(sde, score_fn)
    f, g = rsde_discretize(x, t, y)
    return x - f, g


@PredictorRegistry.register("none")
def none_predictor(sde, score_fn: ScoreFn, x, t, y):
    return x, torch.zeros((), dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# Correctors (n_steps inner iterations; return (x, x_mean))
# ---------------------------------------------------------------------------

@CorrectorRegistry.register("langevin")
def langevin_corrector(sde, score_fn: ScoreFn, x, t, y, noise_fn: NoiseFn, snr: float,
                       n_steps: int):
    x_mean = x
    for _ in range(n_steps):
        grad = score_fn(x, t)
        noise = noise_fn(x.shape)
        grad_norm = torch.linalg.norm(grad.reshape(grad.shape[0], -1), dim=-1).mean()
        noise_norm = torch.linalg.norm(noise.reshape(noise.shape[0], -1), dim=-1).mean()
        step_size = (snr * noise_norm / grad_norm) ** 2 * 2
        x_mean = x + step_size * grad
        x = x_mean + noise * torch.sqrt(step_size * 2)
    return x, x_mean


@CorrectorRegistry.register("ald")
def annealed_langevin_corrector(sde, score_fn: ScoreFn, x, t, y, noise_fn: NoiseFn,
                                snr: float, n_steps: int):
    std = sde.marginal_prob(x, t, y)[1]
    x_mean = x
    for _ in range(n_steps):
        grad = score_fn(x, t)
        noise = noise_fn(x.shape)
        step_size = batch_broadcast((snr * std) ** 2 * 2, x)
        x_mean = x + step_size * grad
        x = x_mean + noise * torch.sqrt(step_size * 2)
    return x, x_mean


@CorrectorRegistry.register("none")
def none_corrector(sde, score_fn: ScoreFn, x, t, y, noise_fn: NoiseFn, snr: float,
                   n_steps: int):
    return x, x


# ---------------------------------------------------------------------------
# PC sampler
# ---------------------------------------------------------------------------

def get_pc_sampler(
    predictor_name: str,
    corrector_name: str,
    sde,
    score_fn: ScoreFn,
    y: torch.Tensor,
    denoise: bool = True,
    eps: float = 3e-2,
    snr: float = 0.1,
    corrector_steps: int = 1,
    **_ignored,
):
    """PC sampler: (generator=None, noise_fn=None) -> (sample, nfe).

    Reference parity: sampling/__init__.py:23-73 — N steps over
    linspace(T, eps, N), corrector then predictor, final denoised mean.
    """
    predictor = PredictorRegistry.get_by_name(predictor_name)
    corrector = CorrectorRegistry.get_by_name(corrector_name)
    n_corr = 0 if corrector_name == "none" else corrector_steps

    def sampler(generator: Optional[torch.Generator] = None,
                noise_fn: Optional[NoiseFn] = None) -> Tuple[torch.Tensor, int]:
        if noise_fn is None:
            def noise_fn(shape):
                return crandn(shape, generator, y.device, y.dtype)

        timesteps = torch.linspace(sde.T, eps, sde.N, dtype=torch.float32)
        std_t = sde._std(torch.full((y.shape[0],), sde.T, dtype=y.dtype, device=y.device))
        x_mean, gain = y, batch_broadcast(std_t, y)
        for t in timesteps.tolist():
            xt = x_mean + gain * noise_fn(x_mean.shape)
            vec_t = torch.full((y.shape[0],), t, dtype=y.dtype, device=y.device)
            xt, _ = corrector(sde, score_fn, xt, vec_t, y, noise_fn, snr, n_corr)
            x_mean, gain = predictor(sde, score_fn, xt, vec_t, y)
        x_result = x_mean if denoise else x_mean + gain * noise_fn(x_mean.shape)
        return x_result, sde.N * (n_corr + 1)

    return sampler
