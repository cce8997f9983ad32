"""Samplers of the reverse process as Python loops.

Port of use_tpu/models/sgmse/sampling.py (reference sampling/__init__.py,
predictors.py:40-79, correctors.py:37-111):

- ``get_pc_sampler`` (sampling.py:119-170): a Python loop over
  ``linspace(T, eps, N)`` replaces ``lax.scan`` and keeps its (x_mean, gain)
  carry: the next sample is ``x_mean + gain * z`` with z drawn at the start
  of the following step.
- ``get_parallel_pc_sampler`` (sampling.py:177-297): sliding-window Picard
  sweeps, W trajectory points a batched network call. The window advance
  depends on the data, so the host reads it once a sweep (one ``.item()``).
- ``get_ode_sampler`` (sampling.py:305-349): fixed-step RK4 of the
  probability-flow ODE, 4N + 1 network evaluations.
- ``get_ode_sampler_adaptive`` (sampling.py:352-396): scipy's ``solve_ivp``
  on the host, the drift on the model's device.

Noise. The PC and ODE samplers draw through ``noise_fn(shape) -> tensor``;
per PC step: the z that materializes x, then one draw per corrector
iteration; the ODE samplers draw the prior once. The parallel sampler draws
through ``noise_at(p) -> tensor``, the noise of trajectory position p
(0 = the prior), the same whichever sweep computes p. The defaults draw
``crandn`` from a torch.Generator; tests pass sources that replay use_tpu's
JAX draws.

Registries keep the reference's names: predictors 'euler_maruyama' |
'reverse_diffusion' | 'none'; correctors 'langevin' | 'ald' | 'none'.
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
NoiseAt = Callable[[int], torch.Tensor]  # trajectory position -> noise of y's shape



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


# ---------------------------------------------------------------------------
# Parallel (Picard / ParaDiGMS-style) PC sampler
# ---------------------------------------------------------------------------

def get_parallel_pc_sampler(
    predictor_name: str,
    corrector_name: str,
    sde,
    score_fn: ScoreFn,
    y: torch.Tensor,
    denoise: bool = True,
    eps: float = 3e-2,
    window: int = 8,
    tol: float = 0.1,
    **_ignored,
):
    """Sliding-window Picard sampler: (generator=None, noise_at=None) ->
    (sample, nfe, sweeps), nfe = sweeps * W.

    Keeps W = min(window, N) trajectory points live; a sweep evaluates the
    predictor at all of them in one network call of batch W*B (score_fn gets
    x of batch W*B, window-major), then slides the window past the leading
    points whose update fell below ``tol`` times the std of the noise
    injected there (4x tighter at the final, noiseless transition). The
    front point is exact, so each sweep advances at least one position; at
    tol=0 the result is the sequential PC trajectory with the same
    per-position noise. Corrector 'none' only, as use_tpu."""
    if corrector_name != "none":
        raise ValueError(
            "parallel_pc supports corrector='none' only (the shipping SGMSE config); "
            f"got {corrector_name!r}"
        )
    predictor = PredictorRegistry.get_by_name(predictor_name)
    n = sde.N
    b = y.shape[0]
    rest = tuple(y.shape[1:])
    w = int(min(window, n))
    red = tuple(range(1, y.dim() + 1))  # per-slot mean over [B, *rest]
    ts = torch.linspace(sde.T, eps, n, dtype=torch.float32)
    ts_pad = torch.cat([ts, torch.full((w,), eps, dtype=torch.float32)]).to(y.device, y.dtype)
    y_tiled = y.repeat((w,) + (1,) * (y.dim() - 1))  # [W*B, *rest]

    def sampler(generator: Optional[torch.Generator] = None,
                noise_at: Optional[NoiseAt] = None) -> Tuple[torch.Tensor, int, int]:
        if noise_at is None:
            # one draw per position, in position order, so that a position's
            # noise does not depend on the sweep that first asks for it
            z_all = crandn((n + w + 1,) + tuple(y.shape), generator, y.device, y.dtype)

            def noise_at(p):
                return z_all[p]

        std_t = sde._std(torch.full((b,), sde.T, dtype=y.dtype, device=y.device))
        x0 = y + batch_broadcast(std_t, y) * noise_at(0)
        xs_all = x0.expand((n + w + 1,) + tuple(y.shape)).clone()  # [N+W+1, B, *rest]
        c = sweeps = 0
        while c < n:
            positions = list(range(c + 1, c + 1 + w))
            ts_flat = ts_pad[c:c + w].repeat_interleave(b)
            m_flat, g_flat = predictor(sde, score_fn, xs_all[c:c + w].reshape((w * b,) + rest),
                                       ts_flat, y_tiled)
            m = m_flat.reshape((w, b) + rest)
            g = torch.broadcast_to(g_flat, m_flat.shape).reshape((w, b) + rest)
            zs = torch.stack([noise_at(p) for p in positions])
            if denoise and n in positions:  # the final transition keeps the mean
                zs[positions.index(n)] = 0.0
            x_new = m + g * zs

            err = torch.mean((x_new - xs_all[c + 1:c + 1 + w]).abs() ** 2, dim=red)  # [W]
            # crandn's components are N(0, 1/2): injected variance g^2/2 a component
            thresh = tol * tol * 0.5 * torch.mean(g.abs() ** 2, dim=red)
            pos = torch.arange(c + 1, c + 1 + w, device=y.device)
            thresh = torch.where(pos == n, thresh / 16.0, thresh)
            ok = (err <= thresh) | (pos > n)  # padding slots past the horizon
            ok[0] = True  # the window front is exact by induction
            adv = int(torch.cumprod(ok.int(), 0).sum())  # the sweep's one host sync
            xs_all[c + 1:c + 1 + w] = x_new
            c = min(c + adv, n)
            sweeps += 1
        return xs_all[n], sweeps * w, sweeps

    return sampler


# ---------------------------------------------------------------------------
# Probability-flow ODE samplers
# ---------------------------------------------------------------------------

def _prior_sample(sde, y, generator, noise_fn):
    z = noise_fn(y.shape) if noise_fn is not None else crandn(y.shape, generator, y.device,
                                                               y.dtype)
    return sde.prior_sampling(y, z)


def _denoise_step(sde, score_fn, x, y, eps):
    """One noiseless reverse-diffusion step at t = eps."""
    _, rsde_discretize = reverse_sde(sde, score_fn)
    f, _ = rsde_discretize(x, torch.full((y.shape[0],), eps, dtype=y.dtype, device=y.device), y)
    return x - f


def get_ode_sampler(
    sde,
    score_fn: ScoreFn,
    y: torch.Tensor,
    denoise: bool = True,
    eps: float = 3e-2,
    **_ignored,
):
    """Fixed-step RK4 probability-flow ODE sampler, N steps from T toward
    eps, then (denoise) one noiseless reverse-diffusion step:
    (generator=None, noise_fn=None) -> (sample, nfe = 4N + 1)."""
    rsde_sde, _ = reverse_sde(sde, score_fn, probability_flow=True)

    def drift(x, t):
        return rsde_sde(x, torch.full((y.shape[0],), t, dtype=y.dtype, device=y.device), y)[0]

    dt = (eps - sde.T) / sde.N  # negative
    # jnp.linspace(T, eps - dt, N, endpoint=False), as use_tpu steps it
    timesteps = np.linspace(sde.T, eps - dt, sde.N, endpoint=False, dtype=np.float32)

    def sampler(generator: Optional[torch.Generator] = None,
                noise_fn: Optional[NoiseFn] = None) -> Tuple[torch.Tensor, int]:
        x = _prior_sample(sde, y, generator, noise_fn)
        for t in timesteps.tolist():
            k1 = drift(x, t)
            k2 = drift(x + 0.5 * dt * k1, t + 0.5 * dt)
            k3 = drift(x + 0.5 * dt * k2, t + 0.5 * dt)
            k4 = drift(x + dt * k3, t + dt)
            x = x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        if denoise:
            x = _denoise_step(sde, score_fn, x, y, eps)
        return x, 4 * sde.N + (1 if denoise else 0)

    return sampler


def get_ode_sampler_adaptive(
    sde,
    score_fn: ScoreFn,
    y: torch.Tensor,
    denoise: bool = True,
    rtol: float = 1e-5,
    atol: float = 1e-5,
    method: str = "RK45",
    eps: float = 3e-2,
    **_ignored,
):
    """Adaptive probability-flow ODE sampler: scipy's ``solve_ivp`` on the
    host in float64, the drift on y's device in float32, then (denoise) one
    noiseless reverse-diffusion step: (generator=None, noise_fn=None) ->
    (sample, nfe = solve_ivp's evaluations (+1))."""
    from scipy import integrate

    rsde_sde, _ = reverse_sde(sde, score_fn, probability_flow=True)

    def sampler(generator: Optional[torch.Generator] = None,
                noise_fn: Optional[NoiseFn] = None) -> Tuple[torch.Tensor, int]:
        x = _prior_sample(sde, y, generator, noise_fn)
        shape = x.shape

        def ode_func(t, flat):
            xt = torch.from_numpy(flat.reshape(shape)).to(y.device, torch.float32)
            vec_t = torch.full((y.shape[0],), float(t), dtype=y.dtype, device=y.device)
            return rsde_sde(xt, vec_t, y)[0].cpu().numpy().astype(np.float64).reshape(-1)

        solution = integrate.solve_ivp(
            ode_func, (sde.T, eps), x.cpu().numpy().astype(np.float64).reshape(-1),
            rtol=rtol, atol=atol, method=method,
        )
        xs = torch.from_numpy(solution.y[:, -1].reshape(shape)).to(y.device, torch.float32)
        nfe = int(solution.nfev)
        if denoise:
            xs = _denoise_step(sde, score_fn, xs, y, eps)
            nfe += 1
        return xs, nfe

    return sampler
