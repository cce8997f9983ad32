"""SDE library for score-based speech enhancement, in torch.

Port of use_tpu/models/sgmse/sdes.py (reference src/models/components/sgmse/
sdes.py:182-366): closed-form marginals, reverse SDE parts and Euler
discretization as functions of ``[B, F, T, C]`` real-pair spectrograms with
per-batch time vectors ``[B]``.

Complex-noise convention: torch.randn_like on a complex tensor draws real
and imaginary parts i.i.d. N(0, 1/2); ``crandn`` draws that on the trailing
real-pair layout.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from use_tpu_torch.models.registry import SDERegistry


def batch_broadcast(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Reshape per-batch scalar [B] to broadcast against x [B, ...]."""
    if a.dim() >= x.dim():
        return a
    return a.reshape(tuple(a.shape) + (1,) * (x.dim() - a.dim()))


def crandn(shape: Sequence[int], generator: Optional[torch.Generator] = None,
           device=None, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Complex-style Gaussian on real-pair layout: each component N(0, 1/2)."""
    z = torch.randn(tuple(shape), generator=generator, device=device, dtype=dtype)
    return z * np.float32(1.0 / np.sqrt(2.0))


@SDERegistry.register("ouve")
@dataclass(frozen=True)
class OUVESDE:
    """Ornstein-Uhlenbeck Variance-Exploding SDE (sdes.py:182-254).

    dx = theta (y - x) dt + sigma_min (sigma_max/sigma_min)^t
         sqrt(2 log(sigma_max/sigma_min)) dw
    """

    theta: float = 1.5
    sigma_min: float = 0.05
    sigma_max: float = 0.5
    N: int = 1000

    @property
    def T(self) -> float:
        return 1.0

    @property
    def logsig(self) -> float:
        return float(np.log(self.sigma_max / self.sigma_min))

    def copy(self, **kw) -> "OUVESDE":
        return replace(self, **kw)

    def sde(self, x, t, y):
        drift = self.theta * (y - x)
        sigma = self.sigma_min * (self.sigma_max / self.sigma_min) ** t
        diffusion = sigma * np.sqrt(2 * self.logsig)  # [B]
        return drift, diffusion

    def _mean(self, x0, t, y):
        exp_interp = batch_broadcast(torch.exp(-self.theta * t), x0)
        return exp_interp * x0 + (1 - exp_interp) * y

    def _std(self, t):
        smin, theta, logsig = self.sigma_min, self.theta, self.logsig
        return torch.sqrt(
            (smin ** 2 * torch.exp(-2 * theta * t)
             * (torch.exp(2 * (theta + logsig) * t) - 1) * logsig)
            / (theta + logsig)
        )

    def marginal_prob(self, x0, t, y):
        return self._mean(x0, t, y), self._std(t)

    def prior_sampling(self, y, z):
        """y + std(T) z, for z a ``crandn`` draw of y's shape (sdes.py:82-84)."""
        return _prior(self, y, z)


@SDERegistry.register("ouvp")
@dataclass(frozen=True)
class OUVPSDE:
    """Ornstein-Uhlenbeck Variance-Preserving SDE (sdes.py:282-366).

    dx = -1/2 beta(t) stiffness (y - x) dt + sqrt(beta(t)) dw,
    beta(t) = beta_min + t (beta_max - beta_min)
    """

    beta_min: float = 0.01
    beta_max: float = 1.0
    stiffness: float = 1.0
    N: int = 1000

    @property
    def T(self) -> float:
        return 1.0

    def copy(self, **kw) -> "OUVPSDE":
        return replace(self, **kw)

    def _beta(self, t):
        return self.beta_min + t * (self.beta_max - self.beta_min)

    def sde(self, x, t, y):
        drift = 0.5 * self.stiffness * batch_broadcast(self._beta(t), y) * (y - x)
        diffusion = torch.sqrt(self._beta(t))
        return drift, diffusion

    def _mean(self, x0, t, y):
        b0, b1, s = self.beta_min, self.beta_max, self.stiffness
        fac = batch_broadcast(torch.exp(-0.25 * s * t * (t * (b1 - b0) + 2 * b0)), x0)
        return y + fac * (x0 - y)

    def _std(self, t):
        b0, b1, s = self.beta_min, self.beta_max, self.stiffness
        return (1 - torch.exp(-0.5 * s * t * (t * (b1 - b0) + 2 * b0))) / s

    def marginal_prob(self, x0, t, y):
        return self._mean(x0, t, y), self._std(t)

    def prior_sampling(self, y, z):
        """y + std(T) z, for z a ``crandn`` draw of y's shape (sdes.py:128-130)."""
        return _prior(self, y, z)


def _prior(sde, y, z):
    std = sde._std(torch.ones((y.shape[0],), dtype=y.dtype, device=y.device))
    return y + z * batch_broadcast(std, y)


ScoreFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def reverse_sde(sde, score_fn: ScoreFn, probability_flow: bool = False):
    """Reverse-time drift/diffusion and its Euler discretization
    (SDE.reverse, sdes.py:94-175); score_fn closes over the network and the
    conditioning."""

    def rsde_sde(x, t, y):
        drift, diffusion = sde.sde(x, t, y)
        score = score_fn(x, t)
        diff_b = batch_broadcast(diffusion, x)
        score_drift = -(diff_b ** 2) * score * (0.5 if probability_flow else 1.0)
        out_diffusion = torch.zeros_like(diff_b) if probability_flow else diff_b
        return drift + score_drift, out_diffusion

    def rsde_discretize(x, t, y):
        dt = 1.0 / sde.N
        drift, diffusion = sde.sde(x, t, y)
        f = drift * dt
        g = batch_broadcast(diffusion * np.sqrt(dt), x)
        rev_f = f - g ** 2 * score_fn(x, t) * (0.5 if probability_flow else 1.0)
        rev_g = torch.zeros_like(g) if probability_flow else g
        return rev_f, rev_g

    return rsde_sde, rsde_discretize
