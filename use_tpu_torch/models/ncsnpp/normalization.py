"""Normalization zoo (legacy NCSNv1/v2 conditioning layers), NCHW.

Port of use_tpu/models/ncsnpp/normalization.py (reference
src/models/components/sgmse/backbones/ncsnpp_utils/normalization.py:21-234):
class-conditional instance norms and variance norms of the legacy NCSN
paths, a batch-statistics norm and Flax's GroupNorm. The shipping NCSN++
normalizes with GroupNormAct (K1); nothing here routes to a kernel.

A norm is built with its channel count, ``cls(channels, ...)``; the
conditional ones take class labels ``y`` [B] beside x. Parameters carry
use_tpu's leaf names where torch has none (``alpha``, ``gamma``, ``beta``)
and torch's where it has (``weight`` for Flax's ``scale``, an embedding's
``Embed_0.weight``), so engine/convert_jax.py::flax_params_to_state_dict
maps use_tpu's params by their paths. ``reset_parameters(module,
generator)`` redraws every norm's parameters as use_tpu initializes them.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn


def _draw_near_one(p: torch.Tensor, generator: Optional[torch.Generator]) -> None:
    """1 + 0.02 N(0, 1), in place."""
    with torch.no_grad():
        p.normal_(0.0, 1.0, generator=generator).mul_(0.02).add_(1.0)


def _spatial_stats(x: torch.Tensor):
    """Per-(b, c) biased variance and mean over H, W."""
    return torch.var_mean(x, dim=(2, 3), keepdim=True, unbiased=False)


def _per_channel(p: torch.Tensor) -> torch.Tensor:
    return p.reshape(1, -1, 1, 1)


def _means_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """The channels' means, standardized across the channels: [B, C, 1, 1]."""
    means = x.mean(dim=(2, 3))
    v, m = torch.var_mean(means, dim=-1, keepdim=True, unbiased=False)
    return ((means - m) * torch.rsqrt(v + eps))[:, :, None, None]


def flax_group_norm(x: torch.Tensor, groups: int, weight: torch.Tensor, bias: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """Flax's GroupNorm over [B, C, ...]: per (sample, group) statistics over
    the group's channels and every other axis, in fp32, the variance as
    max(E[x^2] - E[x]^2, 0) (Flax's fast variance), then
    (x - mean) rsqrt(var + eps) scale + bias."""
    b, c = x.shape[:2]
    g = x.float().reshape(b, groups, -1)
    mean = g.mean(-1, keepdim=True)
    var = torch.clamp((g * g).mean(-1, keepdim=True) - mean * mean, min=0.0)
    shape = (b, groups) + (1,) * (x.dim() - 1)
    mean, var = mean.reshape(shape), var.reshape(shape)
    xs = x.float().reshape((b, groups, c // groups) + tuple(x.shape[2:]))
    mul = torch.rsqrt(var + eps) * weight.reshape((1, groups, c // groups) + (1,) * (x.dim() - 2))
    y = (xs - mean) * mul + bias.reshape((1, groups, c // groups) + (1,) * (x.dim() - 2))
    return y.reshape(x.shape)


class FlaxGroupNorm(nn.Module):
    """Flax's ``nn.GroupNorm`` (``flax_group_norm``); weight = Flax's scale."""

    def __init__(self, num_groups: int, channels: int, eps: float):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return flax_group_norm(x, self.num_groups, self.weight, self.bias, self.eps)


class InstanceNorm2d(nn.Module):
    """Statistics over (H, W) per sample and channel, affine."""

    dims = (2, 3)

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var, mean = torch.var_mean(x, dim=self.dims, keepdim=True, unbiased=False)
        return (x - mean) * torch.rsqrt(var + self.eps) * _per_channel(self.weight) \
            + _per_channel(self.bias)


class BatchNorm2d(InstanceNorm2d):
    """Batch-statistics norm over (B, H, W): no running statistics, batch
    mode only."""

    dims = (0, 2, 3)


class GroupNorm(nn.Module):
    """Flax's GroupNorm (eps 1e-6) under use_tpu's scope ``GroupNorm_0``."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-6):
        super().__init__()
        self.GroupNorm_0 = FlaxGroupNorm(num_groups, channels, eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.GroupNorm_0(x)


class VarianceNorm2d(nn.Module):
    """Scale by the inverse std only, no centering."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.alpha = nn.Parameter(torch.empty(channels))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _draw_near_one(self.alpha, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
        return x * torch.rsqrt(var + self.eps) * _per_channel(self.alpha)


class Embed(nn.Embedding):
    """Flax's nn.Embed with the conditional norms' initializations: the
    first `near_one` columns 1 + 0.02 N(0, 1), the rest zeros."""

    def __init__(self, num_classes: int, features: int, near_one: int):
        self.near_one = near_one
        super().__init__(num_classes, features)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.weight.zero_()
            _draw_near_one(self.weight[:, : self.near_one], generator)


class ConditionalVarianceNorm2d(nn.Module):
    def __init__(self, channels: int, num_classes: int = 10, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.Embed_0 = Embed(num_classes, channels, channels)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        alpha = self.Embed_0(y)[:, :, None, None]
        var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
        return x * torch.rsqrt(var + self.eps) * alpha


class InstanceNorm2dPlus(nn.Module):
    """InstanceNorm++ (normalization.py:102-135): instance norm plus a
    mean-of-means correction that keeps the channels' relative levels."""

    def __init__(self, channels: int, bias: bool = True, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.alpha = nn.Parameter(torch.empty(channels))
        self.gamma = nn.Parameter(torch.empty(channels))
        self.beta = nn.Parameter(torch.zeros(channels)) if bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _draw_near_one(self.alpha, generator)
        _draw_near_one(self.gamma, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        means_norm = _means_norm(x, self.eps)
        var, mean = _spatial_stats(x)
        h = (x - mean) * torch.rsqrt(var + self.eps)
        out = _per_channel(self.gamma) * (h + means_norm * _per_channel(self.alpha))
        return out if self.beta is None else out + _per_channel(self.beta)


class ConditionalInstanceNorm2dPlus(nn.Module):
    """(normalization.py:138-178): gamma, alpha (and beta) per class from
    one embedding, [gamma | alpha | beta]."""

    def __init__(self, channels: int, num_classes: int = 10, bias: bool = True,
                 eps: float = 1e-5):
        super().__init__()
        self.eps, self.bias, self.channels = eps, bias, channels
        self.Embed_0 = Embed(num_classes, (3 if bias else 2) * channels, 2 * channels)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        c = self.channels
        emb = self.Embed_0(y)[:, :, None, None]
        gamma, alpha = emb[:, :c], emb[:, c : 2 * c]
        means_norm = _means_norm(x, self.eps)
        var, mean = _spatial_stats(x)
        h = (x - mean) * torch.rsqrt(var + self.eps)
        out = gamma * (h + means_norm * alpha)
        return out + emb[:, 2 * c :] if self.bias else out


_TABLE = {
    ("instancenorm++", False): InstanceNorm2dPlus,
    ("instancenorm++", True): ConditionalInstanceNorm2dPlus,
    ("instancenorm", False): InstanceNorm2d,
    ("variancenorm", False): VarianceNorm2d,
    ("variancenorm", True): ConditionalVarianceNorm2d,
    ("batchnorm", False): BatchNorm2d,
    ("groupnorm", False): GroupNorm,
}


def get_normalization(name: str, conditional: bool = False):
    """The norm class of `name` (normalization.py:21-44)."""
    key = (name.lower(), conditional)
    if key not in _TABLE:
        raise NotImplementedError(f"normalization {name} conditional={conditional}")
    return _TABLE[key]


def reset_parameters(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Redraw the random parameters of every norm (and embedding) under
    `module` from `generator`, in registration order (the others are ones
    and zeros from the start)."""
    for m in module.modules():
        if isinstance(m, (VarianceNorm2d, Embed, InstanceNorm2dPlus)):
            m.reset_parameters(generator)
