"""Fused bias + LeakyReLU (+ gain) activation.

Port of use_tpu/ops/fused_act.py (the reference's second custom CUDA op,
op/fused_act.py:114-124): ``scale * leaky_relu(x + bias, slope)``. use_tpu
leaves it to XLA to fuse into its producer, and it is no Pallas kernel, so
here it is torch ops.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def fused_leaky_relu(
    x: torch.Tensor, bias: Optional[torch.Tensor] = None, negative_slope: float = 0.2,
    scale: float = math.sqrt(2.0),
) -> torch.Tensor:
    """scale * leaky_relu(x + bias). The bias broadcasts over the last axis,
    as use_tpu's does (its channel axis)."""
    if bias is not None:
        x = x + bias.reshape((1,) * (x.dim() - 1) + (-1,))
    return torch.where(x >= 0, x, negative_slope * x) * scale
