"""Optimizer and schedule of the training recipes.

Port of use_tpu/engine/optim.py (reference configs/experiment/
SGMSE_Large.yaml:17-28): torch.optim.Adam with coupled L2 (the decay added
to the gradient before the moments, as optax's ``add_decayed_weights``
ahead of ``scale_by_adam``) after a global-norm gradient clip, and a
per-epoch StepLR. Frozen parameters (requires_grad False: the
Gaussian-Fourier projection W) are outside the optimizer, so they are
neither updated, decayed nor counted in the clip's norm, as use_tpu's
``optax.masked`` leaves them out.
"""
from __future__ import annotations

from typing import Callable, Iterable, List

import torch


def trainable(module: torch.nn.Module) -> List[torch.nn.Parameter]:
    return [p for p in module.parameters() if p.requires_grad]


def adam(params: Iterable[torch.nn.Parameter], lr: float = 5e-4, weight_decay: float = 1e-7,
         b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> torch.optim.Adam:
    """torch-style Adam with coupled L2 over `params` (pass ``trainable(net)``)."""
    return torch.optim.Adam(list(params), lr=lr, betas=(b1, b2), eps=eps,
                            weight_decay=weight_decay)


def step_lr(base_lr: float, step_size: int = 30, gamma: float = 0.5) -> Callable[[int], float]:
    """torch StepLR as a function of the epoch (stepped per epoch in the reference)."""

    def schedule(epoch: int) -> float:
        return base_lr * gamma ** (epoch // step_size)

    return schedule


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
