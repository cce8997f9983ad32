"""The SGMSE training loop on one device: the Lightning-Trainer replacement.

Port of use_tpu/engine/loop.py::fit_sgmse (loop.py:140-271): epochs of
optimizer steps over a datamodule's train loader, each step a group of up
to ``accumulate_grad_batches`` successive loader batches (the epoch's
trailing partial group makes one step over fewer), the per-epoch StepLR,
validation, a checkpoint per epoch monitored on val/loss_Score, resume,
and a non-finite loss stopping the run (``NonFiniteLossError``). One
``torch.Generator`` on the model's device, seeded from ``seed``, draws every
crop, t and z of training and validation in order.
"""
from __future__ import annotations

import logging
import math
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from use_tpu_torch.engine import optim
from use_tpu_torch.engine.checkpoint import CheckpointManager
from use_tpu_torch.engine.state import TrainState
from use_tpu_torch.engine.train import sgmse_eval_step, sgmse_train_step
from use_tpu_torch.utils.logging import MetricLogger

log = logging.getLogger("use_tpu_torch")


class NonFiniteLossError(RuntimeError):
    """A monitored loss became NaN or inf (the EarlyStopping check_finite analog)."""


def _check_finite(name: str, value: float) -> None:
    if not math.isfinite(value):
        raise NonFiniteLossError(f"{name} became non-finite: {value}")


def float_batch(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """The float array leaves of a loader batch, as tensors on `device`."""
    return {k: torch.as_tensor(np.asarray(v), device=device) for k, v in batch.items()
            if hasattr(v, "dtype") and np.issubdtype(np.asarray(v).dtype, np.floating)}


def _pad_group(group: List[Dict[str, np.ndarray]]) -> List[Dict[str, np.ndarray]]:
    """Zero-pad the group's arrays of each key to the group's largest shape,
    as use_tpu stacks a group (loop.py:_stack_group): a loader batch padded
    to its own longest item may be shorter than its neighbours'."""
    keys = set(group[0]).intersection(*group[1:])
    out = [{} for _ in group]
    for k in keys:
        arrs = [np.asarray(g[k]) for g in group]
        top = tuple(max(a.shape[d] for a in arrs) for d in range(arrs[0].ndim))
        for o, a in zip(out, arrs):
            o[k] = a if a.shape == top else np.pad(a, [(0, m - s) for s, m in zip(a.shape, top)])
    return out


def _accum_batches(loader, accum: int) -> Iterator[List[Dict[str, np.ndarray]]]:
    """Groups of up to `accum` successive float batches; the trailing
    partial group is flushed at the epoch's end."""
    group: List[Dict[str, np.ndarray]] = []
    for batch in loader:
        group.append({k: np.asarray(v) for k, v in batch.items() if hasattr(v, "dtype")
                      and np.issubdtype(np.asarray(v).dtype, np.floating)})
        if len(group) == accum:
            yield _pad_group(group)
            group = []
    if group:
        yield _pad_group(group)


@dataclass
class FitResult:
    state: Any
    history: list = field(default_factory=list)
    steps: int = 0  # optimizer steps this run took
    microbatches: int = 0
    clips: int = 0  # training items those microbatches held


def build_train_state(model, lr: float = 5e-4, weight_decay: float = 1e-7,
                      grad_clip: Optional[float] = 100.0, ema_decay: float = 0.0) -> TrainState:
    net = model.score_net
    return TrainState.create(net, optim.adam(optim.trainable(net), lr, weight_decay),
                             grad_clip=grad_clip, ema_decay=ema_decay)


def fit_sgmse(
    model,
    datamodule,
    lr: float = 5e-4,
    weight_decay: float = 1e-7,
    grad_clip: float = 100.0,
    accumulate_grad_batches: int = 4,
    scheduler: Optional[Dict] = None,
    max_epochs: int = 1,
    seed: int = 0,
    ema_decay: float = 0.0,
    ckpt_dir: Optional[str] = None,
    resume: bool = False,
    logger: Optional[MetricLogger] = None,
    rich_eval_every: Optional[int] = None,
) -> FitResult:
    """Score-matching training (SGMSE_module semantics) of ``model.score_net``
    in place, on ``model.device``, its draws (crop, t, z) from a CPU
    generator seeded ``seed``. The backbone stays in its inference
    setting (dropout off), as use_tpu's loss applies it with train=False."""
    if rich_eval_every:
        raise NotImplementedError("rich_eval_every needs engine/evaluate.py, which is not "
                                  "ported yet (ROADMAP queue 1)")
    scheduler = scheduler or {"step_size": 30, "gamma": 0.5}
    device = model.device
    # the loss's draws come from the CPU's generator, so one seed trains on
    # the same draws on either device
    generator = torch.Generator().manual_seed(seed)
    state = build_train_state(model, lr, weight_decay, grad_clip, ema_decay)
    sched = optim.step_lr(lr, **scheduler)
    mgr = CheckpointManager(ckpt_dir, monitor="val/loss_Score") if ckpt_dir else None
    start_epoch = 0
    if resume and mgr and mgr.latest_step() is not None:
        state.load_state_dict(mgr.restore(map_location=device))
        start_epoch = int(mgr.latest_step()) + 1  # saved at epoch N -> resume at N + 1

    logger = logger or MetricLogger()
    result = FitResult(state=state)
    for epoch in range(start_epoch, max_epochs):
        optim.set_learning_rate(state.optimizer, sched(epoch))
        t0 = time.time()
        train_losses = []
        for group in _accum_batches(datamodule.train_dataloader(), accumulate_grad_batches):
            micro = [{k: torch.as_tensor(v, device=device) for k, v in mb.items()}
                     for mb in group]
            loss = float(sgmse_train_step(model, state, micro, generator)["loss_Score"])
            _check_finite("train/loss_Score", loss)
            train_losses.append(loss)
            result.steps += 1
            result.microbatches += len(micro)
            result.clips += sum(int(mb["clean"].shape[0]) for mb in micro)
        val_losses = [float(sgmse_eval_step(model, float_batch(batch, device),
                                            generator)["loss_Score"])
                      for batch in datamodule.val_dataloader()]
        row = {
            "epoch": epoch,
            "train/loss_Score": float(np.mean(train_losses)) if train_losses else math.nan,
            "val/loss_Score": float(np.mean(val_losses)) if val_losses else math.nan,
            "lr": float(sched(epoch)),
            "time_s": time.time() - t0,
        }
        logger.log(row)
        result.history.append(row)
        if mgr:
            mgr.save(epoch, state, {"val/loss_Score": row["val/loss_Score"]})
    return result
