"""Train and eval steps of both tasks.

Port of use_tpu/engine/train.py. One optimizer step takes a group of
microbatches (successive loader batches), and only one microbatch's
activations are alive at a time.

- SGMSE (make_sgmse_train_step / _accum_grads, make_sgmse_eval_step): each
  microbatch's loss is scaled by 1/k before its backward, so the gradients
  the step applies are the MEAN over the group, as use_tpu's (Lightning's
  accumulate_grad_batches).
- LSGAN (make_gan_train_step, make_gan_eval_step; reference
  LSGAN_module.training_step:87-119): the D phase first, each
  microbatch's fake made without autograd, D's gradients SUMMED over the
  group (manual_backward), then D's step; the G phase second, against the
  updated D, on the same crops, G's gradients summed, then G's step.

Data-parallel (a state with ``ddp``, parallel/mesh.py): the network that
takes gradients runs through its DistributedDataParallel wrapper, the
first k - 1 microbatches of a group under ``no_sync``, so the last backward
all-reduces the group's sum once and the clip sees the global gradient.
LSGAN's D phase makes the fake through G's own module without autograd
and its G phase calls D's own module: a wrapper whose network takes no
gradient would wait for one. Without ``draws`` each rank draws the global
batch's (start, t, z) from the shared generator and takes its rows, so a
W-rank step is the one-process step over the ranks' batches in rank order.
The reported losses are means over the ranks.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import torch

from use_tpu_torch.engine.state import GANTrainState, TrainState
from use_tpu_torch.models.sgmse.score_model import Batch, ScoreModel, TrainDraws
from use_tpu_torch.parallel.mesh import local_rows


@contextlib.contextmanager
def _through(owner, attr: str, wrapper: Optional[torch.nn.Module]):
    """owner.<attr> is `wrapper` (a DDP wrapper of it) inside the block."""
    if wrapper is None:
        yield
        return
    own = getattr(owner, attr)
    setattr(owner, attr, wrapper)
    try:
        yield
    finally:
        setattr(owner, attr, own)


def _synced(state: TrainState, i: int, k: int):
    """All but the group's last microbatch keep their gradients local."""
    return state.no_sync() if i < k - 1 else contextlib.nullcontext()


def _rank_mean(state: TrainState, values: torch.Tensor) -> torch.Tensor:
    """`values` averaged over the training ranks (one all-reduce)."""
    world = state.world
    if world is None or not world.distributed:
        return values
    return world.all_reduce(values.clone()) / world.size


def rank_draws(model: ScoreModel, rows: int, length: int, world,
               generator: Optional[torch.Generator] = None) -> TrainDraws:
    """The draws of the global batch (rows x world.size clips of `length`),
    this rank's rows of them."""
    start, t, z = model.draw_train(rows * world.size, length, generator)
    return start, local_rows(t, world), local_rows(z, world)


def sgmse_train_step(model: ScoreModel, state: TrainState, micro: List[Batch],
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[Sequence[TrainDraws]] = None) -> Dict[str, torch.Tensor]:
    """One optimizer step over the microbatches `micro`; -> {"loss_Score":
    mean loss over the group} (a 0-d tensor on the device). ``draws`` gives
    each microbatch's (start, t, z) in place of the generator's."""
    k = len(micro)
    world = state.world
    if draws is None and world is not None and world.distributed:
        draws = [rank_draws(model, mb["clean"].shape[0], mb["clean"].shape[-1], world, generator)
                 for mb in micro]
    state.optimizer.zero_grad(set_to_none=True)
    total = None
    with _through(model, "score_net", state.ddp):
        for i, mb in enumerate(micro):
            with _synced(state, i, k):
                loss = model.train_loss(mb, generator, None if draws is None else draws[i])
                (loss / k).backward()
            total = loss.detach() if total is None else total + loss.detach()
    state.apply_gradients()
    return {"loss_Score": _rank_mean(state, total / k)}


@torch.no_grad()
def sgmse_eval_step(model: ScoreModel, batch: Batch,
                    generator: Optional[torch.Generator] = None,
                    draws: Optional[TrainDraws] = None) -> Dict[str, torch.Tensor]:
    """The score-matching loss on one batch, no gradient (validation and
    test); ``draws`` in place of the generator's, as train_loss takes them."""
    return {"loss_Score": model.train_loss(batch, generator, draws)}


def gan_train_step(gan, state: GANTrainState, micro: List[Batch],
                   generator: Optional[torch.Generator] = None,
                   starts: Optional[Sequence[int]] = None) -> Dict[str, torch.Tensor]:
    """One LSGAN optimizer step of each network over the microbatches
    `micro` (use_tpu make_gan_train_step). Each microbatch's crop start is
    drawn once from `generator` (or given in ``starts``) and serves both
    phases. -> {"loss_D": the group's mean D loss, "loss_G*": the G
    criterion's terms of the last microbatch}; like use_tpu's, whose
    reported loss_G is the last microbatch's too, as its logs hold loss_G."""
    if starts is None:
        starts = [gan.generator.draw_start(mb["clean"].shape[-1], generator) for mb in micro]
    k = len(micro)
    # D phase: the fake without autograd, D's gradients summed
    state.d.optimizer.zero_grad(set_to_none=True)
    loss_d = None
    with _through(gan, "discriminator", state.d.ddp):
        for i, (mb, start) in enumerate(zip(micro, starts)):
            with torch.no_grad():
                mb = gan.g_forward(mb, start=start)
            with _synced(state.d, i, k):
                loss = gan.d_loss(mb)
                loss.backward()
            loss_d = loss.detach() if loss_d is None else loss_d + loss.detach()
    state.d.apply_gradients()
    # G phase against the updated D, which takes no gradient
    state.g.optimizer.zero_grad(set_to_none=True)
    d_params = [p for p in gan.discriminator.parameters() if p.requires_grad]
    logs: Dict[str, torch.Tensor] = {}
    try:
        for p in d_params:
            p.requires_grad_(False)
        with _through(gan.generator, "net", state.g.ddp):
            for i, (mb, start) in enumerate(zip(micro, starts)):
                with _synced(state.g, i, k):
                    loss, logs = gan.g_loss(gan.g_forward(mb, start=start))
                    loss.backward()
                logs = {name: v.detach() for name, v in logs.items()}
    finally:
        for p in d_params:
            p.requires_grad_(True)
    state.g.apply_gradients()
    names = sorted(logs)
    means = _rank_mean(state.g, torch.stack([loss_d / k] + [logs[n] for n in names]))
    return {"loss_D": means[0], **{n: means[i + 1] for i, n in enumerate(names)}}


@torch.inference_mode()
def gan_eval_step(gan, batch: Batch) -> Dict[str, torch.Tensor]:
    """Validation and test (use_tpu make_gan_eval_step; reference
    LSGAN_module.validation_step:121-128): the generator's inference pass
    (no crop, frames padded to a multiple of 64) and the whole G criterion
    against the current D, no optimizer step. -> every loss_G* term."""
    loss, logs = gan.g_loss(gan.enhance(batch))
    return {"loss_G": loss, **logs}
