"""Training loops: the Lightning-Trainer replacement.

Port of use_tpu/engine/loop.py: ``fit_sgmse`` (loop.py:140-271) and
``fit_lsgan`` (loop.py:274-383). Epochs of optimizer steps over a
datamodule's train loader, each step a group of up to
``accumulate_grad_batches`` successive loader batches (the epoch's
trailing partial group makes one step over fewer), the per-epoch StepLR
(one for each of LSGAN's two optimizers), validation, a checkpoint per
epoch monitored on val/loss_Score or val/loss_G, resume, and a non-finite
loss stopping the run (``NonFiniteLossError``). One CPU ``torch.Generator``
seeded from ``seed`` draws every crop (and SGMSE's t and z) of training
and validation in order, so one seed trains on the same draws on either
device. ``fit_sgmse(rich_eval_every=K)`` runs the rich metric harness
(engine/evaluate.py) on validation utterances every K epochs.

Data-parallel by default, as use_tpu trains over its mesh (loop.py:108-117):
with ``mesh="auto"`` under a torch.distributed group (a ``torchrun``
launch, parallel/mesh.py) the ranks that ``default_world`` picks train,
each network in DistributedDataParallel; ``mesh=None`` (or no group) is
the one-device path, and a ``World`` is used as given. Each rank's loader
yields its share of the global batch; a step pads it to the largest shape
over the ranks and draws the global batch's crops, t and z from the shared
seed, taking its rows, so the run equals the one-process run over the
ranks' batches side by side. The losses, validation means included, are
means over the ranks, so a non-finite loss on any rank stops every rank.
Rank 0 writes the checkpoints (``async_ckpt``: on a background thread,
joined before the next save and at the end of the fit) while the others
wait at a barrier; a resume loads on every rank.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from use_tpu_torch.engine import optim
from use_tpu_torch.engine.checkpoint import CheckpointManager
from use_tpu_torch.engine.state import GANTrainState, TrainState
from use_tpu_torch.engine.train import (
    gan_eval_step,
    gan_train_step,
    rank_draws,
    sgmse_eval_step,
    sgmse_train_step,
)
from use_tpu_torch.parallel.mesh import World, default_world, place_batch, wrap
from use_tpu_torch.utils.logging import MetricLogger, ranked_logger

log = ranked_logger()


class NonFiniteLossError(RuntimeError):
    """A monitored loss became NaN or inf (the EarlyStopping check_finite analog)."""


def _check_finite(name: str, value: float) -> None:
    if not math.isfinite(value):
        raise NonFiniteLossError(f"{name} became non-finite: {value}")


def _floats(batch: Dict) -> Dict[str, np.ndarray]:
    """The float array leaves of a loader batch."""
    return {k: np.asarray(v) for k, v in batch.items()
            if hasattr(v, "dtype") and np.issubdtype(np.asarray(v).dtype, np.floating)}


def float_batch(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """The float array leaves of a loader batch, as tensors on `device`."""
    return {k: torch.as_tensor(v, device=device) for k, v in _floats(batch).items()}


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
        group.append(_floats(batch))
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


def resolve_world(mesh: Any, datamodule, on_idle: str = "warn") -> World:
    """use_tpu's _resolve_mesh: 'auto' the default world over the process
    group's ranks (one device without a group), a World as given, None one
    device."""
    if mesh is None:
        return World()
    if isinstance(mesh, World):
        return mesh
    if mesh != "auto":
        raise ValueError(f"mesh {mesh!r} ('auto' | None | a World)")
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return World()
    local = getattr(datamodule, "local_batch", getattr(datamodule, "batch_size", 1))
    return default_world(local * dist.get_world_size(), on_idle=on_idle)


def distribute(state: TrainState, world: World, device: torch.device,
                find_unused_parameters: bool = False) -> None:
    """Wrap the state's network in DDP over `world`'s ranks, where a process
    group runs (one rank too: a torchrun launch of one process)."""
    state.world = world
    state.ddp = wrap(state.model, world, device, find_unused_parameters)


def _save(mgr: Optional[CheckpointManager], world: World, epoch: int, state,
          metrics: Dict[str, float]) -> None:
    """Rank 0 saves; the others wait for it at a barrier."""
    if mgr is None:
        return
    if world.rank == 0:
        mgr.save(epoch, state, metrics)
    world.barrier()


def _finish(mgr: Optional[CheckpointManager], world: World) -> None:
    """Join the last asynchronous save before any rank goes on."""
    if mgr is not None:
        mgr.wait()
    world.barrier()


def _val_means(rows: List[Dict[str, float]], world: World,
               device: torch.device) -> Dict[str, float]:
    """Each key's mean over the batches, then over the ranks (one all-reduce)."""
    keys = list(rows[0]) if rows else []
    if not keys:
        return {}
    local = torch.tensor([float(np.mean([r[k] for r in rows])) for k in keys],
                         dtype=torch.float64, device=device)
    return dict(zip(keys, (world.all_reduce(local) / world.size).tolist()))


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
    async_ckpt: bool = False,
    mesh: Any = "auto",
    rich_eval_every: Optional[int] = None,
    rich_eval_files: int = 2,
    rich_eval_N: int = 10,
    mesh_idle: str = "warn",
) -> FitResult:
    """Score-matching training (SGMSE_module semantics) of ``model.score_net``
    in place, on ``model.device``, its draws (crop, t, z) from a CPU
    generator seeded ``seed``; data-parallel over the ranks of a process
    group by default (``mesh``, ``mesh_idle``: see the module's note). The
    backbone stays in its inference setting (dropout off), as use_tpu's
    loss applies it with train=False. Every ``rich_eval_every`` epochs rank
    0 enhances the first ``rich_eval_files`` validation utterances (pc
    sampler, N=``rich_eval_N``) and scores them (``val/si_sdr`` ...; the
    reference's per-epoch PESQ/SI-SDR/ESTOI, sgmse/model.py:193-257), with
    figures and audio to the logger."""
    scheduler = scheduler or {"step_size": 30, "gamma": 0.5}
    device = model.device
    world = resolve_world(mesh, datamodule, mesh_idle)
    # the loss's draws come from the CPU's generator, so one seed trains on
    # the same draws on either device
    generator = torch.Generator().manual_seed(seed)
    state = build_train_state(model, lr, weight_decay, grad_clip, ema_decay)
    result = FitResult(state=state)
    if not world.trains:
        return result
    sched = optim.step_lr(lr, **scheduler)
    mgr = (CheckpointManager(ckpt_dir, monitor="val/loss_Score", async_save=async_ckpt)
           if ckpt_dir else None)
    start_epoch = 0
    if resume and mgr and mgr.latest_step() is not None:
        state.load_state_dict(mgr.restore(map_location=device))
        start_epoch = int(mgr.latest_step()) + 1  # saved at epoch N -> resume at N + 1
    distribute(state, world, device)

    logger = logger or MetricLogger()
    for epoch in range(start_epoch, max_epochs):
        optim.set_learning_rate(state.optimizer, sched(epoch))
        t0 = time.time()
        train_losses = []
        for group in _accum_batches(datamodule.train_dataloader(), accumulate_grad_batches):
            micro = place_batch(group, device, world)
            loss = float(sgmse_train_step(model, state, micro, generator)["loss_Score"])
            _check_finite("train/loss_Score", loss)
            train_losses.append(loss)
            result.steps += 1
            result.microbatches += len(micro)
            result.clips += sum(int(mb["clean"].shape[0]) for mb in micro) * world.size
        val_rows = []
        for batch in datamodule.val_dataloader():
            (vb,) = place_batch([_floats(batch)], device, world)
            draws = (rank_draws(model, vb["clean"].shape[0], vb["clean"].shape[-1], world,
                                generator) if world.distributed else None)
            val_rows.append({k: float(v) for k, v in
                             sgmse_eval_step(model, vb, generator, draws).items()})
        val = _val_means(val_rows, world, device)
        row = {
            "epoch": epoch,
            "train/loss_Score": float(np.mean(train_losses)) if train_losses else math.nan,
            "val/loss_Score": val.get("loss_Score", math.nan),
            "lr": float(sched(epoch)),
            "time_s": time.time() - t0,
        }
        if rich_eval_every and (epoch + 1) % rich_eval_every == 0 and world.rank == 0:
            _rich_eval(model, datamodule, logger, epoch, rich_eval_files, rich_eval_N,
                       generator)
        logger.log(row)
        result.history.append(row)
        _save(mgr, world, epoch, state, {"val/loss_Score": row["val/loss_Score"]})
    _finish(mgr, world)
    return result


def first_pairs(loader, n: int) -> List[Dict[str, np.ndarray]]:
    """The first `n` (clean, perturbed) utterances of a loader's batches."""
    pairs: List[Dict[str, np.ndarray]] = []
    for batch in loader:
        for i in range(len(batch["clean"])):
            if len(pairs) >= n:
                return pairs
            pairs.append({"clean": np.asarray(batch["clean"][i]),
                          "perturbed": np.asarray(batch["perturbed"][i])})
    return pairs


def _rich_eval(model, datamodule, logger: MetricLogger, epoch: int, files: int, N: int,
               generator: torch.Generator) -> Dict[str, float]:
    """use_tpu fit_sgmse's rich harness (loop.py:231-264): enhance the first
    `files` validation utterances with the pc sampler at N steps, log
    val/<metric> means, figures and audio; its draws come from a generator
    on the model's device seeded from `generator`."""
    from use_tpu_torch.engine.evaluate import evaluate_model

    device = model.device
    sub = torch.Generator(device=device).manual_seed(
        int(torch.randint(0, 2 ** 31 - 1, (), generator=generator)))

    def enhance_fn(noisy, gen):
        out = model.sample({"perturbed": torch.as_tensor(noisy[None], device=device)}, gen, N=N)
        return out["enhanced"][0].float().cpu().numpy()

    rich = evaluate_model(enhance_fn, first_pairs(datamodule.val_dataloader(), files), sub)
    logger.log({"epoch": epoch, **{f"val/{k}": v for k, v in rich["metrics"].items()}})
    for i, fig in enumerate(rich["figures"]):
        logger.log_figure(f"val/example_{i}", fig, step=epoch)
    for i, clips in enumerate(rich["audio"]):
        for name, wav in clips.items():
            logger.log_audio(f"val/{name}_{i}", wav, 24000, step=epoch)
    return rich["metrics"]


def build_gan_train_state(gan, g_lr: float = 5e-4, d_lr: float = 2e-4,
                          weight_decay: float = 1e-7) -> GANTrainState:
    """Adam with coupled L2 and no clip for each network, as use_tpu's
    fit_lsgan (loop.py:306-307) passes no grad_clip."""
    g_net, d_net = gan.generator.net, gan.discriminator
    return GANTrainState(
        g=TrainState.create(g_net, optim.adam(optim.trainable(g_net), g_lr, weight_decay)),
        d=TrainState.create(d_net, optim.adam(optim.trainable(d_net), d_lr, weight_decay)))


def fit_lsgan(
    gan,
    datamodule,
    g_lr: float = 5e-4,
    d_lr: float = 2e-4,
    weight_decay: float = 1e-7,
    accumulate_grad_batches: int = 8,
    scheduler: Optional[Dict] = None,
    max_epochs: int = 1,
    seed: int = 0,
    ckpt_dir: Optional[str] = None,
    resume: bool = False,
    logger: Optional[MetricLogger] = None,
    async_ckpt: bool = False,
    mesh: Any = "auto",
    mesh_idle: str = "warn",
) -> FitResult:
    """Adversarial training (GANModule.training_step semantics) of the
    generator's backbone and the discriminator in place, on the generator's
    device, the crops drawn from a CPU generator seeded ``seed``;
    data-parallel as fit_sgmse. Each epoch validates (gan_eval_step: G's
    inference pass and the whole G criterion against the current D,
    LSGAN_module.validation_step:121-128) and checkpoints both networks and
    both optimizers on val/loss_G. A generator whose net leaves parameters
    out of its loss (``ddp_find_unused_parameters``, CSMGAN's) has DDP
    look for them."""
    scheduler = scheduler or {"step_size": 30, "gamma": 0.5}
    device = gan.device
    world = resolve_world(mesh, datamodule, mesh_idle)
    generator = torch.Generator().manual_seed(seed)
    state = build_gan_train_state(gan, g_lr, d_lr, weight_decay)
    result = FitResult(state=state)
    if not world.trains:
        return result
    g_sched, d_sched = optim.step_lr(g_lr, **scheduler), optim.step_lr(d_lr, **scheduler)
    mgr = (CheckpointManager(ckpt_dir, monitor="val/loss_G", async_save=async_ckpt)
           if ckpt_dir else None)
    start_epoch = 0
    if resume and mgr and mgr.latest_step() is not None:
        state.load_state_dict(mgr.restore(map_location=device))
        start_epoch = int(mgr.latest_step()) + 1  # saved at epoch N -> resume at N + 1
    distribute(state.g, world, device,
                getattr(gan.generator, "ddp_find_unused_parameters", False))
    distribute(state.d, world, device)

    logger = logger or MetricLogger()
    for epoch in range(start_epoch, max_epochs):
        optim.set_learning_rate(state.g.optimizer, g_sched(epoch))
        optim.set_learning_rate(state.d.optimizer, d_sched(epoch))
        t0 = time.time()
        g_losses, d_losses = [], []
        for group in _accum_batches(datamodule.train_dataloader(), accumulate_grad_batches):
            micro = place_batch(group, device, world)
            metrics = gan_train_step(gan, state, micro, generator)
            g_loss, d_loss = float(metrics["loss_G"]), float(metrics["loss_D"])
            _check_finite("train/loss_G", g_loss)
            _check_finite("train/loss_D", d_loss)
            g_losses.append(g_loss)
            d_losses.append(d_loss)
            result.steps += 1
            result.microbatches += len(micro)
            result.clips += sum(int(mb["clean"].shape[0]) for mb in micro) * world.size
        val_rows = []
        for b in datamodule.val_dataloader():
            (vb,) = place_batch([_floats(b)], device, world)
            val_rows.append({k: float(v) for k, v in gan_eval_step(gan, vb).items()})
        row = {
            "epoch": epoch,
            "train/loss_G": float(np.mean(g_losses)) if g_losses else math.nan,
            "train/loss_D": float(np.mean(d_losses)) if d_losses else math.nan,
            **{f"val/{k}": v for k, v in _val_means(val_rows, world, device).items()},
            "lr/G": float(g_sched(epoch)),
            "lr/D": float(d_sched(epoch)),
            "time_s": time.time() - t0,
        }
        logger.log(row)
        result.history.append(row)
        _save(mgr, world, epoch, state,
              {"val/loss_G": row.get("val/loss_G", row["train/loss_G"])})
    _finish(mgr, world)
    return result
