"""Data-parallel training: torch.distributed in place of use_tpu's mesh.

Port of use_tpu/parallel/mesh.py. use_tpu shards the batch axis of every
microbatch over a ('data', 'model') device mesh and lets XLA derive the
gradient all-reduce; the port runs one process a card under ``torchrun``
and wraps each network in DistributedDataParallel. What carries over:

- ``init_distributed``: joins the process group that ``torchrun`` describes
  (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR / MASTER_PORT); a no-op
  without it. NCCL where CUDA is available, gloo on the CPU.
- ``default_world``: ``default_mesh``'s rule (mesh.py:78-116). The ranks
  that train are gcd(global batch, world); where fewer than half of them
  would, on_idle='error' (the CLI's default) refuses with use_tpu's
  guidance, otherwise a warning, the first ``data`` ranks train in a group
  of their own and the others leave after a barrier.
- ``place_batch``: a rank's share of a step, its local microbatches padded
  to the largest shape over the ranks (use_tpu's global array has one
  length), as tensors on the rank's device.
- ``local_rows``: this rank's rows of a global draw (t, z), so that a
  W-rank step equals the one-process step over the concatenated batch, as
  use_tpu's mesh step equals its single-device step.
- ``make_mesh``: use_tpu's ('data', 'model') mesh (mesh.py:57-75) over the
  process group's ranks, laid out row-major as use_tpu reshapes its
  devices: rank = d * model + m, so a model group is ``model`` consecutive
  ranks. One ``dist.new_group`` a row (the model groups) and a column (the
  data groups); the ``World`` it returns is the data axis that
  ``local_rows``, ``place_batch`` and ``wrap`` take, and carries the model
  axis that parallel/sharding.py shards the network over.
"""
from __future__ import annotations

import inspect
import math
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from use_tpu_torch.utils.logging import ranked_logger

log = ranked_logger()

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE")


def init_distributed(backend: Optional[str] = None) -> bool:
    """Join the process group of a torchrun launch; -> whether one is
    running. Without torchrun's environment, a no-op (one process). The
    rank's card (LOCAL_RANK) is made current before the group starts.
    ``backend`` None: NCCL where CUDA is available, gloo otherwise."""
    if dist.is_initialized():
        return True
    if not all(k in os.environ for k in _TORCHRUN_ENV):
        return False
    local = int(os.environ.get("LOCAL_RANK", 0))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if torch.cuda.is_available():
        torch.cuda.set_device(local)
    dist.init_process_group(backend=backend, init_method="env://")
    log.info("data-parallel over %d ranks (backend %s)", dist.get_world_size(),
             dist.get_backend())
    return True


def local_device(device: torch.device) -> torch.device:
    """The rank's card under torchrun (cuda:LOCAL_RANK) for a bare 'cuda'."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", torch.cuda.current_device())))
    return device


@dataclass
class World:
    """The ranks of a fit: the data axis has ``size`` ranks, this one is
    ``rank`` among them (``trains`` False: it idles), ``group`` their
    process group (None: the default group, or no group at all). The model
    axis (``make_mesh``): ``model`` ranks hold the slices of one network
    (parallel/sharding.py), this one is ``model_rank`` among them,
    ``model_group`` theirs."""

    size: int = 1
    rank: int = 0
    trains: bool = True
    group: Optional[object] = None
    model: int = 1
    model_rank: int = 0
    model_group: Optional[object] = None

    @property
    def distributed(self) -> bool:
        return self.size > 1 and dist.is_available() and dist.is_initialized()

    @property
    def shape(self) -> Dict[str, int]:
        """use_tpu's ``mesh.shape``."""
        return {"data": self.size, "model": self.model}

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """x reduced over the training ranks, in place (x as it is on one)."""
        if self.distributed:
            dist.all_reduce(x, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op],
                            group=self.group)
        return x

    def barrier(self) -> None:
        if self.distributed:
            dist.barrier(group=self.group)


def data_ranks(global_batch: int, world: int, on_idle: str = "warn", model: int = 1) -> int:
    """default_mesh's rule: the data axis is gcd(global batch, world //
    model), so data * model ranks train; fewer than half of them raise where
    on_idle='error', else warn."""
    data = math.gcd(max(int(global_batch), 1), max(world // model, 1))
    if data * model < world:
        if on_idle == "error" and data * model < world / 2:
            raise ValueError(
                f"global batch {global_batch} maps onto only {data * model} "
                f"of {world} devices — more than half the slice would idle. "
                "Fix one of: data.batch_size=auto (scales the batch to the "
                "slice: micro_batch_per_device x devices), raise "
                "data.batch_size to a multiple of the device count, or pass "
                "train.mesh_idle=warn to accept the under-use."
            )
        log.warning(
            "mesh uses %d of %d devices (global batch %d is not divisible "
            "by more); raise data.batch_size to use the full slice",
            data * model, world, global_batch,
        )
    return data


def default_world(global_batch: int, world: Optional[int] = None,
                  on_idle: str = "warn", model: int = 1) -> World:
    """The world of a fit over `world` ranks (the process group's size by
    default), ``model`` ranks to a network's slices. Under a process group
    that not every rank trains in, the training ranks get groups of their
    own (``dist.new_group``, which every rank calls) and every rank passes
    one barrier, after which the idle ones leave (``World.trains`` False)."""
    initialized = dist.is_available() and dist.is_initialized()
    if world is None:
        world = dist.get_world_size() if initialized else 1
    data = data_ranks(global_batch, world, on_idle, model)
    if not initialized:
        return World(size=data, model=model)
    rank = dist.get_rank()
    if model > 1:
        out = _layout(data, model, rank)
    elif data == world:
        return World(size=world, rank=rank)
    else:
        out = World(size=data, rank=rank, group=dist.new_group(list(range(data))))
    if data * model < world:
        dist.barrier()
        if rank >= data * model:
            log.warning("rank %d idles (the global batch splits over %d ranks)", rank,
                        data * model)
            out.trains = False
    return out


def make_mesh(data: Optional[int] = None, model: int = 1,
              world: Optional[int] = None) -> World:
    """use_tpu's make_mesh (mesh.py:57-75) over the ranks of the process
    group, or over `world` ranks laid out without starting them (no groups):
    data=None takes every rank that the model axis leaves. Rank d * model +
    m is data index d and model index m."""
    initialized = dist.is_available() and dist.is_initialized()
    n = world if world is not None else (dist.get_world_size() if initialized else 1)
    if data is None:
        if n % model:
            raise AssertionError((n, model))
        data = n // model
    if data * model != n:
        raise AssertionError((data, model, n))
    if world is not None or not initialized:
        return World(size=data, model=model)
    if model == 1:
        return World(size=data, rank=dist.get_rank())
    return _layout(data, model, dist.get_rank())


def _layout(data: int, model: int, rank: int) -> World:
    """The groups of a (data, model) layout of ranks [0, data * model): one
    model group a row (consecutive ranks), one data group a column; every
    rank of the process group makes every group, in the same order. A rank
    outside the layout gets a World that does not train."""
    rows = [list(range(d * model, (d + 1) * model)) for d in range(data)]
    cols = [list(range(m, data * model, model)) for m in range(model)]
    model_groups = [dist.new_group(r) for r in rows]
    data_groups = [dist.new_group(c) for c in cols]
    if rank >= data * model:
        return World(size=data, rank=rank, trains=False, model=model)
    d, m = divmod(rank, model)
    return World(size=data, rank=d, group=data_groups[m], model=model, model_rank=m,
                 model_group=model_groups[d])


def local_rows(x: torch.Tensor, world: World) -> torch.Tensor:
    """This rank's rows of a global [B * size, ...] tensor: the ranks hold
    successive blocks, as use_tpu's 'data' axis shards the batch."""
    if not world.distributed:
        return x
    n = x.shape[0] // world.size
    return x[world.rank * n:(world.rank + 1) * n]


def place_batch(group: Sequence[Dict[str, np.ndarray]], device: torch.device,
                world: World) -> List[Dict[str, torch.Tensor]]:
    """A step's local microbatches as tensors on `device`, each key's arrays
    zero-padded to its largest shape over every rank (one all-reduce), as
    use_tpu's per-host shards stitch into one global array."""
    if world.distributed:
        keys = sorted(group[0])
        dims = [np.asarray(group[0][k]).ndim - 1 for k in keys]
        top = torch.tensor([s for k in keys for s in np.asarray(group[0][k]).shape[1:]],
                           dtype=torch.int64, device=device)
        top = world.all_reduce(top, "max").tolist()
        want, i = {}, 0
        for k, d in zip(keys, dims):
            want[k], i = tuple(top[i:i + d]), i + d
        group = [{k: np.pad(v, [(0, 0)] + [(0, m - s) for s, m in zip(v.shape[1:], want[k])])
                  if v.shape[1:] != want[k] else v for k, v in mb.items()} for mb in group]
    return [{k: torch.as_tensor(v, device=device) for k, v in mb.items()} for mb in group]


def wrap(module: torch.nn.Module, world: World, device: torch.device,
         find_unused_parameters: bool = False) -> Optional[torch.nn.Module]:
    """`module` in DistributedDataParallel over the training ranks, None
    where no process group runs. Buffers are constants built from the
    seed, so none is broadcast."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    from torch.nn.parallel import DistributedDataParallel

    ids = [device.index] if device.type == "cuda" and dist.get_backend(world.group) == "nccl" \
        else None
    params = inspect.signature(DistributedDataParallel).parameters
    no_sync = ({"forward_sync_buffers": False} if "forward_sync_buffers" in params
               else {"broadcast_buffers": False})
    return DistributedDataParallel(module, device_ids=ids, process_group=world.group,
                                   find_unused_parameters=find_unused_parameters, **no_sync)
