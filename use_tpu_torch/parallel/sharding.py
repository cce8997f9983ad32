"""Tensor parallelism over the 'model' axis: use_tpu's parallel/sharding.py.

use_tpu's rule (sharding.py:19-50) shards every parameter named ``kernel``
with ndim >= 2 and at least ``min_size`` elements on its output axis, and
keeps biases, norms and the NIN / Fourier ``W``s replicated; where the
output axis does not divide by the model axis, it falls back to
replication. XLA's SPMD partitioner then derives the collectives. The
port's kernels are the ``weight``s of its convs (OIHW) and dense layers
([out, in]), so the output axis is dim 0 (a transposed conv's is dim 1,
below); the FIR convs of Upsample / Downsample hold ``Conv2d_0.weight``,
which use_tpu names ``Conv2d_0_weight`` (no kernel), and stay replicated.

The collectives are written out here, over the model group of a
``make_mesh`` layout (parallel/mesh.py, rank = d * model + m):

- ``copy_to_model``: forward the identity; backward the all-reduce-sum of
  the input's gradient, which each model rank holds only in part;
- ``gather_from_model``: forward every rank's output channels gathered and
  concatenated; backward this rank's slice of the gradient (every model
  rank runs the same graph downstream of a gather, so its gradient is
  already whole: a summing backward, as torch.distributed.nn's all_gather
  has, multiplies it by the model axis);
- ``split_to_model``: this rank's slice of a replicated tensor (a copy,
  then the slice), so that the gradient of what it came from is whole.

A sharded layer (its ``tp`` the World of the layout) is column-parallel
with its output gathered: the conv or matmul of its output channels, then
the gather. The NCSN++ family's ``layers.Conv2d`` / ``layers.Linear``
carry that forward themselves, with the rank's slice of the bias
(``split_to_model``) inside the conv or matmul, so that each output
channel goes through the uncut layer's arithmetic; the BigGAN block's K2
runs on the shard of its output channels, and the int8 serving convs
(``FusedQConv3x3``, ``QConv``) run K3 or the s8 conv on them with the
bias slice in the kernel's epilogue (models/ncsnpp/layers.py): their
gathered output is the one-process call's, bit for bit. The plain torch
convs below add the replicated bias after the gather
(``column_parallel``). A plain torch conv (``nn.Conv1d`` /
``nn.Conv2d``, or a subclass that keeps their forward, as the NCSNv1
layers' ``Conv``) is cut where it lies under a module whose class sets
``shards_plain_convs`` (the discriminator banks, CSMGAN, the HiFi-GAN and
BWE generators, GaGNet, ConvTasNet, the NCSNv1 blocks): ``shard_params``
turns the instance itself into a ``ColumnParallelConv1d`` /
``ColumnParallelConv2d`` (its class, not its place in the parent: a net
that calls its convs from a plain list keeps calling the cut one, and the
state-dict keys stay; a subclass gets a column-parallel class of its own,
which keeps its methods). A grouped conv's slice covers a run of its
groups: the rank convolves those groups' input channels only, the slice
padded with zero rows to whole groups where the model axis does not divide
the group count. A transposed conv (``nn.ConvTranspose1d`` / ``2d``,
weight [I, O, k...]) has its output axis on dim 1, where Flax's kernel
[k..., I, O] has it last: it is cut on dim 1 and becomes a
``ColumnParallelConvTranspose1d`` / ``2d``; any crop of its output stays
with its caller. The gather is one opaque op (``model_all_gather``), so
that the ``conv_outs`` remat policy (models/ncsnpp/ncsnpp.py) keeps its
output and the backward's recomputation gathers nothing again.

In training (engine/state.py) the replicated parameters' gradients are
averaged over the model group, so the replicas stay bit-identical, and the
global-norm clip sees the whole gradient (``clip_grad_norm_``), as optax's
clip over sharded arrays does. ``model_bytes`` counts the bytes gathered
and all-reduced over the model groups.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from use_tpu_torch.parallel.mesh import World

model_bytes = {"gathered": 0, "all_reduced": 0}


def _all_reduce(x: torch.Tensor, world: World) -> torch.Tensor:
    """x summed over the model group, in place."""
    dist.all_reduce(x, group=world.model_group)
    model_bytes["all_reduced"] += x.numel() * x.element_size()
    return x


@torch.library.custom_op("use_tpu_torch::model_all_gather", mutates_args=())
def model_all_gather(x: torch.Tensor, dim: int, group_name: str, size: int) -> torch.Tensor:
    """x of each of the `size` ranks of the process group `group_name`,
    concatenated along `dim` in rank order."""
    group = dist.distributed_c10d._resolve_process_group(group_name)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    out = torch.cat(parts, dim)
    model_bytes["gathered"] += out.numel() * out.element_size()
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, world):
        ctx.world = world
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.world), None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, world, dim):
        ctx.world, ctx.dim = world, dim
        return model_all_gather(x, dim, world.model_group.group_name, world.model)

    @staticmethod
    def backward(ctx, g):
        world = ctx.world
        n = g.shape[ctx.dim] // world.model
        return g.narrow(ctx.dim, world.model_rank * n, n).contiguous(), None, None


def copy_to_model(x: torch.Tensor, world: World) -> torch.Tensor:
    """x, whose gradient is summed over the model group in the backward."""
    return _CopyToModel.apply(x, world)


def gather_from_model(x: torch.Tensor, world: World, dim: int) -> torch.Tensor:
    """The model ranks' x concatenated along `dim`; the gradient's slice of
    this rank flows back."""
    return _GatherFromModel.apply(x, world, dim)


def split_to_model(x: torch.Tensor, world: World, dim: int) -> torch.Tensor:
    """This rank's slice along `dim` of x, which every model rank holds
    whole; x's gradient is whole on every rank."""
    n = x.shape[dim] // world.model
    return copy_to_model(x, world).narrow(dim, world.model_rank * n, n)


def column_parallel(x: torch.Tensor, world: World, local: Callable[[torch.Tensor], torch.Tensor],
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A column-parallel layer: ``local`` (this rank's output channels, on
    dim 1) of x, gathered over the model group, then the replicated bias."""
    y = gather_from_model(local(copy_to_model(x, world)), world, 1)
    return y if bias is None else y + bias.view((1, -1) + (1,) * (y.dim() - 2))


class ColumnParallelConv:
    """The forward of a plain torch conv that ``shard_params`` cut: its
    ``weight`` holds this model rank's output channels (``tp`` the World).
    The slice [a, a + n) of the O output channels covers groups g0 .. g1 - 1
    (O / groups channels each); the rank convolves their input channels
    with g1 - g0 groups, its slice padded with zero rows to whole groups
    where it starts or ends inside one (the gradient of x then comes back
    whole through copy_to_model's all-reduce, zero outside each rank's
    groups)."""

    tp: Optional[World] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return column_parallel(x, self.tp, self._local, self.bias)

    def _local(self, x: torch.Tensor) -> torch.Tensor:
        w, tp = self.weight, self.tp
        n = w.shape[0]
        per_group = n * tp.model // self.groups
        a = tp.model_rank * n
        g0, g1 = a // per_group, -(-(a + n) // per_group)
        lead, trail = a - g0 * per_group, g1 * per_group - a - n
        if self.groups > 1:
            x = x.narrow(1, g0 * w.shape[1], (g1 - g0) * w.shape[1])
        padded = g1 - g0 > 1 and (lead or trail)
        if padded:
            w = torch.cat([w.new_zeros((lead,) + w.shape[1:]), w,
                           w.new_zeros((trail,) + w.shape[1:])])
        conv = F.conv1d if w.dim() == 3 else F.conv2d
        y = conv(x, w, None, self.stride, self.padding, self.dilation, g1 - g0)
        return y.narrow(1, lead, n) if padded else y


class ColumnParallelConv1d(ColumnParallelConv, nn.Conv1d):
    pass


class ColumnParallelConv2d(ColumnParallelConv, nn.Conv2d):
    pass


class ColumnParallelConvTranspose:
    """The forward of a plain torch transposed conv (one group) that
    ``shard_params`` cut: its ``weight`` [I, O / model, k...] holds this
    model rank's output channels on dim 1 (``tp`` the World); the rank's
    transposed conv, the gather on the channel axis, then the bias."""

    tp: Optional[World] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return column_parallel(x, self.tp, self._local, self.bias)

    def _local(self, x: torch.Tensor) -> torch.Tensor:
        conv = F.conv_transpose1d if self.weight.dim() == 3 else F.conv_transpose2d
        return conv(x, self.weight, None, self.stride, self.padding, self.output_padding, 1,
                    self.dilation)


class ColumnParallelConvTranspose1d(ColumnParallelConvTranspose, nn.ConvTranspose1d):
    pass


class ColumnParallelConvTranspose2d(ColumnParallelConvTranspose, nn.ConvTranspose2d):
    pass


_TRANSPOSED = (nn.ConvTranspose1d, nn.ConvTranspose2d)
_PLAIN = (nn.Conv1d, nn.Conv2d) + _TRANSPOSED
# the class a cut plain conv takes, by its own class; subclasses join at
# their first cut (``_column_parallel_class``)
_COLUMN_PARALLEL = {nn.Conv1d: ColumnParallelConv1d, nn.Conv2d: ColumnParallelConv2d,
                    nn.ConvTranspose1d: ColumnParallelConvTranspose1d,
                    nn.ConvTranspose2d: ColumnParallelConvTranspose2d}


def _column_parallel_class(cls: type) -> type:
    """The column-parallel class of a plain conv class: for a subclass of a
    torch conv, one made from it, with the column-parallel forward first."""
    if cls not in _COLUMN_PARALLEL:
        mixin = ColumnParallelConvTranspose if issubclass(cls, _TRANSPOSED) else ColumnParallelConv
        _COLUMN_PARALLEL[cls] = type(f"{cls.__name__}ColumnParallel", (mixin, cls),
                                     {"__module__": cls.__module__})
    return _COLUMN_PARALLEL[cls]


def _cuttable_plain(m: nn.Module) -> bool:
    """Whether `m` is a plain torch conv the port can cut: zero padding, the
    torch class's own forward, one group where it is transposed."""
    if not isinstance(m, _PLAIN) or m.padding_mode != "zeros":
        return False
    base = next(b for b in _PLAIN if isinstance(m, b))
    return type(m).forward is base.forward and not (isinstance(m, _TRANSPOSED) and m.groups > 1)


def _weight_axis(m: nn.Module) -> int:
    """The axis of `m`'s weight that holds its output channels: 1 for a
    transposed conv ([I, O, k...]), else 0."""
    return 1 if isinstance(m, _TRANSPOSED) else 0


def param_spec(name: str, tensor: torch.Tensor, min_size: int = 1 << 16,
               transposed: bool = False) -> Optional[int]:
    """The axis use_tpu's rule shards the parameter `name` on (the output
    axis of the port's kernels: 0, or 1 for a transposed conv's weight), or
    None: a ``weight`` of ndim >= 2 with at least `min_size` elements, but a
    FIR conv's (``Conv2d_0``)."""
    scope, _, leaf = name.rpartition(".")
    if leaf != "weight" or scope.rpartition(".")[2] == "Conv2d_0":
        return None
    if tensor.dim() < 2 or tensor.numel() < min_size:
        return None
    return 1 if transposed else 0


def _plain_conv_owners(module: nn.Module) -> List[str]:
    """The names of the modules under `module` (itself included) whose
    class sets ``shards_plain_convs``: their plain torch convs can be cut."""
    return [n for n, m in module.named_modules() if getattr(type(m), "shards_plain_convs", False)]


def _under(name: str, owners: List[str]) -> bool:
    return any(o == "" or name == o or name.startswith(o + ".") for o in owners)


def params_shardings(module: nn.Module, mesh: World,
                     min_size: int = 1 << 16) -> Dict[str, Optional[int]]:
    """Parameter name -> the axis ``shard_params`` cuts it on, or None
    (replicated, also where the output axis does not divide by the model
    axis). Raises, naming the parameter, where the rule shards a parameter
    of a module the port cannot cut: one other than the NCSN++ family's
    ``Conv2d`` (the int8 convs among them) and ``Linear``, and the plain
    torch convs of a net that sets ``shards_plain_convs`` (zero padding, the
    torch forward, one group where transposed)."""
    from use_tpu_torch.models.ncsnpp import layers

    owners = _plain_conv_owners(module)
    out: Dict[str, Optional[int]] = {}
    for mname, m in module.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            axis = param_spec(name, p, min_size, isinstance(m, _TRANSPOSED))
            if axis is not None and isinstance(m, nn.Embedding):
                axis = None  # use_tpu's ``embedding``, not a kernel
            plain = _cuttable_plain(m) and _under(mname, owners)
            if axis is not None and not plain and not isinstance(m, (layers.Conv2d,
                                                                     layers.Linear)):
                raise ValueError(
                    f"shard_params: {name} ({type(m).__name__}, {tuple(p.shape)}) is a kernel "
                    "that use_tpu's rule shards; the port shards the NCSN++ family's Conv2d "
                    "and Linear and the plain torch convs (zero padding, one group where "
                    "transposed) of a net that sets shards_plain_convs only")
            if axis is not None and p.shape[axis] % mesh.model:
                axis = None
            out[name] = axis
    return out


def shard_params(module: nn.Module, mesh: World,
                 min_size: int = 1 << 16) -> Dict[str, Optional[int]]:
    """Cut `module`'s parameters in place, from a full state: each model
    rank keeps its output slice of every weight ``params_shardings`` shards
    (a new Parameter; build the optimizer and the DDP wrapper after), and
    the layer gathers its output. -> the shardings."""
    plan = params_shardings(module, mesh, min_size)
    if mesh.model == 1:
        return plan
    if mesh.model_group is None:
        raise ValueError("shard_params needs the model group of make_mesh under a process group")
    for name, axis in plan.items():
        if axis is None:
            continue
        owner = module.get_submodule(name.rpartition(".")[0])
        full = owner.weight.detach()
        owner.weight = nn.Parameter(_slice(full, axis, mesh).clone(),
                                    requires_grad=owner.weight.requires_grad)
        owner.tp = mesh
        if isinstance(owner, _PLAIN):
            owner.__class__ = _column_parallel_class(type(owner))
    return plan


def _slice(x: torch.Tensor, axis: int, world: World) -> torch.Tensor:
    n = x.shape[axis] // world.model
    return x.narrow(axis, world.model_rank * n, n)


def shard_state_dict(state_dict: Dict[str, torch.Tensor], plan: Dict[str, Optional[int]],
                     mesh: World) -> Dict[str, torch.Tensor]:
    """A full state dict cut to this rank's slices (``plan``: the shardings
    of ``shard_params``), for a sharded module's ``load_state_dict``."""
    return {k: _slice(v, plan[k], mesh).clone() if plan.get(k) is not None else v
            for k, v in state_dict.items()}


def sharded_parameters(module: nn.Module) -> Dict[str, nn.Parameter]:
    """The parameters that hold a slice: the weights of the layers
    ``shard_params`` cut."""
    return {f"{n}.weight" if n else "weight": m.weight for n, m in module.named_modules()
            if getattr(m, "tp", None) is not None}


def gather_slices(module: nn.Module, tensors: Dict[str, torch.Tensor],
                  world: World) -> Dict[str, torch.Tensor]:
    """`tensors` (by `module`'s parameter names: its parameters, their
    gradients) with each of a cut weight's slices gathered whole over the
    model group, on the weight's output axis."""
    axes = {f"{n}.weight" if n else "weight": _weight_axis(m) for n, m in module.named_modules()
            if getattr(m, "tp", None) is not None}
    return {k: model_all_gather(v.detach(), axes[k], world.model_group.group_name, world.model)
            if k in axes else v for k, v in tensors.items()}


@torch.no_grad()
def gather_state_dict(module: nn.Module, mesh: World) -> Dict[str, torch.Tensor]:
    """`module`'s state dict with each slice gathered over the model group:
    the full state, as np.asarray gives a sharded jax array whole, which
    loads into an unsharded net bit for bit."""
    return gather_slices(module, module.state_dict(), mesh)


@torch.no_grad()
def average_replicated_grads(module: nn.Module, world: World) -> None:
    """The gradients of the replicated parameters averaged over the model
    group (one all-reduce), so that the replicas stay bit-identical where
    a backward is not deterministic."""
    sharded = {id(p) for p in sharded_parameters(module).values()}
    grads = [p.grad for p in module.parameters() if p.grad is not None and id(p) not in sharded]
    if not grads:
        return
    flat = _all_reduce(torch.cat([g.reshape(-1).float() for g in grads]), world) / world.model
    i = 0
    for g in grads:
        g.copy_(flat[i:i + g.numel()].view_as(g))
        i += g.numel()


@torch.no_grad()
def clip_grad_norm_(module: nn.Module, params: Iterable[nn.Parameter], max_norm: float,
                    world: World) -> torch.Tensor:
    """clip_grad_norm_ over the whole gradient: the squares of the slices
    summed over the model group, the replicated parameters' counted once.
    -> the global norm."""
    sharded = {id(p) for p in sharded_parameters(module).values()}
    params: List[nn.Parameter] = [p for p in params if p.grad is not None]

    def squares(ps):
        return torch.stack([p.grad.float().pow(2).sum() for p in ps]).sum() if ps else \
            torch.zeros((), device=params[0].grad.device)

    slices = _all_reduce(squares([p for p in params if id(p) in sharded]), world)
    norm = (slices + squares([p for p in params if id(p) not in sharded])).sqrt()
    torch.nn.utils.clip_grads_with_norm_(params, max_norm, norm)
    return norm
