"""GroupNorm statistics and apply for NCHW activations (kernel K1).

Port of use_tpu/ops/gn_stats.py (Pallas ``_channel_sums_impl``, wrappers
``channel_sums`` and ``group_mean_meansq``) together with the apply half of
use_tpu/models/ncsnpp/layers.py::GroupNormAct (layers.py:216-256). One
GroupNorm is two hand-written CUDA passes (csrc/gn_stats.cu):

- ``channel_sums(x)``: per-(batch, channel) sum and sum of squares of
  x [B, C, S] in one read, fp32 accumulators;
- ``gn_fold(x, weight, bias, groups, eps)``: the same pass with the GroupNorm
  fold inside it (int8 serving's 'fold' mode, layers.py:231-250): the
  per-(batch, channel) scale and shift, for the int8 conv to apply;
- ``gn_apply(x, sums, sumsq, weight, bias, groups, ...)``: folds the group
  statistics, the clamped one-pass variance E[x^2]-E[x]^2, eps and the affine
  into a per-(batch, channel) scale and shift, and writes
  ``act(x * scale + shift)`` in the output dtype;
- ``gn_apply_int8(x, a, off, u, act, out_dtype, c32)``: the apply with an
  int8 epilogue, from the fold of ``gn_fold`` (quant='int8' serving's 'out'
  mode, use_tpu/models/ncsnpp/layers.py:257-272): y = act(x * a + off)
  rounded to out_dtype, then clip(round(y / u), -127, 127) as int8, u the
  k-sigma scale [C]; with c32 in the int8 conv's operand layout (C32, ops/
  qconv.py ``pack_c32``), which the kernel writes. Its plain version is the
  same apply followed by the quantize (``gn_apply_int8_plain``), and the
  kernel is bit-equal to it: its divisions (SiLU's, the quantize's) are
  correctly rounded without dividing, which ``silu_mismatches`` and
  ``quantize_mismatches`` check on the card.

Route: CUDA C++ through the same nvcc + ctypes build as K2, so the port has
one build path and no Triton dependency.

The statistics pass is one launch where a row is not cut into slices
(``split_rows``; every batch-8 level from 128 x 48 down), else a slice pass
and an ordered finalize.

Each wrapper takes its plain torch version (``*_plain``) for a CPU tensor;
for a CUDA tensor it launches its kernel or raises. ``<wrapper>.launches``
counts kernel launches; ``gn_fold`` counts as ``channel_sums``, and
``gn_apply_int8`` apart from ``gn_apply``. Bounds and design: see the note
in csrc/gn_stats.cu.

Gradients: where an input requires one, ``channel_sums`` and ``gn_apply``
run through ``torch.autograd.Function``s whose forward is the same
dispatch (plain version on the CPU, kernel on the card) and whose backward
is torch ops: ``channel_sums``' is use_tpu's custom VJP (gn_stats.py:114-117)
dx = ds + 2 x dss; ``gn_apply``'s recomputes the fold and the
pre-activation z from its saved inputs and hands (da, doff) back through
``fold_scale_shift``'s own autograd to the sums and the affine. ``gn_fold``
and ``gn_apply_int8`` (int8 serving) have no gradient and raise when one
is asked for.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from use_tpu_torch.ops import cuda_build

ACT_CODES = {None: 0, "swish": 1, "relu": 2, "lrelu": 3, "elu": 4}  # get_act names
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_TARGET_BLOCKS = 132 * 8  # enough blocks in flight to fill the H100's 132 SMs
_MIN_CHUNK = 8192  # elements a block streams at least
_WARPS = 8  # warps of a statistics block
_VEC = 8  # slices are whole 16-byte loads of bf16 (8) and fp32 (4) elements


def num_groups(channels: int) -> int:
    """GroupNorm(min(C//4, 32)) as used across NCSN++."""
    return min(max(channels // 4, 1), 32)


@functools.lru_cache(maxsize=None)
def split_rows(rows: int, s: int) -> Tuple[int, int]:
    """(splits, chunk): cut each of `rows` rows of `s` elements into `splits`
    slices of `chunk` elements (a multiple of 8), enough blocks to fill the
    card without slices below _MIN_CHUNK elements. One slice means short
    rows: the statistics take one warp a row and one launch."""
    want = max(1, -(-_TARGET_BLOCKS // rows))
    splits = max(1, min(want, -(-s // _MIN_CHUNK), 65535))
    chunk = -(-s // splits)
    chunk = -(-chunk // _VEC) * _VEC
    splits = -(-s // chunk)
    return splits, chunk


def rows_per_block(cg: int) -> int:
    """Rows a short-row statistics block owns: whole groups of `cg` rows, and
    at least one for each of its warps where a group is smaller."""
    return cg * max(1, _WARPS // cg)


def _check_cuda(x: torch.Tensor, what: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"{what}: expected a CPU or CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what}: dtype {x.dtype} not supported (float32, bfloat16)")
    if not x.is_contiguous():
        raise ValueError(f"{what}: input must be contiguous (NCHW)")


def _vec_ok(s: int, chunk: int, *tensors: torch.Tensor) -> int:
    return int(s % 4 == 0 and chunk % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------

def channel_sums_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum_x, sum_x2) over axis 2 of [B, C, S], fp32."""
    xf = x.float()
    return xf.sum(dim=2), (xf * xf).sum(dim=2)


@functools.lru_cache(maxsize=None)
def _stats_plan(b: int, c: int, s: int, dtype: torch.dtype, groups: int) -> tuple:
    """The statistics launch's constants for x [B, C, S] of `dtype`, with
    the fold of `groups` groups (0: no fold): (dtype code, rows, S, splits,
    chunk, rows a short-row block, whether 16-byte loads fit a row, C, cg)."""
    rows = b * c
    splits, chunk = split_rows(rows, s)
    cg = c // groups if groups else 1
    vec = s % (16 // dtype.itemsize) == 0
    return _DTYPE_CODES[dtype], rows, s, splits, chunk, rows_per_block(cg), vec, c, cg


def _stats(x: torch.Tensor, what: str, weight: Optional[torch.Tensor] = None,
           bias: Optional[torch.Tensor] = None, groups: int = 0,
           eps: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """One statistics launch on a CUDA tensor x [B, C, S]: the channel sums,
    or with weight and bias their GroupNorm fold. Both halves of the result
    are views of one [2, B, C] fp32 tensor. At the U-Net's low levels the
    card's work is a few microseconds and the host's steps here are the
    cost, so they are kept few: the launch constants are computed once per
    shape, one allocation, no copies of fp32 parameters."""
    _check_cuda(x, what)
    b, c, s = x.shape
    if groups and c % groups:
        raise ValueError(f"{what}: {c} channels not divisible into {groups} groups")
    code, rows, s, splits, chunk, per_block, vec, c, cg = _stats_plan(b, c, s, x.dtype, groups)
    x_ptr = x.data_ptr()
    w_ptr = b_ptr = None
    if weight is not None:
        if weight.dtype != torch.float32 or not weight.is_contiguous():
            weight = weight.float().contiguous()
        if bias.dtype != torch.float32 or not bias.is_contiguous():
            bias = bias.float().contiguous()
        if weight.shape != (c,) or bias.shape != (c,):
            raise ValueError(f"{what}: weight / bias must be [{c}]")
        if weight.get_device() != x.get_device() or bias.get_device() != x.get_device():
            raise ValueError(f"{what}: all tensors must be on one device")
        w_ptr, b_ptr = weight.data_ptr(), bias.data_ptr()
    out = x.new_empty((2, b, c), dtype=torch.float32)
    part = x.new_empty(2 * rows * splits, dtype=torch.float32) if splits > 1 else None
    status = _lib().gn_channel_sums(
        x_ptr, code, rows, s, splits, chunk, per_block, int(vec and x_ptr % 16 == 0),
        None if part is None else part.data_ptr(), out.data_ptr(), w_ptr, b_ptr, c, cg, eps,
        cuda_build.stream(x),
    )
    cuda_build.check(status, what)
    channel_sums.launches += 1
    return out.unbind(0)


def _needs_grad(*tensors: Optional[torch.Tensor]) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def no_grad_here(what: str, *tensors: Optional[torch.Tensor]) -> None:
    """Serving-only ops raise rather than return a result without a gradient."""
    if _needs_grad(*tensors):
        raise RuntimeError(f"{what} has no gradient (int8 serving only); call it under "
                           "torch.no_grad() or torch.inference_mode()")


def _channel_sums_fwd(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if x.is_cpu:
        return channel_sums_plain(x)
    return _stats(x, "channel_sums")


class _ChannelSums(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _channel_sums_fwd(x)

    @staticmethod
    def backward(ctx, ds, dss):
        (x,) = ctx.saved_tensors
        dx = torch.addcmul(ds[:, :, None], x.float(), dss[:, :, None], value=2.0)
        return dx.to(x.dtype)


def channel_sums(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum_x, sum_x2) over axis 2 of [B, C, S], fp32, in one read of x."""
    if x.dim() != 3:
        raise ValueError(f"channel_sums expects [B, C, S], got {tuple(x.shape)}")
    if _needs_grad(x):
        return _ChannelSums.apply(x)
    return _channel_sums_fwd(x)


channel_sums.launches = 0


def gn_fold_plain(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int, eps: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    return fold_scale_shift(*channel_sums_plain(x), weight, bias, groups, x.shape[2], eps)


def gn_fold(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int, eps: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GroupNorm statistics of [B, C, S] folded with the affine into (a, off),
    both [B, C] fp32, so that GroupNorm(x) = x * a + off (``fold_scale_shift``
    of the channel sums), in one read of x. On the card it is the statistics
    kernel with the fold inside, and counts as a ``channel_sums`` launch."""
    if x.dim() != 3:
        raise ValueError(f"gn_fold expects [B, C, S], got {tuple(x.shape)}")
    no_grad_here("gn_fold", x, weight, bias)
    if x.is_cpu:
        return gn_fold_plain(x, weight, bias, groups, eps)
    return _stats(x, "gn_fold", weight, bias, groups, eps)


def group_mean_meansq(x: torch.Tensor, groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(batch, group) mean and mean-square of [B, C, S] in one read of x.

    Groups are contiguous channel ranges (C % groups == 0)."""
    b, c, s = x.shape
    cg = c // groups
    sum_x, sum_x2 = channel_sums(x)
    n = float(s * cg)
    return sum_x.reshape(b, groups, cg).sum(-1) / n, sum_x2.reshape(b, groups, cg).sum(-1) / n


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------

def fold_scale_shift(
    sums: torch.Tensor, sumsq: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
    groups: int, s: int, eps: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(batch, channel) scale and shift [B, C] from channel sums, as
    layers.py:228-236: var = max(E[x^2] - E[x]^2, 0)."""
    b, c = sums.shape
    cg = c // groups
    n = float(s * cg)
    mean = sums.reshape(b, groups, cg).sum(-1) / n
    meansq = sumsq.reshape(b, groups, cg).sum(-1) / n
    var = torch.clamp(meansq - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)  # [B, G]
    a = inv[:, :, None] * weight.float().reshape(groups, cg)[None]
    off = bias.float().reshape(groups, cg)[None] - mean[:, :, None] * a
    return a.reshape(b, c), off.reshape(b, c)


def _act_backward(dy: torch.Tensor, z: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    """dy * act'(z), each in one pass of torch's own activation backward."""
    code = ACT_CODES[act]
    if code == 1:
        return torch.ops.aten.silu_backward(dy, z)
    if code == 2:
        return torch.ops.aten.threshold_backward(dy, z, 0.0)
    if code == 3:
        return torch.ops.aten.leaky_relu_backward(dy, z, 0.2, False)
    if code == 4:
        return torch.ops.aten.elu_backward(dy, 1.0, 1.0, 1.0, False, z)
    return dy


def _act_plain(y: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    code = ACT_CODES[act]
    if code == 1:
        return F.silu(y)
    if code == 2:
        return F.relu(y)
    if code == 3:
        return F.leaky_relu(y, 0.2)
    if code == 4:
        return F.elu(y)
    return y


def _apply_plain(x: torch.Tensor, a: torch.Tensor, off: torch.Tensor, act: Optional[str],
                 out_dtype: torch.dtype) -> torch.Tensor:
    """act(x * a + off) of [B, C, S] with a, off [B, C], in fp32, as out_dtype."""
    return _act_plain(x.float() * a[:, :, None] + off[:, :, None], act).to(out_dtype)


def gn_apply_plain(
    x: torch.Tensor, sums: torch.Tensor, sumsq: torch.Tensor, weight: torch.Tensor,
    bias: torch.Tensor, groups: int, eps: float = 1e-6, act: Optional[str] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    b, c, s = x.shape
    a, off = fold_scale_shift(sums, sumsq, weight, bias, groups, s, eps)
    return _apply_plain(x, a, off, act, out_dtype or x.dtype)


class _GNApply(torch.autograd.Function):
    """y = act(x a + off), (a, off) = fold_scale_shift(sums, sumsq, weight,
    bias). The backward recomputes (a, off) with autograd and z = x a + off:
    dz = dy act'(z), dx = dz a, da = sum_S dz x, doff = sum_S dz, and
    (da, doff) go back through the fold to the sums and the affine."""

    @staticmethod
    def forward(ctx, x, sums, sumsq, weight, bias, groups, eps, act, out_dtype):
        ctx.save_for_backward(x, sums, sumsq, weight, bias)
        ctx.cfg = (groups, eps, act)
        return _gn_apply_fwd(x, sums, sumsq, weight, bias, groups, eps, act, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, sums, sumsq, weight, bias = ctx.saved_tensors
        groups, eps, act = ctx.cfg
        fold_in = [t.detach().requires_grad_(need)
                   for t, need in zip((sums, sumsq, weight, bias), ctx.needs_input_grad[1:5])]
        with torch.enable_grad():
            a, off = fold_scale_shift(*fold_in, groups, x.shape[2], eps)
        xf = x.float()
        a3, off3 = a.detach()[:, :, None], off.detach()[:, :, None]
        dz = _act_backward(dy.float(), torch.addcmul(off3, xf, a3), act)
        dx = (dz * a3).to(x.dtype) if ctx.needs_input_grad[0] else None
        wanted = [t for t in fold_in if t.requires_grad]
        grads = iter(torch.autograd.grad((a, off), wanted, ((dz * xf).sum(2), dz.sum(2)))
                     if wanted else ())
        return (dx, *[next(grads) if t.requires_grad else None for t in fold_in],
                None, None, None, None)


def gn_apply(
    x: torch.Tensor, sums: torch.Tensor, sumsq: torch.Tensor, weight: torch.Tensor,
    bias: torch.Tensor, groups: int, eps: float = 1e-6, act: Optional[str] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """act(GroupNorm(x)) of [B, C, S] given its channel sums, in out_dtype
    (default x.dtype); statistics, fold and arithmetic in fp32."""
    if x.dim() != 3:
        raise ValueError(f"gn_apply expects [B, C, S], got {tuple(x.shape)}")
    if act not in ACT_CODES:
        raise NotImplementedError(f"activation {act!r} not supported")
    out_dtype = out_dtype or x.dtype
    if _needs_grad(x, sums, sumsq, weight, bias):
        return _GNApply.apply(x, sums, sumsq, weight, bias, groups, eps, act, out_dtype)
    return _gn_apply_fwd(x, sums, sumsq, weight, bias, groups, eps, act, out_dtype)


def _gn_apply_fwd(x, sums, sumsq, weight, bias, groups, eps, act, out_dtype) -> torch.Tensor:
    if x.is_cpu:
        return gn_apply_plain(x, sums, sumsq, weight, bias, groups, eps, act, out_dtype)
    _check_cuda(x, "gn_apply")
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"gn_apply: out_dtype {out_dtype} not supported")
    b, c, s = x.shape
    if c % groups:
        raise ValueError(f"gn_apply: {c} channels not divisible into {groups} groups")
    for t, name in ((sums, "sums"), (sumsq, "sumsq")):
        if t.shape != (b, c) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"gn_apply: {name} must be contiguous fp32 [{b}, {c}]")
    if weight.dtype != torch.float32 or not weight.is_contiguous():
        weight = weight.float().contiguous()
    if bias.dtype != torch.float32 or not bias.is_contiguous():
        bias = bias.float().contiguous()
    dev = x.get_device()
    if weight.get_device() != dev or bias.get_device() != dev or sums.get_device() != dev \
            or sumsq.get_device() != dev:
        raise ValueError("gn_apply: all tensors must be on one device")
    y = torch.empty_like(x, dtype=out_dtype)
    rows = b * c
    splits, chunk = split_rows(rows, s)
    lib = _lib()
    status = lib.gn_apply(
        x.data_ptr(), _DTYPE_CODES[x.dtype], y.data_ptr(), _DTYPE_CODES[out_dtype],
        sums.data_ptr(), sumsq.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        rows, c, groups, s, splits, chunk, float(eps), ACT_CODES[act],
        _vec_ok(s, chunk, x, y), cuda_build.stream(x),
    )
    cuda_build.check(status, "gn_apply")
    gn_apply.launches += 1
    return y


gn_apply.launches = 0


def quantize_channels(y: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """clip(round(y / u[c]), -127, 127) as int8 of [B, C, ...], u [C]: an
    IEEE division of the fp32 values, rounded half to even, as use_tpu's
    GroupNormAct quantizes (layers.py:269-271)."""
    shape = (1, -1) + (1,) * (y.dim() - 2)
    return torch.clamp(torch.round(y.float() / u.float().reshape(shape)), -127.0,
                       127.0).to(torch.int8)


def gn_apply_int8_plain(
    x: torch.Tensor, a: torch.Tensor, off: torch.Tensor, u: torch.Tensor,
    act: Optional[str] = None, out_dtype: torch.dtype = torch.float32, c32: bool = False,
) -> torch.Tensor:
    """The apply (y = act(x * a + off) in out_dtype), then the quantize;
    packed to C32 where c32."""
    q = quantize_channels(_apply_plain(x, a.float(), off.float(), act, out_dtype), u)
    if c32:
        from use_tpu_torch.ops.qconv import pack_c32

        return pack_c32(q)
    return q


def gn_apply_int8(
    x: torch.Tensor, a: torch.Tensor, off: torch.Tensor, u: torch.Tensor,
    act: Optional[str] = None, out_dtype: torch.dtype = torch.float32, c32: bool = False,
) -> torch.Tensor:
    """clip(round(out_dtype(act(x * a + off)) / u), -127, 127) as int8 of
    x [B, C, S] (fp32 or bf16) with the GroupNorm fold a, off [B, C] fp32
    (``gn_fold``) and the activation scales u [C] fp32: C32 [B, ceil(C/32),
    2, S, 16] where c32 (what the kernel writes), else [B, C, S]."""
    if x.dim() != 3:
        raise ValueError(f"gn_apply_int8 expects [B, C, S], got {tuple(x.shape)}")
    if act not in ACT_CODES:
        raise NotImplementedError(f"activation {act!r} not supported")
    no_grad_here("gn_apply_int8", x, a, off, u)
    b, c, s = x.shape
    if a.shape != (b, c) or off.shape != (b, c) or u.shape != (c,):
        raise ValueError(f"gn_apply_int8: a / off {tuple(a.shape)} / {tuple(off.shape)}, "
                         f"u {tuple(u.shape)} for x {tuple(x.shape)}")
    if x.is_cpu:
        return gn_apply_int8_plain(x, a, off, u, act, out_dtype, c32)
    _check_cuda(x, "gn_apply_int8")
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"gn_apply_int8: out_dtype {out_dtype} not supported")
    a, off, u = (t if t.dtype == torch.float32 and t.is_contiguous() else t.float().contiguous()
                 for t in (a, off, u))
    dev = x.get_device()
    if a.get_device() != dev or off.get_device() != dev or u.get_device() != dev:
        raise ValueError("gn_apply_int8: all tensors must be on one device")
    if b * s >= 2 ** 31:
        raise ValueError(f"gn_apply_int8: {b} x {s} positions exceed the kernel's 2^31")
    q = x.new_empty((b, -(-c // 32), 2, s, 16), dtype=torch.int8)
    status = _lib().gn_apply_q8(
        x.data_ptr(), _DTYPE_CODES[x.dtype], _DTYPE_CODES[out_dtype], q.data_ptr(),
        a.data_ptr(), off.data_ptr(), u.data_ptr(), b, c, s, ACT_CODES[act],
        int(s % 8 == 0 and x.data_ptr() % 16 == 0), cuda_build.stream(x),
    )
    cuda_build.check(status, "gn_apply_int8")
    gn_apply_int8.launches += 1
    if c32:
        return q
    from use_tpu_torch.ops.qconv import unpack_c32

    return unpack_c32(q, c)


gn_apply_int8.launches = 0


def silu_mismatches(device: torch.device) -> int:
    """How many floats v the int8 apply's SiLU (csrc/gn_stats.cu
    ``silu_q8``, a reciprocal and one fused correction) rounds otherwise
    than the plain version's v / (1 + exp(-v)), counted on the card over
    all 2^32 of them."""
    bad = torch.zeros((1,), dtype=torch.int64, device=device)
    cuda_build.check(_lib().gn_q8_silu_check(bad.data_ptr(), cuda_build.stream(bad)),
                     "gn_q8_silu_check")
    return int(bad.item())


def quantize_mismatches(u: torch.Tensor, bf16: bool) -> int:
    """How many (u, y) the int8 apply's quantize (csrc/gn_stats.cu
    ``quantize_q8``, no division) sends to another int8 than the plain
    version's clip(rint(y / u), -127, 127), for each scale of u (fp32 on the
    card): over all 65,536 bf16 values of y where bf16, else over every
    float y with |y| <= 128 u."""
    u = u.float().contiguous()
    bad = torch.zeros((1,), dtype=torch.int64, device=u.device)
    for part in u.split(65535):
        cuda_build.check(_lib().gn_q8_div_check(part.data_ptr(), part.numel(), int(bf16),
                                                bad.data_ptr(), cuda_build.stream(bad)),
                         "gn_q8_div_check")
    return int(bad.item())


def group_norm_act(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
    act: Optional[str] = None, out_dtype: Optional[torch.dtype] = None, eps: float = 1e-6,
) -> torch.Tensor:
    """GroupNorm (+ activation) of an NCHW tensor [B, C, ...] as the two
    passes channel_sums -> gn_apply; output shape of x, dtype out_dtype."""
    b, c = x.shape[:2]
    x3 = x.reshape(b, c, -1)
    sums, sumsq = channel_sums(x3)
    return gn_apply(x3, sums, sumsq, weight, bias, groups, eps, act, out_dtype).reshape(x.shape)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("gn_stats")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.gn_channel_sums.argtypes = [
        p, i32, i64, i64, i32, i64, i32, i32, p, p, p, p, i32, i32, ctypes.c_float, p,
    ]
    lib.gn_channel_sums.restype = i32
    lib.gn_apply.argtypes = [
        p, i32, p, i32, p, p, p, p, i64, i32, i32, i64, i32, i64, ctypes.c_float, i32, i32, p,
    ]
    lib.gn_apply.restype = i32
    lib.gn_apply_q8.argtypes = [p, i32, i32, p, p, p, p, i32, i32, i64, i32, i32, p]
    lib.gn_apply_q8.restype = i32
    lib.gn_q8_silu_check.argtypes = [p, p]
    lib.gn_q8_silu_check.restype = i32
    lib.gn_q8_div_check.argtypes = [p, i32, i32, p, p]
    lib.gn_q8_div_check.restype = i32
    return lib
