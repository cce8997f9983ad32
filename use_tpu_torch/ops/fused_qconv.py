"""Fused GroupNorm-affine + SiLU + int8-quantize 3x3 conv (kernel K3).

Port of the Pallas kernel use_tpu/ops/pallas_qconv.py::qconv3x3_fused, the
int8 serving conv of ``quant='int8_pallas'`` (use_tpu/models/ncsnpp/
layers.py:124-149), on NCHW tensors:

    q   = clip(round(act(x * a[b, c] + off[b, c]) * (1 / u[c])), -127, 127)
    acc = conv3x3_same(q, qw)              # int8 operands, int32 sums
    out = acc * sw[o] + bias[o]            # in out_dtype

SAME padding pads the quantized operand with zeros (not x: act(0 * a + off)
is not 0 once a shift or SiLU is fused). The per-input-channel activation
scale u folds into the weight quantization exactly (w_eff = w * u[c]), so
the int32 sum needs one dequant scale per output channel.

The weights are constants while serving, so their quantization is split
from the launch: ``prepare_qconv_weight`` quantizes them once (as use_tpu
does on every call) into the kernel's layout, and
``qconv3x3_fused_prepared`` launches csrc/fused_qconv.cu on them.
``qconv3x3_fused`` is the two in a row. ``qconv3x3_fused_plain`` is the same
arithmetic in torch ops (its integer conv is a float64 conv of the int8
values, exact whatever algorithm runs it). The wrappers take the plain
version for CPU tensors only; for CUDA tensors they launch the kernel or
raise. ``qconv3x3_fused.launches`` counts kernel launches. Serving only: no
backward, as in use_tpu; both wrappers raise when a gradient is asked for.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from use_tpu_torch.ops import cuda_build
from use_tpu_torch.ops.gn_stats import no_grad_here

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
CHUNK = 32  # input channels a chunk of the kernel's weight layout (the k of one mma)
# the kernel's tiles, pixels x output channels a block (csrc/fused_qconv.cu)
TILES = {"8x16x128": 0, "8x8x64": 1, "8x16x256": 2}


class QConvWeights(NamedTuple):
    """A 3x3 conv's weights prepared for K3 from (weight, u)."""

    qw: torch.Tensor  # int8 [ceil(C / 32), 9, O, 32], the kernel's layout
    sw: torch.Tensor  # fp32 [O], the dequant scale of each output channel
    iu: torch.Tensor  # fp32 [C], 1 / u


def true_div(t: torch.Tensor, d: float) -> torch.Tensor:
    """t / d rounded as one IEEE division on every device (torch's CUDA
    division by a Python scalar multiplies by its reciprocal instead)."""
    return t / torch.full_like(t, d)


def quantize_weight_folded(weight: torch.Tensor, u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """OIHW weight [O, C, 3, 3] and activation scales u [C] -> (int8 [O, C, 3, 3], f32 [O]).

    As use_tpu's ``_quantize_weight_folded`` (pallas_qconv.py:154-163):
    w_eff = w * u[c], s[o] = max(|w_eff|) / 127 (at least 1e-12),
    qw = clip(round(w_eff / s[o]), -127, 127)."""
    w_eff = weight.float() * u.float()[None, :, None, None]
    s = torch.clamp(true_div(w_eff.abs().amax(dim=(1, 2, 3)), 127.0), min=1e-12)
    qw = torch.clamp(torch.round(w_eff / s[:, None, None, None]), -127.0, 127.0)
    return qw.to(torch.int8), s


def _weights_for_kernel(qw: torch.Tensor) -> torch.Tensor:
    """int8 [O, C, 3, 3] -> int8 [ceil(C / 32), 9, O, 32]: per 32-channel
    chunk and tap, the chunk's channels of each output channel in 32
    consecutive bytes (the mma's col-major B operand), zeros past C."""
    o, c = qw.shape[:2]
    nk = -(-c // CHUNK)
    qw = F.pad(qw.reshape(o, c, 9), (0, 0, 0, nk * CHUNK - c))
    return qw.reshape(o, nk, CHUNK, 9).permute(1, 3, 0, 2).contiguous()


def _weights_from_kernel(qw: torch.Tensor, c: int) -> torch.Tensor:
    """The inverse of ``_weights_for_kernel``: int8 [O, C, 3, 3]."""
    nk, _, o, _ = qw.shape
    return qw.permute(2, 0, 3, 1).reshape(o, nk * CHUNK, 3, 3)[:, :c]


def prepare_qconv_weight(weight: torch.Tensor, u: torch.Tensor) -> QConvWeights:
    """Quantize an OIHW weight [O, C, 3, 3] against the activation scales u
    [C] once, for any number of ``qconv3x3_fused_prepared`` calls."""
    if weight.dim() != 4 or weight.shape[2:] != (3, 3) or u.shape != (weight.shape[1],):
        raise ValueError(f"prepare_qconv_weight: weight {tuple(weight.shape)}, u {tuple(u.shape)}")
    u = u.float().contiguous()
    qw, sw = quantize_weight_folded(weight, u)
    return QConvWeights(_weights_for_kernel(qw), sw.contiguous(), 1.0 / u)


def _quantize_act(y: torch.Tensor, iu: torch.Tensor) -> torch.Tensor:
    """clip(round(y * iu[c]), -127, 127) of an NCHW fp32 tensor, as float
    values (pallas_qconv.py:288-290 multiplies by the reciprocal of u)."""
    return torch.clamp(torch.round(y * iu[None, :, None, None]), -127.0, 127.0)


def _affine_act(x, gn_scale, gn_shift, act):
    y = x.float()
    if gn_scale is not None:
        y = y * gn_scale.float()[:, :, None, None] + gn_shift.float()[:, :, None, None]
    if act:
        y = y * torch.sigmoid(y)
    return y


def _plain(x, qw, sw, iu, gn_scale, gn_shift, act, bias, out_dtype, edge_leak=False):
    """The plain arithmetic on quantized weights qw [O, C, 3, 3] int8;
    ``edge_leak`` zero-pads x before the affine instead of the quantized
    operand after it."""
    if edge_leak:
        q = _quantize_act(_affine_act(F.pad(x.float(), (1, 1, 1, 1)), gn_scale, gn_shift, act), iu)
        acc = torch.round(F.conv2d(q.double(), qw.double()))
    else:
        q = _quantize_act(_affine_act(x, gn_scale, gn_shift, act), iu)
        acc = torch.round(F.conv2d(q.double(), qw.double(), padding=1))  # exact integers
    out = acc.float() * sw[None, :, None, None]
    if bias is not None:
        out = out + bias.float()[None, :, None, None]
    return out.to(out_dtype)


def qconv3x3_fused_plain(
    x: torch.Tensor, weight: torch.Tensor, u: torch.Tensor,
    gn_scale: Optional[torch.Tensor] = None, gn_shift: Optional[torch.Tensor] = None,
    act: bool = False, bias: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """The plain version, use_tpu's ``qconv3x3_reference`` (pallas_qconv.py:
    274-301) in NCHW / OIHW. x [B, C, H, W], weight [O, C, 3, 3], u [C],
    gn_scale / gn_shift [B, C] or None, bias [O] or None."""
    qw, sw = quantize_weight_folded(weight, u)
    return _plain(x, qw, sw, 1.0 / u.float(), gn_scale, gn_shift, act, bias, out_dtype)


def qconv3x3_edge_leak_plain(
    x: torch.Tensor, weight: torch.Tensor, u: torch.Tensor,
    gn_scale: Optional[torch.Tensor] = None, gn_shift: Optional[torch.Tensor] = None,
    act: bool = False, bias: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """A version broken on purpose, the control of the kernel checks: x is
    zero-padded BEFORE the affine, SiLU and quantize, so act(off) leaks into
    the image edges where the quantized operand should be zero."""
    qw, sw = quantize_weight_folded(weight, u)
    return _plain(x, qw, sw, 1.0 / u.float(), gn_scale, gn_shift, act, bias, out_dtype,
                  edge_leak=True)


def pick_tile(h: int, w: int, o: int) -> str:
    """The kernel's tile for an h x w image and o output channels, from the
    three timed on the H100 at the U-Net's levels (PERF.md): the narrow
    window where the image is at most 12 wide, else 256 channels a block
    where o > 128 (the operand is quantized once for all of them)."""
    if w <= 12:
        return "8x8x64"
    return "8x16x256" if o > 128 else "8x16x128"


def qconv3x3_fused_prepared(
    x: torch.Tensor, prepared: QConvWeights,
    gn_scale: Optional[torch.Tensor] = None, gn_shift: Optional[torch.Tensor] = None,
    act: bool = False, bias: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.bfloat16, tile: Optional[str] = None,
) -> torch.Tensor:
    """act(x * gn_scale + gn_shift) -> int8 -> 3x3 SAME conv -> dequant + bias,
    on weights from ``prepare_qconv_weight``.

    x [B, C, H, W] fp32 or bf16 (contiguous NCHW), gn_scale / gn_shift
    [B, C] fp32 or None (identity), bias [O] or None; output [B, O, H, W] in
    out_dtype. ``tile`` (a key of TILES) overrides ``pick_tile``."""
    no_grad_here("qconv3x3_fused", x, gn_scale, gn_shift, bias)
    qw, sw, iu = prepared
    if x.dim() != 4 or qw.dim() != 4 or qw.shape[1] != 9 or qw.shape[3] != CHUNK:
        raise ValueError(f"qconv3x3_fused: x {tuple(x.shape)}, prepared weight {tuple(qw.shape)}")
    bsz, c, hh, ww = x.shape
    o = qw.shape[2]
    if iu.shape != (c,) or qw.shape[0] != -(-c // CHUNK) or sw.shape != (o,):
        raise ValueError(f"qconv3x3_fused: prepared weights {tuple(qw.shape)} / {tuple(iu.shape)} "
                         f"do not take {c} channels")
    if (gn_scale is None) != (gn_shift is None):
        raise ValueError("qconv3x3_fused: gn_scale and gn_shift go together")
    if x.device.type == "cpu":
        return _plain(x, _weights_from_kernel(qw, c), sw, iu, gn_scale, gn_shift, act, bias,
                      out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"qconv3x3_fused: expected a CPU or CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODES or out_dtype not in _DTYPE_CODES:
        raise TypeError(f"qconv3x3_fused: x {x.dtype} / out {out_dtype} (float32, bfloat16)")
    if not x.is_contiguous():
        raise ValueError("qconv3x3_fused: x must be contiguous (NCHW)")
    if c % 4:
        raise ValueError(f"qconv3x3_fused: {c} input channels, not a multiple of 4")
    if bsz > 65535 or o > 65535 * 64:
        raise ValueError(f"qconv3x3_fused: batch {bsz} / O {o} exceeds the launch grid")
    tile = pick_tile(hh, ww, o) if tile is None else tile
    if tile not in TILES:
        raise ValueError(f"qconv3x3_fused: tile {tile!r}, not one of {list(TILES)}")
    dev = x.device
    if gn_scale is None:
        gn_scale = torch.ones((bsz, c), device=dev)
        gn_shift = torch.zeros((bsz, c), device=dev)
    # the kernel reads four channels of a, off and iu at a time: 16-byte aligned
    a, off = (t if t.data_ptr() % 16 == 0 else t.clone()
              for t in (gn_scale.float().contiguous(), gn_shift.float().contiguous()))
    if a.shape != (bsz, c) or off.shape != (bsz, c):
        raise ValueError(f"qconv3x3_fused: gn_scale/gn_shift must be [{bsz}, {c}]")
    bz = (torch.zeros((o,), device=dev) if bias is None else bias.float()).contiguous()
    for t in (a, off, iu, qw, sw, bz):
        if t.device != dev:
            raise ValueError("qconv3x3_fused: all tensors must be on one device")
    if qw.dtype != torch.int8 or not (qw.is_contiguous() and iu.is_contiguous()
                                      and sw.is_contiguous()) or iu.data_ptr() % 16:
        raise ValueError("qconv3x3_fused: prepared weights must come from prepare_qconv_weight")
    out = torch.empty((bsz, o, hh, ww), dtype=out_dtype, device=dev)
    status = _lib().qconv3x3_fused(
        x.data_ptr(), _DTYPE_CODES[x.dtype], a.data_ptr(), off.data_ptr(), iu.data_ptr(),
        qw.data_ptr(), sw.data_ptr(), bz.data_ptr(), out.data_ptr(), _DTYPE_CODES[out_dtype],
        bsz, c, hh, ww, o, int(bool(act)), TILES[tile], cuda_build.stream(x),
    )
    cuda_build.check(status, "qconv3x3_fused")
    _counter.launches += 1
    return out


def qconv3x3_fused(
    x: torch.Tensor, weight: torch.Tensor, u: torch.Tensor,
    gn_scale: Optional[torch.Tensor] = None, gn_shift: Optional[torch.Tensor] = None,
    act: bool = False, bias: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.bfloat16, prepared: Optional[QConvWeights] = None,
) -> torch.Tensor:
    """``prepare_qconv_weight(weight, u)`` then ``qconv3x3_fused_prepared``.

    x [B, C, H, W] fp32 or bf16 (contiguous NCHW), weight [O, C, 3, 3]
    (fp32 or bf16), u [C], gn_scale / gn_shift [B, C] fp32 or None
    (identity), bias [O] or None; output [B, O, H, W] in out_dtype.
    ``prepared``, when given, is what ``prepare_qconv_weight(weight, u)``
    returned: the weight is then not quantized again."""
    if x.dim() != 4 or weight.dim() != 4 or weight.shape[2:] != (3, 3):
        raise ValueError(f"qconv3x3_fused: x {tuple(x.shape)}, weight {tuple(weight.shape)}")
    if weight.shape[1] != x.shape[1] or u.shape != (x.shape[1],):
        raise ValueError(f"qconv3x3_fused: weight {tuple(weight.shape)} / u {tuple(u.shape)} "
                         f"do not take {x.shape[1]} channels")
    no_grad_here("qconv3x3_fused", weight, u)
    if prepared is None:
        prepared = prepare_qconv_weight(weight, u)
    return qconv3x3_fused_prepared(x, prepared, gn_scale, gn_shift, act, bias, out_dtype)


qconv3x3_fused.launches = 0
_counter = qconv3x3_fused  # carries the count even while a caller swaps the module's name


def rcp_mismatches(device: torch.device) -> int:
    """How many floats d in [1, 2^126) the kernel's branch-free reciprocal
    (csrc/fused_qconv.cu ``rcp_newton``) rounds otherwise than the IEEE
    1 / d, counted on the card over all of them: 0 is what makes the kernel's
    sigmoid the plain version's."""
    bad = torch.zeros((1,), dtype=torch.int64, device=device)
    cuda_build.check(_lib().qconv_rcp_check(bad.data_ptr(),
                                            torch.cuda.current_stream(device).cuda_stream),
                     "qconv_rcp_check")
    return int(bad.item())


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("fused_qconv")
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.qconv3x3_fused.argtypes = [p, i32, p, p, p, p, p, p, p, i32, i32, i32, i32, i32, i32, i32,
                                   i32, p]
    lib.qconv3x3_fused.restype = i32
    lib.qconv_rcp_check.argtypes = [p, p]
    lib.qconv_rcp_check.restype = i32
    return lib
