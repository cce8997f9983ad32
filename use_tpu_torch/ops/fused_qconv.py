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
``qconv3x3_fused_prepared`` launches csrc/fused_qconv.cu on them (a TMA +
wgmma kernel for Hopper; ``pick_tile`` picks its tile, ``split_plan`` how
far a small launch splits its input channels over blocks, which then sum
into a workspace kept per device and left zero by every launch, so one
stream at a time may launch on a device).
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
CHUNK = 32  # input channels a chunk of the kernel's weight layout (the k of one wgmma)
HALF = CHUNK // 2  # input channels a 16-byte row of the weight layout
# the kernel's tiles, rows x pixels x output channels (csrc/fused_qconv.cu)
TILES = {"16x16x128": 0, "8x16x256": 1, "16x16x64": 2, "8x8x256": 3}


class QConvWeights(NamedTuple):
    """A 3x3 conv's weights prepared for K3 from (weight, u)."""

    qw: torch.Tensor  # int8 [ceil(C / 32), 2, 9, O, 16], the kernel's layout
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
    """int8 [O, C, 3, 3] -> int8 [ceil(C / 32), 2, 9, O, 16]: per 32-channel
    chunk, 16-channel half of it and tap, each output channel's 16 channels
    in 16 bytes, zeros past C. A tile's weights for a chunk are 18 runs of
    16 bytes for each of its output channels, which 18 bulk copies bring
    into the kernel's shared memory as wgmma reads them; a model rank's
    output channels are a slice of the fourth axis."""
    o, c = qw.shape[:2]
    nk = -(-c // CHUNK)
    qw = F.pad(qw.reshape(o, c, 9), (0, 0, 0, nk * CHUNK - c))
    return qw.reshape(o, nk, 2, HALF, 9).permute(1, 2, 4, 0, 3).contiguous()


def _weights_from_kernel(qw: torch.Tensor, c: int) -> torch.Tensor:
    """The inverse of ``_weights_for_kernel``: int8 [O, C, 3, 3]."""
    nk, _, _, o, _ = qw.shape
    return qw.permute(3, 0, 1, 4, 2).reshape(o, nk * CHUNK, 3, 3)[:, :c]


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


@functools.lru_cache(maxsize=None)
def pick_tile(h: int, w: int, o: int, b: int = 8) -> str:
    """The kernel's tile for b images h x w and o output channels, from the
    tiles timed on the H100 at the int8 path's shapes (PERF.md): the 8 x 8
    window where the images are at most 12 wide or make fewer than 32 tiles
    of 16 x 16 (a wider window is mostly padding there, and more, smaller
    tiles fill the card), else as many output channels a tile as o fills
    (the operand is made once for all of them)."""
    if w <= 12 or b * -(-h // 16) * -(-w // 16) < 32:
        return "8x8x256"
    if o <= 64:
        return "16x16x64"
    return "16x16x128" if o <= 128 else "8x16x256"


def tile_shape(tile: str) -> Tuple[int, int, int]:
    """(rows, pixels, output channels) of a tile of TILES."""
    th, tw, bn = (int(v) for v in tile.split("x"))
    return th, tw, bn


@functools.lru_cache(maxsize=None)
def split_plan(tile: str, b: int, c: int, h: int, w: int, o: int, sms: int) -> Tuple[int, int]:
    """(splits, workspace int32s) of a launch: where the tiles are fewer than
    half the card's ``sms`` SMs, each tile's chunks of 32 input channels are
    split over up to sms // tiles units (at most one a chunk), which sum into
    a workspace of the tile's accumulators and a counter a tile."""
    th, tw, bn = tile_shape(tile)
    tiles = b * -(-h // th) * -(-w // tw) * -(-o // bn)
    nk = -(-c // CHUNK)
    if tiles == 0 or 2 * tiles > sms:
        return 1, 0
    splits = min(nk, sms // tiles)
    return splits, (tiles * th * tw * bn + tiles if splits > 1 else 0)


def _fp32_aligned(t: torch.Tensor) -> torch.Tensor:
    """t as contiguous fp32 at a 16-byte aligned address (the kernel reads
    four channels at a time): t itself where it is one already."""
    if t.dtype != torch.float32 or not t.is_contiguous():
        t = t.float().contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_workspaces = {}  # device index -> int32 zeros, grown as a launch needs; the kernel leaves them zero


def _workspace(dev: torch.device, n: int) -> torch.Tensor:
    ws = _workspaces.get(dev.index)
    if ws is None or ws.numel() < n:
        ws = torch.zeros((n,), dtype=torch.int32, device=dev)
        _workspaces[dev.index] = ws
    return ws


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
    out_dtype. ``tile`` (a key of TILES) overrides ``pick_tile``. Where the
    caller passes contiguous fp32 gn_scale, gn_shift and bias, as
    ``FusedQConv3x3`` does, a launch allocates only its output."""
    no_grad_here("qconv3x3_fused", x, gn_scale, gn_shift, bias)
    qw, sw, iu = prepared
    if x.dim() != 4 or qw.dim() != 5 or qw.shape[1:3] != (2, 9) or qw.shape[4] != HALF:
        raise ValueError(f"qconv3x3_fused: x {tuple(x.shape)}, prepared weight {tuple(qw.shape)}")
    bsz, c, hh, ww = x.shape
    o = qw.shape[3]
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
    tile = pick_tile(hh, ww, o, bsz) if tile is None else tile
    if tile not in TILES:
        raise ValueError(f"qconv3x3_fused: tile {tile!r}, not one of {list(TILES)}")
    dev = x.device
    if gn_scale is None:
        gn_scale = torch.ones((bsz, c), device=dev)
        gn_shift = torch.zeros((bsz, c), device=dev)
    a, off = _fp32_aligned(gn_scale), _fp32_aligned(gn_shift)
    if a.shape != (bsz, c) or off.shape != (bsz, c):
        raise ValueError(f"qconv3x3_fused: gn_scale/gn_shift must be [{bsz}, {c}]")
    if bias is not None:
        bias = _fp32_aligned(bias)
        if bias.shape != (o,):
            raise ValueError(f"qconv3x3_fused: bias {tuple(bias.shape)} for {o} channels")
    index = x.get_device()
    for t in (a, off, iu, qw, sw) if bias is None else (a, off, iu, qw, sw, bias):
        if t.get_device() != index:
            raise ValueError("qconv3x3_fused: all tensors must be on one device")
    if qw.dtype != torch.int8 or not (qw.is_contiguous() and iu.is_contiguous()
                                      and sw.is_contiguous()) or iu.data_ptr() % 16 \
            or qw.data_ptr() % 16:
        raise ValueError("qconv3x3_fused: prepared weights must come from prepare_qconv_weight")
    splits, ws_ints = split_plan(tile, bsz, c, hh, ww, o, _sm_count(index))
    ws = _workspace(dev, ws_ints).data_ptr() if splits > 1 else None
    out = torch.empty((bsz, o, hh, ww), dtype=out_dtype, device=dev)
    status = _lib().qconv3x3_fused(
        x.data_ptr(), _DTYPE_CODES[x.dtype], a.data_ptr(), off.data_ptr(), iu.data_ptr(),
        qw.data_ptr(), sw.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(),
        _DTYPE_CODES[out_dtype], bsz, c, hh, ww, o, int(bool(act)), TILES[tile], splits, ws,
        cuda_build.stream(x),
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
    """How many floats d in [1, inf] (and NaNs) the kernel's branch-free
    reciprocals (csrc/fused_qconv.cu ``rcp_newton`` below 2^126,
    ``rcp_tiny`` above) round otherwise than the IEEE 1 / d, counted on the
    card over all of them: 0 is what makes the kernel's sigmoid the plain
    version's."""
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
                                   i32, i32, p, p]
    lib.qconv3x3_fused.restype = i32
    lib.qconv_rcp_check.argtypes = [p, p]
    lib.qconv_rcp_check.restype = i32
    return lib
