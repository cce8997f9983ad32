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

``qconv3x3_fused`` quantizes the weight in torch on every call, as use_tpu
does, and launches csrc/fused_qconv.cu; ``qconv3x3_fused_plain`` is the
same arithmetic in torch ops (its integer conv is a float64 conv of the
int8 values, exact whatever algorithm runs it). The wrapper takes the plain
version for CPU tensors only; for CUDA tensors it launches the kernel or
raises. ``qconv3x3_fused.launches`` counts kernel launches. Serving only:
no backward, as in use_tpu.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from use_tpu_torch.ops import cuda_build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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


def _quantize_act(y: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """clip(round(y * (1 / u[c])), -127, 127) of an NCHW fp32 tensor, as float
    values (pallas_qconv.py:288-290 multiplies by the reciprocal)."""
    iu = 1.0 / u.float()
    return torch.clamp(torch.round(y * iu[None, :, None, None]), -127.0, 127.0)


def _affine_act(x, gn_scale, gn_shift, act):
    y = x.float()
    if gn_scale is not None:
        y = y * gn_scale.float()[:, :, None, None] + gn_shift.float()[:, :, None, None]
    if act:
        y = y * torch.sigmoid(y)
    return y


def _dequant(acc, sw, bias, out_dtype):
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
    q = _quantize_act(_affine_act(x, gn_scale, gn_shift, act), u)
    qw, sw = quantize_weight_folded(weight, u)
    acc = torch.round(F.conv2d(q.double(), qw.double(), padding=1))  # exact integers
    return _dequant(acc, sw, bias, out_dtype)


def qconv3x3_edge_leak_plain(
    x: torch.Tensor, weight: torch.Tensor, u: torch.Tensor,
    gn_scale: Optional[torch.Tensor] = None, gn_shift: Optional[torch.Tensor] = None,
    act: bool = False, bias: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """A version broken on purpose, the control of the kernel checks: x is
    zero-padded BEFORE the affine, SiLU and quantize, so act(off) leaks into
    the image edges where the quantized operand should be zero."""
    xp = F.pad(x.float(), (1, 1, 1, 1))
    q = _quantize_act(_affine_act(xp, gn_scale, gn_shift, act), u)
    qw, sw = quantize_weight_folded(weight, u)
    acc = torch.round(F.conv2d(q.double(), qw.double()))
    return _dequant(acc, sw, bias, out_dtype)


def _weights_for_kernel(qw: torch.Tensor) -> torch.Tensor:
    """int8 [O, C, 3, 3] -> int8 [9, C/4, O, 4]: per tap, four consecutive
    input channels of one output channel form one 32-bit word (dp4a)."""
    o, c = qw.shape[:2]
    return qw.permute(2, 3, 1, 0).reshape(9, c // 4, 4, o).permute(0, 1, 3, 2).contiguous()


def qconv3x3_fused(
    x: torch.Tensor, weight: torch.Tensor, u: torch.Tensor,
    gn_scale: Optional[torch.Tensor] = None, gn_shift: Optional[torch.Tensor] = None,
    act: bool = False, bias: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """act(x * gn_scale + gn_shift) -> int8 -> 3x3 SAME conv -> dequant + bias.

    x [B, C, H, W] fp32 or bf16 (contiguous NCHW), weight [O, C, 3, 3]
    (fp32 or bf16; quantized here), u [C], gn_scale / gn_shift [B, C] fp32
    or None (identity), bias [O] or None; output [B, O, H, W] in out_dtype."""
    if x.dim() != 4 or weight.dim() != 4 or weight.shape[2:] != (3, 3):
        raise ValueError(f"qconv3x3_fused: x {tuple(x.shape)}, weight {tuple(weight.shape)}")
    bsz, c, hh, ww = x.shape
    o = weight.shape[0]
    if weight.shape[1] != c or u.shape != (c,):
        raise ValueError(f"qconv3x3_fused: weight {tuple(weight.shape)} / u {tuple(u.shape)} "
                         f"do not take {c} channels")
    if (gn_scale is None) != (gn_shift is None):
        raise ValueError("qconv3x3_fused: gn_scale and gn_shift go together")
    if x.device.type == "cpu":
        return qconv3x3_fused_plain(x, weight, u, gn_scale, gn_shift, act, bias, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"qconv3x3_fused: expected a CPU or CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODES or out_dtype not in _DTYPE_CODES:
        raise TypeError(f"qconv3x3_fused: x {x.dtype} / out {out_dtype} (float32, bfloat16)")
    if not x.is_contiguous():
        raise ValueError("qconv3x3_fused: x must be contiguous (NCHW)")
    if c % 4:
        raise ValueError(f"qconv3x3_fused: {c} input channels, not a multiple of 4")
    if bsz > 65535 or o > 65535 * 128:
        raise ValueError(f"qconv3x3_fused: batch {bsz} / O {o} exceeds the launch grid")
    dev = x.device
    if gn_scale is None:
        gn_scale = torch.ones((bsz, c), device=dev)
        gn_shift = torch.zeros((bsz, c), device=dev)
    a = gn_scale.float().contiguous()
    off = gn_shift.float().contiguous()
    if a.shape != (bsz, c) or off.shape != (bsz, c):
        raise ValueError(f"qconv3x3_fused: gn_scale/gn_shift must be [{bsz}, {c}]")
    u = u.float().contiguous()
    iu = 1.0 / u
    qw, sw = quantize_weight_folded(weight, u)
    qw = _weights_for_kernel(qw)
    bz = (torch.zeros((o,), device=dev) if bias is None else bias.float()).contiguous()
    for t in (a, off, u, qw, sw, bz):
        if t.device != dev:
            raise ValueError("qconv3x3_fused: all tensors must be on one device")
    out = torch.empty((bsz, o, hh, ww), dtype=out_dtype, device=dev)
    status = _lib().qconv3x3_fused(
        x.data_ptr(), _DTYPE_CODES[x.dtype], a.data_ptr(), off.data_ptr(), iu.data_ptr(),
        qw.data_ptr(), sw.data_ptr(), bz.data_ptr(), out.data_ptr(), _DTYPE_CODES[out_dtype],
        bsz, c, hh, ww, o, int(bool(act)), torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(status, "qconv3x3_fused")
    qconv3x3_fused.launches += 1
    return out


qconv3x3_fused.launches = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("fused_qconv")
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.qconv3x3_fused.argtypes = [p, i32, p, p, p, p, p, p, p, i32, i32, i32, i32, i32, i32, i32, p]
    lib.qconv3x3_fused.restype = i32
    return lib
