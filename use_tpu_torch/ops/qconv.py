"""int8 convolution of quant='int8' serving, with the s8 conv kernel.

Port of use_tpu/ops/qconv.py (:34-126) on NCHW activations and OIHW
weights. use_tpu runs these convs as XLA int8 convolutions; torch has no
int8 convolution on CUDA, so here the product is ``qconv3x3_s8``, a TMA +
wgmma implicit GEMM written for Hopper (csrc/qconv_s8.cu):

- ``quantize_per_sample(x)``: symmetric per-sample int8 (max-abs / 127);
- ``quantize_weight_per_cout(w)``: symmetric per-output-channel int8;
- ``quantize_with_scale(x, s)``: int8 with a given scale (per channel [C]
  on the channel axis, or a scalar);
- ``qconv2d(x, weight, ...)``: the dynamic path, each sample quantized, the
  weight per output channel, one kernel launch with a per-sample post-scale;
- ``qconv2d_prequant(qx, in_scale, weight, ...)``: the conv of an already
  quantized operand (``GroupNormAct(quant='out')``'s). A per-input-channel
  scale [C] folds into the weight before its quantization,
  conv(q * u, w) = conv(q, w * u); a scalar one dequantizes after the conv.

Both return ``out_dtype(acc * scale)`` without the bias; ``s8_conv``, the
dispatch under them, adds it in out_dtype, as use_tpu's ``QConv`` does
(``layers.QConv`` holds the weight and keeps it prepared). The weight is
quantized by ``prepare_s8_weight``, once per weight and scale.

The kernel's operand layout is "C32", int8 [B, ceil(C/32), 2, H, W, 16]:
each chunk of 32 channels as two halves of 16, each half pixel-major (the
16 channels of a pixel in 16 contiguous bytes), zeros past C (``pack_c32``
/ ``unpack_c32``). Every global stride of it is a multiple of 16 bytes,
which TMA needs and an NCHW int8 row (W bytes) is not, and a row of a half
plane is one TMA box row. The int8 producers of the serving path write it
(K1's int8 apply, the quantizes of ``layers``); ``s8_conv`` takes it, or an
NCHW operand that it packs.

On a CPU tensor the conv is its plain version: the int8 values convolved in
float64, whose sums are exact integers (fp32's are not: 127^2 x 2304 >
2^24), in any geometry. On a CUDA tensor it is the kernel, which takes a 3x3
conv with stride 1, dilation 1 and padding 1 (every int8 conv NCSN++
builds), and any other geometry raises. The kernel is bit-equal to the plain
version. ``qconv3x3_s8.launches`` counts its launches. Serving only: no
gradient, as in use_tpu.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from use_tpu_torch.ops import cuda_build
from use_tpu_torch.ops.fused_qconv import CHUNK, true_div
from use_tpu_torch.ops.gn_stats import no_grad_here, quantize_channels

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
Scale = Union[None, float, torch.Tensor]
# the kernel's tiles, output rows x pixels x output channels (csrc/qconv_s8.cu)
TILES = {"16x16x128": 0, "16x8x128": 1}
BN = 128  # output channels a tile: the prepared weights come in blocks of BN
HALF = CHUNK // 2  # channels a row of a C32 half plane


def pick_tile(w: int) -> str:
    """The kernel's tile for an image w pixels wide, from both timed on the
    H100 at the U-Net's levels (PERF.md): the 16-pixel-wide window down to
    64 x 24 (there its padding costs less than the 8-wide tile's half again
    as many tiles), the 8-wide one for 12 pixels and fewer."""
    return "16x8x128" if w <= 12 else "16x16x128"


def pack_c32(q: torch.Tensor) -> torch.Tensor:
    """[B, C, *spatial] -> C32 [B, ceil(C/32), 2, *spatial, 16]: channel
    32 k + 16 h + j of a position at [b, k, h, ..., j], zeros past C."""
    b, c = q.shape[:2]
    nk = -(-c // CHUNK)
    if nk * CHUNK != c:
        q = torch.cat([q, q.new_zeros((b, nk * CHUNK - c, *q.shape[2:]))], 1)
    return q.reshape(b, nk, 2, HALF, *q.shape[2:]).movedim(3, -1).contiguous()


def unpack_c32(q: torch.Tensor, c: int) -> torch.Tensor:
    """The inverse of ``pack_c32``: C32 [B, ceil(C/32), 2, *spatial, 16] ->
    [B, C, *spatial], contiguous."""
    b, nk = q.shape[:2]
    return q.movedim(-1, 3).reshape(b, nk * CHUNK, *q.shape[3:-1])[:, :c].contiguous()


def is_c32(q: torch.Tensor, c: int) -> bool:
    """Whether q has the C32 shape of c channels."""
    return q.dim() >= 4 and q.shape[1:3] == (-(-c // CHUNK), 2) and q.shape[-1] == HALF


def _clip_round(t: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(t), -127.0, 127.0).to(torch.int8)


def quantize_per_sample(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, ...] -> (int8 values, fp32 scales [B]); symmetric max-abs."""
    s = torch.clamp(true_div(x.abs().amax(dim=tuple(range(1, x.dim()))).float(), 127.0),
                    min=1e-12)
    return _clip_round(x.float() / s.reshape((-1,) + (1,) * (x.dim() - 1))), s


def quantize_weight_per_cout(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """OIHW weight -> (int8 weight, fp32 per-output-channel scales [O])."""
    s = torch.clamp(true_div(w.abs().amax(dim=tuple(range(1, w.dim()))).float(), 127.0),
                    min=1e-12)
    return _clip_round(w.float() / s.reshape((-1,) + (1,) * (w.dim() - 1))), s


def quantize_with_scale(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 with a given fp32 scale (clips outliers): s per
    channel [C] of an NCHW x, or a scalar."""
    s = torch.as_tensor(s, dtype=torch.float32, device=x.device)
    if s.dim() == 1:
        return quantize_channels(x, s)
    return _clip_round(x.float() / s)


class S8Weights(NamedTuple):
    """A conv's weights quantized for ``s8_conv``."""

    qw: torch.Tensor  # int8 [O, C, kh, kw]
    sw: torch.Tensor  # fp32 [O], the dequant scale of each output channel
    qk: Optional[torch.Tensor]  # int8, the kernel's layout (``_s8_weights``; 3x3 only)


def _s8_weights(qw: torch.Tensor) -> torch.Tensor:
    """int8 [O, C, 3, 3] -> int8 [ceil(O/128), ceil(C/32), 2, 9, 128, 16]: per
    block of 128 output channels and chunk of 32 input channels, its two
    halves of 16, each tap by tap, each output channel's 16 channels in 16
    bytes, zeros past O and C. A (block, chunk) is 36,864 contiguous bytes,
    the image of a stage's weights in the kernel's shared memory, which one
    bulk copy brings in."""
    o, c = qw.shape[:2]
    no, nk = -(-o // BN), -(-c // CHUNK)
    w = qw.new_zeros((no * BN, nk * CHUNK, 9))
    w[:o, :c] = qw.reshape(o, c, 9)
    return w.reshape(no, BN, nk, 2, HALF, 9).permute(0, 2, 3, 5, 1, 4).contiguous()


def prepare_s8_weight(weight: torch.Tensor, u: Optional[torch.Tensor] = None) -> S8Weights:
    """Quantize an OIHW weight per output channel, with the producer's
    per-input-channel scales u [C] folded in first where given (use_tpu
    qconv.py:101-107: w_eff = w * u[c])."""
    if weight.dim() != 4 or (u is not None and u.shape != (weight.shape[1],)):
        raise ValueError(f"prepare_s8_weight: weight {tuple(weight.shape)}, "
                         f"u {None if u is None else tuple(u.shape)}")
    w = weight if u is None else weight.float() * u.float()[None, :, None, None]
    qw, sw = quantize_weight_per_cout(w)
    qk = _s8_weights(qw) if weight.shape[2:] == (3, 3) else None
    return S8Weights(qw, sw.contiguous(), qk)


def _scale(sw: torch.Tensor, post: Scale) -> torch.Tensor:
    """The dequant scale of each sum: sw [O], sw * post ([O], post a
    scalar) or [B, O] (post per sample [B])."""
    if post is None:
        return sw
    post = torch.as_tensor(post, dtype=torch.float32, device=sw.device)
    if post.numel() == 1:
        return sw * post.reshape(())
    return post.reshape(-1, 1) * sw[None, :]


def s8_conv_plain(qx: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, out_dtype: torch.dtype = torch.float32,
                  stride: int = 1, padding: int = 1, dilation: int = 1) -> torch.Tensor:
    """out_dtype(out_dtype(conv(qx, qw) * scale) + bias): the int32 sums as
    exact float64 ones, scale [O] or [B, O], bias [O] added in out_dtype;
    qx NCHW or C32."""
    if qx.dim() == 6:
        qx = unpack_c32(qx, qw.shape[1])
    acc = torch.round(F.conv2d(qx.double(), qw.double(), stride=stride, padding=padding,
                               dilation=dilation))
    s = scale.float()
    s = s[None, :, None, None] if s.dim() == 1 else s[:, :, None, None]
    y = (acc.float() * s).to(out_dtype)
    return y if bias is None else y + bias.to(out_dtype)[None, :, None, None]


def qconv3x3_s8(qx: torch.Tensor, prepared: S8Weights, post: Scale = None,
                bias: Optional[torch.Tensor] = None, out_dtype: torch.dtype = torch.float32,
                tile: Optional[str] = None) -> torch.Tensor:
    """The kernel: int8 qx C32 [B, ceil(C/32), 2, H, W, 16] (contiguous, on the
    card) -> out_dtype(out_dtype(conv3x3_same(qx, qw) * sw[o] * post[b]) +
    out_dtype(bias[o])), [B, O, H, W]. post None, a scalar or [B] (a fp32
    tensor on the card, or a number); bias [O] or None. ``tile`` (a key of
    TILES) overrides ``pick_tile``."""
    no_grad_here("qconv3x3_s8", bias)
    if not qx.is_cuda:
        raise ValueError(f"qconv3x3_s8: the kernel takes a CUDA tensor, got {qx.device}")
    c = prepared.qw.shape[1]
    if qx.dtype != torch.int8 or qx.dim() != 6 or not is_c32(qx, c) or not qx.is_contiguous():
        raise ValueError(f"qconv3x3_s8: qx must be contiguous int8 C32 [B, ceil(C/32), 2, H, W, "
                         f"16] of {c} channels, got {qx.dtype} {tuple(qx.shape)}")
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"qconv3x3_s8: out_dtype {out_dtype} (float32, bfloat16)")
    bsz, nk, _, hh, ww, _ = qx.shape
    qk, sw = prepared.qk, prepared.sw
    o = prepared.qw.shape[0]
    if qk is None or tuple(qk.shape) != (-(-o // BN), nk, 2, 9, BN, HALF):
        raise ValueError(f"qconv3x3_s8: prepared weights of shape "
                         f"{tuple(prepared.qw.shape)} are not a 3x3 conv's for the kernel")
    dev = qx.device
    post_ptr, post_stride = None, 0
    if post is not None:
        post = torch.as_tensor(post, dtype=torch.float32, device=dev).reshape(-1).contiguous()
        if post.numel() not in (1, bsz):
            raise ValueError(f"qconv3x3_s8: post-scale for {post.numel()} samples, batch {bsz}")
        post_ptr, post_stride = post.data_ptr(), int(post.numel() > 1)
    bias_ptr = None
    if bias is not None:
        bias = bias if bias.dtype == torch.float32 and bias.is_contiguous() else \
            bias.float().contiguous()
        if bias.shape != (o,) or bias.device != dev:
            raise ValueError(f"qconv3x3_s8: bias {tuple(bias.shape)} on {bias.device} for {o} "
                             f"channels on {dev}")
        bias_ptr = bias.data_ptr()
    if qk.device != dev or sw.device != dev or sw.dtype != torch.float32:
        raise ValueError("qconv3x3_s8: prepared weights must be on the operand's device")
    if qx.data_ptr() % 16 or qk.data_ptr() % 16 or not qk.is_contiguous():
        raise ValueError("qconv3x3_s8: qx and the prepared weights must be 16-byte aligned")
    tile = pick_tile(ww) if tile is None else tile
    if tile not in TILES:
        raise ValueError(f"qconv3x3_s8: tile {tile!r}, not one of {list(TILES)}")
    out = torch.empty((bsz, o, hh, ww), dtype=out_dtype, device=dev)
    status = _lib().qconv3x3_s8(
        qx.data_ptr(), qk.data_ptr(), sw.data_ptr(), post_ptr, post_stride, bias_ptr,
        out.data_ptr(), _DTYPE_CODES[out_dtype], bsz, c, hh, ww, o, TILES[tile],
        cuda_build.stream(qx),
    )
    cuda_build.check(status, "qconv3x3_s8")
    _counter.launches += 1
    return out


qconv3x3_s8.launches = 0
_counter = qconv3x3_s8  # carries the count even while a caller swaps the module's name


def s8_conv(qx: torch.Tensor, prepared: S8Weights, post: Scale = None,
            bias: Optional[torch.Tensor] = None, out_dtype: torch.dtype = torch.float32,
            stride: int = 1, padding: int = 1, dilation: int = 1) -> torch.Tensor:
    """The int8 conv of quantized qx, NCHW [B, C, H, W] or C32 [B,
    ceil(C/32), 2, H, W, 16], on prepared weights: the plain version on the CPU
    and ``qconv3x3_s8`` on the card (3x3, stride 1, padding 1, dilation 1;
    other geometries raise there), which packs an NCHW operand first."""
    if qx.dtype != torch.int8:
        raise TypeError(f"s8_conv: qx must be int8, got {qx.dtype}")
    c = prepared.qw.shape[1]
    if not ((qx.dim() == 4 and qx.shape[1] == c) or (qx.dim() == 6 and is_c32(qx, c))):
        raise ValueError(f"s8_conv: qx {tuple(qx.shape)} for weights {tuple(prepared.qw.shape)}")
    if qx.is_cpu:
        return s8_conv_plain(qx, prepared.qw, _scale(prepared.sw, post), bias, out_dtype,
                             stride, padding, dilation)
    geometry = (tuple(prepared.qw.shape[2:]), stride, padding, dilation)
    if geometry != ((3, 3), 1, 1, 1):
        raise ValueError(
            f"s8_conv: the int8 conv kernel takes a 3x3 conv with stride 1, padding 1 and "
            f"dilation 1; got kernel {geometry[0]}, stride {stride}, padding {padding}, "
            f"dilation {dilation}")
    qx = pack_c32(qx) if qx.dim() == 4 else qx.contiguous()
    return qconv3x3_s8(qx, prepared, post, bias, out_dtype)


def qconv2d(x: torch.Tensor, weight: torch.Tensor, stride: int = 1, padding: int = 1,
            dilation: int = 1, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """int8 conv with dynamic scales (use_tpu qconv.py:57-76): each sample of
    x [B, C, H, W] quantized, the weight per output channel; -> the
    dequantized output, without bias."""
    no_grad_here("qconv2d", x, weight)
    qx, sx = quantize_per_sample(x)
    return s8_conv(qx, prepare_s8_weight(weight), sx, None, out_dtype, stride, padding,
                   dilation)


def qconv2d_prequant(qx: torch.Tensor, in_scale: Union[float, torch.Tensor],
                     weight: torch.Tensor, stride: int = 1, padding: int = 1, dilation: int = 1,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """int8 conv of an already quantized qx (use_tpu qconv.py:79-118):
    a 1-D in_scale is per input channel [C] and folds into the weight; a
    scalar, or a per-sample [B, 1, 1, 1], dequantizes after the conv; -> the
    output without bias."""
    no_grad_here("qconv2d_prequant", weight)
    in_scale = torch.as_tensor(in_scale, dtype=torch.float32, device=qx.device)
    if in_scale.dim() == 1:
        return s8_conv(qx, prepare_s8_weight(weight, in_scale), None, None, out_dtype, stride,
                       padding, dilation)
    return s8_conv(qx, prepare_s8_weight(weight), in_scale.reshape(-1), None, out_dtype,
                   stride, padding, dilation)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("qconv_s8")
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.qconv3x3_s8.argtypes = [p, p, p, p, i32, p, p, i32, i32, i32, i32, i32, i32, i32, p]
    lib.qconv3x3_s8.restype = i32
    return lib
