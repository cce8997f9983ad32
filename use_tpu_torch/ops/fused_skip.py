"""Fused resblock shortcut out = (h + conv1x1(x; W, b)) * scale (kernel K2).

Port of the Pallas kernel use_tpu/ops/pallas_skip.py::fused_skip_add: the
BigGAN resblock's 1x1 ``Conv_2`` shortcut, residual add and skip_rescale in
one pass (use_tpu/models/ncsnpp/layers.py:610-619), on NCHW tensors. The
CUDA C++ kernel (csrc/fused_skip.cu) computes the per-batch GEMM
W [Co, Ci] x [Ci, S] itself, with fp32 accumulation (bf16 on the tensor
cores, fp32 on the CUDA cores), and an epilogue that reads h and writes the
output once. Tiles and the 16-byte or scalar path are picked in the C entry
point. Bounds and design: see the note there.

``fused_skip_add`` takes ``fused_skip_add_plain`` for CPU tensors; for CUDA
tensors it launches the kernel or raises. ``fused_skip_add.launches`` counts
kernel launches.

Gradients: where an input requires one, the call runs through a
``torch.autograd.Function`` with the same dispatch forward and a backward
in torch ops, the products use_tpu leaves to XLA: with g = dy * scale,
dh = g, db = sum g, dx = W^T g and dW = g x^T, summed over batch and space.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from use_tpu_torch.ops import cuda_build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _shapes(x: torch.Tensor, h: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    if x.dim() != 4 or h.dim() != 4:
        raise ValueError(f"fused_skip_add expects NCHW x and h, got {tuple(x.shape)}, {tuple(h.shape)}")
    bsz, ci, hh, ww = x.shape
    co = h.shape[1]
    if h.shape != (bsz, co, hh, ww):
        raise ValueError(f"h {tuple(h.shape)} does not match x {tuple(x.shape)} in batch/space")
    w2 = w if w.dim() == 2 else w.reshape(w.shape[0], -1)
    if w2.shape != (co, ci) or b.shape != (co,):
        raise ValueError(f"weight {tuple(w.shape)} / bias {tuple(b.shape)} do not map {ci} -> {co}")
    return bsz, ci, co, hh * ww, w2


def fused_skip_add_plain(
    x: torch.Tensor, h: torch.Tensor, w: torch.Tensor, b: torch.Tensor, scale: float = 1.0
) -> torch.Tensor:
    """(h + W x + b) * scale with fp32 accumulation, output in h's dtype."""
    bsz, ci, co, s, w2 = _shapes(x, h, w, b)
    skip = torch.matmul(w2.float(), x.reshape(bsz, ci, s).float())  # [B, Co, S]
    out = (h.reshape(bsz, co, s).float() + skip + b.float()[:, None]) * scale
    return out.to(h.dtype).reshape(h.shape)


class _FusedSkipAdd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, h, w, b, scale):
        ctx.save_for_backward(x, w)
        ctx.scale = scale
        return _fused_skip_add_fwd(x, h, w, b, scale)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        bsz, ci, hh, ww = x.shape
        g = dy.float().reshape(bsz, -1, hh * ww) * ctx.scale  # [B, Co, S]
        need_x, need_h, need_w, need_b, _ = ctx.needs_input_grad
        w2 = w.float().reshape(w.shape[0], -1)  # [Co, Ci]
        dx = torch.matmul(w2.t(), g).reshape(x.shape).to(x.dtype) if need_x else None
        dh = g.reshape(dy.shape).to(dy.dtype) if need_h else None
        dw = (torch.matmul(g, x.float().reshape(bsz, ci, -1).transpose(1, 2)).sum(0)
              .reshape(w.shape).to(w.dtype) if need_w else None)
        db = g.sum((0, 2)).to(w.dtype) if need_b else None
        return dx, dh, dw, db, None


def fused_skip_add(
    x: torch.Tensor, h: torch.Tensor, w: torch.Tensor, b: torch.Tensor, scale: float = 1.0
) -> torch.Tensor:
    """(h + conv1x1(x; w, b)) * scale for x [B, Ci, H, W], h [B, Co, H, W],
    w [Co, Ci] (or [Co, Ci, 1, 1]), b [Co]; all of one dtype, output in it."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, h, w, b)):
        return _FusedSkipAdd.apply(x, h, w, b, scale)
    return _fused_skip_add_fwd(x, h, w, b, scale)


def _fused_skip_add_fwd(x, h, w, b, scale) -> torch.Tensor:
    bsz, ci, co, s, w2 = _shapes(x, h, w, b)
    if x.is_cpu:
        return fused_skip_add_plain(x, h, w, b, scale)
    if not x.is_cuda:
        raise ValueError(f"fused_skip_add: expected a CPU or CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_skip_add: dtype {x.dtype} not supported (float32, bfloat16)")
    dev = x.get_device()
    for t, name in ((h, "h"), (w2, "w"), (b, "b")):
        if t.dtype != x.dtype or t.get_device() != dev:
            raise TypeError(f"fused_skip_add: {name} must match x in dtype and device")
        if not t.is_contiguous():
            raise ValueError(f"fused_skip_add: {name} must be contiguous")
    if not x.is_contiguous():
        raise ValueError("fused_skip_add: x must be contiguous (NCHW)")
    if bsz > 65535:
        raise ValueError(f"fused_skip_add: batch {bsz} exceeds the launch grid")
    out = torch.empty_like(h)
    status = _lib().fused_skip_add(
        x.data_ptr(), h.data_ptr(), w2.data_ptr(), b.data_ptr(), out.data_ptr(),
        _DTYPE_CODES[x.dtype], bsz, ci, co, s, float(scale),
        cuda_build.stream(x),
    )
    cuda_build.check(status, "fused_skip_add")
    fused_skip_add.launches += 1
    return out


fused_skip_add.launches = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("fused_skip")
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fused_skip_add.argtypes = [p, p, p, p, p, i32, i32, i32, i32, ctypes.c_longlong, ctypes.c_float, p]
    lib.fused_skip_add.restype = i32
    return lib
