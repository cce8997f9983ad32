"""upfirdn2d and FIR up/down-sampling as NCHW depthwise torch convolutions.

Port of use_tpu/ops/upfirdn2d.py (dense default path). Semantics of the
reference CUDA op (op/upfirdn2d.py:162-208): zero-insert upsample by `up` ->
pad -> 2-D FIR *convolution* -> downsample by `down`. use_tpu ran these as
XLA convolutions, not Pallas, so they are plain torch here.

Two details carried over: the FIR kernel is flipped because upfirdn is a
convolution and F.conv2d a correlation (use_tpu upfirdn2d.py:51-52), and the
zero-insert upsample keeps ``up - 1`` trailing zeros after the last sample,
H*up samples in all (use_tpu upfirdn2d.py:54-57).

``upsample_conv_2d`` and ``conv_downsample_2d`` are the FIR resampling
convs of NCSN++'s Upsample / Downsample layers (use_tpu upfirdn2d.py:
241-282), on OIHW weights as the reference holds them.

Layout: ``[B, C, H, W]``.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F


def setup_kernel(k: Sequence[float]) -> np.ndarray:
    """Normalize a FIR kernel; 1-D inputs become separable outer products.

    Reference parity: up_or_down_sampling.py:188-195 (_setup_kernel).
    """
    k = np.asarray(k, dtype=np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    k /= np.sum(k)
    if not (k.ndim == 2 and k.shape[0] == k.shape[1]):
        raise ValueError(f"FIR kernel must be square 2-D, got {k.shape}")
    return k


def upfirdn2d(
    x: torch.Tensor,
    kernel: Union[np.ndarray, torch.Tensor],
    up: int = 1,
    down: int = 1,
    pad: Tuple[int, int] = (0, 0),
) -> torch.Tensor:
    """pad -> upsample-by-zeros -> FIR filter -> downsample on [B, C, H, W].

    `pad` is (before, after), applied to both spatial dims; negative pads
    crop the zero-upsampled input.
    """
    b, c, h, w = x.shape
    if up > 1:
        # zero insert: [B,C,H,1,W,1] padded to [B,C,H,up,W,up]
        x = F.pad(x.reshape(b, c, h, 1, w, 1), (0, up - 1, 0, 0, 0, up - 1))
        x = x.reshape(b, c, h * up, w * up)
    x = F.pad(x, (pad[0], pad[1], pad[0], pad[1]))
    kernel = np.asarray(kernel, np.float32)
    weight = _depthwise_weight(tuple(kernel.ravel().tolist()), kernel.shape, c, x.device, x.dtype)
    return F.conv2d(x, weight, stride=down, groups=c)


@functools.lru_cache(maxsize=64)
def _depthwise_weight(values, shape, channels, device, dtype) -> torch.Tensor:
    """The flipped FIR kernel as a depthwise conv weight [C, 1, kh, kw], made
    once per (kernel, channels, device, dtype): a host-to-device copy on every
    call would make the host wait for the card each time. Made outside
    inference mode, so callers with autograd on can use it too."""
    with torch.inference_mode(False):
        k = torch.tensor(values, dtype=torch.float32).reshape(shape)
        k = torch.flip(k, (0, 1)).to(dtype)
        return k[None, None].expand(channels, 1, *shape).contiguous().to(device)


def upsample_2d(
    x: torch.Tensor, k: Tuple[float, ...] = (1.0, 3.0, 3.0, 1.0), factor: int = 2, gain: float = 1.0
) -> torch.Tensor:
    """FIR 2x upsampling of [B, C, H, W] (up_or_down_sampling.py:202-232)."""
    p = len(k) - factor
    pad = ((p + 1) // 2 + factor - 1, p // 2)
    kern = setup_kernel(k) * (gain * factor ** 2)
    return upfirdn2d(x, kern, up=factor, pad=pad)


def downsample_2d(
    x: torch.Tensor, k: Tuple[float, ...] = (1.0, 3.0, 3.0, 1.0), factor: int = 2, gain: float = 1.0
) -> torch.Tensor:
    """FIR 2x downsampling of [B, C, H, W] (up_or_down_sampling.py:235-264)."""
    p = len(k) - factor
    pad = ((p + 1) // 2, p // 2)
    kern = setup_kernel(k) * gain
    return upfirdn2d(x, kern, down=factor, pad=pad)


def naive_upsample_2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsample (up_or_down_sampling.py:64-68)."""
    b, c, h, w = x.shape
    x = x[:, :, :, None, :, None].expand(b, c, h, factor, w, factor)
    return x.reshape(b, c, h * factor, w * factor)


def naive_downsample_2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Average-pool downsample (up_or_down_sampling.py:71-74)."""
    b, c, h, w = x.shape
    return x.reshape(b, c, h // factor, factor, w // factor, factor).mean(dim=(3, 5))


def upsample_conv_2d(
    x: torch.Tensor, w: torch.Tensor, k: Tuple[float, ...] = (1.0, 3.0, 3.0, 1.0),
    factor: int = 2, gain: float = 1.0,
) -> torch.Tensor:
    """Fused upsample + conv of [B, C, H, W] with an OIHW weight
    (up_or_down_sampling.py:77-149): a transposed conv of stride `factor`,
    then FIR smoothing. use_tpu's ``jax.lax.conv_transpose`` correlates the
    zero-inserted input with its HWIO kernel as it stands; ``F.conv_transpose2d``
    is the gradient of a correlation, so it takes that kernel flipped in
    space, with its in and out axes swapped ([I, O, kh, kw])."""
    if w.dim() != 4 or w.shape[2] != w.shape[3]:
        raise ValueError(f"upsample_conv_2d: weight {tuple(w.shape)} is not a square OIHW kernel")
    convh = w.shape[2]
    kern = setup_kernel(k) * (gain * (factor ** 2))
    p = (kern.shape[0] - factor) - (convh - 1)
    wt = torch.flip(w, (2, 3)).transpose(0, 1)
    x = F.conv_transpose2d(x, wt, stride=factor)
    return upfirdn2d(x, kern, pad=((p + 1) // 2 + factor - 1, p // 2 + 1))


def conv_downsample_2d(
    x: torch.Tensor, w: torch.Tensor, k: Tuple[float, ...] = (1.0, 3.0, 3.0, 1.0),
    factor: int = 2, gain: float = 1.0,
) -> torch.Tensor:
    """Fused FIR + strided conv of [B, C, H, W] with an OIHW weight
    (up_or_down_sampling.py:152-185)."""
    if w.dim() != 4 or w.shape[2] != w.shape[3]:
        raise ValueError(f"conv_downsample_2d: weight {tuple(w.shape)} is not a square OIHW kernel")
    convh = w.shape[2]
    kern = setup_kernel(k) * gain
    p = (kern.shape[0] - factor) + (convh - 1)
    x = upfirdn2d(x, kern, pad=((p + 1) // 2, p // 2))
    return F.conv2d(x, w, stride=factor)

