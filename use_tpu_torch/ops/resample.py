"""Polyphase sinc resampling as one strided convolution.

Port of use_tpu/ops/resample.py (torchaudio.functional.resample semantics,
sinc_interp_hann or sinc_interp_kaiser lowpass), which the multi-rate wave
discriminator uses from 24 kHz to 8, 12 and 16 kHz. The kernel bank
[new_g, K] is built once per signature in float64 on the host; a call is
one ``F.conv1d`` with stride orig/gcd and new/gcd output channels, the
phases then interleaved.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _resample_kernel(orig_freq: int, new_freq: int, lowpass_filter_width: int = 6,
                     rolloff: float = 0.99, resampling_method: str = "sinc_interp_hann",
                     beta: Optional[float] = None):
    """Polyphase kernel bank [new_g, width_total] (float32) and its geometry
    (width, orig_g, new_g)."""
    gcd = math.gcd(orig_freq, new_freq)
    orig_g, new_g = orig_freq // gcd, new_freq // gcd
    base_freq = min(orig_g, new_g) * rolloff
    width = int(np.ceil(lowpass_filter_width * orig_g / base_freq))
    idx = np.arange(-width, width + orig_g, dtype=np.float64)[None, :] / orig_g
    t = (-np.arange(new_g, dtype=np.float64)[:, None] / new_g + idx) * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    if resampling_method == "sinc_interp_hann":
        window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    elif resampling_method == "sinc_interp_kaiser":
        beta = 14.769656459379492 if beta is None else beta
        window = np.i0(beta * np.sqrt(1 - (t / lowpass_filter_width) ** 2)) / np.i0(beta)
    else:
        raise ValueError(f"unknown resampling_method {resampling_method}")
    tpi = t * np.pi
    kernels = np.where(tpi == 0, 1.0, np.sin(tpi) / np.where(tpi == 0, 1.0, tpi))
    kernels = kernels * window * (base_freq / orig_g)
    return kernels.astype(np.float32), width, orig_g, new_g


def resample(x: torch.Tensor, orig_freq: int, new_freq: int, lowpass_filter_width: int = 6,
             rolloff: float = 0.99, resampling_method: str = "sinc_interp_hann",
             beta: Optional[float] = None) -> torch.Tensor:
    """Resample [..., L] from orig_freq to new_freq -> [..., ceil(L new/orig)]."""
    if orig_freq == new_freq:
        return x
    kernels, width, orig_g, new_g = _resample_kernel(
        orig_freq, new_freq, lowpass_filter_width, rolloff, resampling_method, beta)
    batch_shape, length = x.shape[:-1], x.shape[-1]
    x2 = F.pad(x.reshape(-1, 1, length), (width, width + orig_g))
    w = torch.from_numpy(kernels).to(device=x.device, dtype=x.dtype)[:, None, :]  # [new_g, 1, K]
    y = F.conv1d(x2, w, stride=orig_g)  # [B, new_g, T]
    y = y.transpose(1, 2).reshape(y.shape[0], -1)  # interleave the phases
    target_len = int(np.ceil(new_g * length / orig_g))
    return y[:, :target_len].reshape(batch_shape + (target_len,))
