"""Multi-scale discriminator with db3 DWT downsampling, NCW.

Port of use_tpu/models/gan/msd.py (reference hifigan.py:303-477): between
scales, a single-level db3 analysis (two strided FIR correlations, the low
and the high band) whose two bands an aux 1-D conv fuses back to one
channel; each scale a grouped strided 1-D conv stack. Parameters are named
as use_tpu's Flax scopes (``scale0.conv1.weight``, ``aux_conv0.weight``);
the leaky ReLUs are discriminators._lrelu, looked up at call time.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from use_tpu_torch.models.gan import discriminators as disc

# Daubechies-3 decomposition filters (use_tpu's, the published coefficients)
_DB3_DEC_LO = np.array(
    [0.03522629188210, -0.08544127388224, -0.13501102001039,
     0.45987750211933, 0.80689150931334, 0.33267055295096], np.float64
)
_DB3_DEC_HI = np.array(
    [-0.33267055295096, 0.80689150931334, -0.45987750211933,
     -0.13501102001039, 0.08544127388224, 0.03522629188210], np.float64
)
# [2, 1, 6]: use_tpu correlates with the filters reversed (flt[::-1]), and
# F.conv1d correlates as lax.conv_general_dilated does
_DB3_WEIGHT = np.ascontiguousarray(
    np.stack([_DB3_DEC_LO, _DB3_DEC_HI])[:, None, ::-1]).astype(np.float32)


def dwt1d_db3(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-level db3 DWT of [B, 1, T] -> (lo, hi), each [B, 1, (T + 2) // 2 + 1]:
    zero boundary, 4 samples a side, stride 2 (pytorch_wavelets mode='zero')."""
    w = torch.from_numpy(_DB3_WEIGHT).to(device=x.device, dtype=x.dtype)
    y = F.conv1d(x, w, stride=2, padding=len(_DB3_DEC_LO) - 2)
    return y[:, :1], y[:, 1:]


class ScaleDiscriminator(nn.Module):
    """1-D conv stack over the waveform or its fused DWT (hifigan.py:303-405):
    [B, 1, T] -> (logits [B, T'], feature maps). Spectral norm on scale 0 in
    the reference is a training regularizer; plain kernels, as use_tpu's."""

    shards_plain_convs = True  # parallel/sharding.py may cut its convs on the 'model' axis

    def __init__(self, kernel_sizes: Tuple[int, ...] = (15, 41, 5, 3),
                 channels: int = 128, max_downsample_channels: int = 1024,
                 max_groups: int = 16, downsample_scales: Sequence[int] = (2, 2, 4, 4, 1)):
        super().__init__()
        k0, k1, k2, k3 = kernel_sizes
        self.conv0 = nn.Conv1d(1, channels, k0, padding=(k0 - 1) // 2)
        self.convs = [self.conv0]
        in_chs = out_chs = channels
        groups = 4
        for i, scale in enumerate(downsample_scales):
            conv = nn.Conv1d(in_chs, out_chs, k1, stride=scale, padding=(k1 - 1) // 2,
                             groups=groups)
            self.add_module(f"conv{i + 1}", conv)
            self.convs.append(conv)
            in_chs, out_chs = out_chs, min(out_chs * 2, max_downsample_channels)
            groups = min(groups * 4, max_groups)
        out_chs = min(in_chs * 2, max_downsample_channels)
        self.conv_pre_post = nn.Conv1d(in_chs, out_chs, k2, padding=(k2 - 1) // 2)
        self.convs.append(self.conv_pre_post)
        self.conv_post = nn.Conv1d(out_chs, 1, k3, padding=(k3 - 1) // 2)

    def forward(self, x: torch.Tensor):
        fmap = []
        h = x
        for conv in self.convs:
            h = disc._lrelu(conv(h))
            fmap.append(h)
        h = self.conv_post(h)
        fmap.append(h)
        return h.reshape(h.shape[0], -1), fmap


class MultiScaleDiscriminator(nn.Module):
    """Three scales, each after a db3 DWT and the aux fuse conv
    (hifigan.py:408-477): [B, T] -> ([logits], [feature maps])."""

    shards_plain_convs = True  # parallel/sharding.py may cut its convs on the 'model' axis

    def __init__(self, scales: int = 3):
        super().__init__()
        self.discs, self.aux = [], []
        for i in range(scales):
            if i:
                aux = nn.Conv1d(2, 1, 15, padding=7)
                self.add_module(f"aux_conv{i - 1}", aux)
                self.aux.append(aux)
            d = ScaleDiscriminator()
            self.add_module(f"scale{i}", d)
            self.discs.append(d)

    def forward(self, x: torch.Tensor):
        y = x[:, None]  # [B, 1, T]
        logits, fmaps = [], []
        for i, d in enumerate(self.discs):
            if i:
                y = disc._lrelu(self.aux[i - 1](torch.cat(dwt1d_db3(y), dim=1)))
            lg, fm = d(y)
            logits.append(lg)
            fmaps.append(fm)
        return logits, fmaps
