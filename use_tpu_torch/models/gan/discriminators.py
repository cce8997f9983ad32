"""HiFi-GAN-style discriminator banks, NCHW / NCW.

Port of use_tpu/models/gan/discriminators.py (reference
GAN/discriminator/hifigan_vocoder/hifigan_dicriminator.py:11-254,
hifigan.py:200-303, hifigan/open_models.py:282-331):

- MultiPeriodDiscriminator: periods 2/3/5/7/11, strided 2-D convs over the
  period-folded waveform;
- MultiWaveDiscriminator: grouped 1-D conv stacks at 8/12/16/24 kHz after
  polyphase resampling;
- MultiMelSpecDiscriminator: 2-D convs, InstanceNorm and GLU over log-mel;
- HifiganVocoderDiscriminator24kMVD, the shipped composite of the three,
  registered as ``hifigan_vocoder_discriminator_24k_MVD``.

Waveforms are [B, T]; feature maps [B, C, T] (1-D) and [B, C, H, W] (2-D),
use_tpu's NWC / NHWC maps transposed. Each module returns (logits,
feature maps); a bank returns lists over its discriminators and the
composite lists over its banks, [bank][disc]. Convolutions are plain, with
weight norm folded as in use_tpu; parameters are named as use_tpu's Flax
scopes (``MPD.period2.conv0.weight``), initialized from a seed like Flax's
defaults (LeCun-normal kernels, zero biases).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from use_tpu_torch.models.registry import DiscriminatorRegistry
from use_tpu_torch.ops.mel import MelConfig, melspectrogram
from use_tpu_torch.ops.resample import resample
from use_tpu_torch.ops.stft import reflect_pad

SAMPLE_RATE = 24000
LRELU_SLOPE = 0.1


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LRELU_SLOPE)


def reset_parameters(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Flax's default initialization of every conv under `module`, in
    registration order: kernels LeCun-normal (a normal truncated at two
    standard deviations, scaled to variance 1 / fan_in), biases zero."""
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)


class PeriodDiscriminator(nn.Module):
    """hifigan.py:200-267: the waveform reflect-padded to a multiple of the
    period, folded to [B, 1, T/p, p], convolved over time only."""

    def __init__(self, period: int = 3, kernel_sizes: Tuple[int, int] = (5, 3),
                 channels: int = 32, downsample_scales: Sequence[int] = (3, 3, 3, 3, 1),
                 max_downsample_channels: int = 1024):
        super().__init__()
        self.period = period
        k0, k1 = kernel_sizes
        in_chs, out_chs = 1, channels
        self.convs = []
        for i, scale in enumerate(downsample_scales):
            conv = nn.Conv2d(in_chs, out_chs, (k0, 1), stride=(scale, 1),
                             padding=((k0 - 1) // 2, 0))
            self.add_module(f"conv{i}", conv)
            self.convs.append(conv)
            in_chs, out_chs = out_chs, min(out_chs * 4, max_downsample_channels)
        # an even kernel (k1 - 1) with symmetric padding: one frame longer
        self.conv_post = nn.Conv2d(in_chs, 1, (k1 - 1, 1), padding=((k1 - 1) // 2, 0))

    def forward(self, x: torch.Tensor):
        b, t = x.shape
        if t % self.period:
            x = reflect_pad(x, 0, self.period - t % self.period)
            t = x.shape[-1]
        h = x.reshape(b, 1, t // self.period, self.period)
        fmap = []
        for conv in self.convs:
            h = _lrelu(conv(h))
            fmap.append(h)
        h = self.conv_post(h)
        fmap.append(h)
        return h.reshape(b, -1), fmap


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11)):
        super().__init__()
        self.discs = []
        for p in periods:
            d = PeriodDiscriminator(period=p)
            self.add_module(f"period{p}", d)
            self.discs.append(d)

    def forward(self, x: torch.Tensor):
        out = [d(x) for d in self.discs]
        return [o[0] for o in out], [o[1] for o in out]


class WaveDiscriminator(nn.Module):
    """Grouped 1-D conv stack at a target sample rate (open_models.py:282-331)."""

    KERNEL_SIZES = (15, 41, 41, 41, 41, 5, 3)
    STRIDES = (1, 4, 4, 4, 4, 1, 1)
    CHANNELS = (16, 64, 256, 1024, 1024, 1024, 1024)
    GROUPS = (1, 4, 16, 64, 256, 1, 1)

    def __init__(self, sample_rate: int = 24000):
        super().__init__()
        self.sample_rate = sample_rate
        self.convs = []
        in_chs = 1
        for i, (k, s, c, g) in enumerate(zip(self.KERNEL_SIZES, self.STRIDES, self.CHANNELS,
                                             self.GROUPS)):
            conv = nn.Conv1d(in_chs, c, k, stride=s, groups=g)
            self.add_module(f"conv{i}", conv)
            self.convs.append(conv)
            in_chs = c
        self.postnet = nn.Conv1d(in_chs, 1, 1)
        # the least input that leaves every VALID conv one frame
        min_len = 1
        for k, s in reversed(list(zip(self.KERNEL_SIZES, self.STRIDES))):
            min_len = (min_len - 1) * s + k
        self.min_len = min_len

    def forward(self, x: torch.Tensor):
        if self.sample_rate != SAMPLE_RATE:
            x = resample(x, SAMPLE_RATE, self.sample_rate)
        h = x[:, None]  # [B, 1, T]
        if h.shape[-1] < self.min_len:
            # zero-padded as use_tpu pads it: 8 kHz needs >= 3.7 s of 24 kHz
            # audio, where XLA would give an empty map and torch raises
            h = F.pad(h, (0, self.min_len - h.shape[-1]))
        fmap = []
        for conv in self.convs:
            h = _lrelu(conv(h))
            fmap.append(h)
        h = self.postnet(h)
        return h.mean(dim=-1), fmap  # logits [B, 1]: the mean over time


class MultiWaveDiscriminator(nn.Module):
    def __init__(self, sample_rates: Sequence[int] = (8000, 12000, 16000, 24000)):
        super().__init__()
        self.discs = []
        for sr in sample_rates:
            d = WaveDiscriminator(sample_rate=sr)
            self.add_module(f"wave{sr}", d)
            self.discs.append(d)

    def forward(self, x: torch.Tensor):
        out = [d(x) for d in self.discs]
        return [o[0] for o in out], [o[1] for o in out]


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d(affine=False) on NCHW: over H, W per channel, with the
    biased variance (jnp.var)."""
    var, mean = torch.var_mean(x, dim=(2, 3), keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps)


class MelspecDiscriminator(nn.Module):
    """2-D convs, InstanceNorm and GLU over the log-mel spectrogram
    (hifigan_dicriminator.py:11-70); the map is [B, C, mels, frames]."""

    KERNEL_SIZES = ((7, 7), (4, 4), (4, 4), (4, 4))

    def __init__(self, n_fft: int = 2048, win_length: int = 600, hop_length: int = 240,
                 n_mels: int = 128):
        super().__init__()
        if n_mels < 22:
            raise ValueError("the postnet needs >= 22 mel bins")
        self.mel_cfg = MelConfig(sample_rate=SAMPLE_RATE, n_fft=n_fft, win_length=win_length,
                                 hop_length=hop_length, n_mels=n_mels)
        self.convs = []
        in_chs = 1
        for i, k in enumerate(self.KERNEL_SIZES):
            conv = nn.Conv2d(in_chs, 64, k, stride=(1, 2), padding=(1, 2), bias=False)
            self.add_module(f"conv{i}", conv)
            self.convs.append(conv)
            in_chs = 32  # GLU halves the channels
        self.postnet = nn.Conv2d(in_chs, 1, (15, 5), stride=(1, 2))
        # the least frame count that leaves the stride-2 stack and the VALID
        # (15, 5) postnet a frame
        min_w = 5
        for k in reversed(self.KERNEL_SIZES):
            min_w = (min_w - 1) * 2 + k[1] - 4  # pad (2, 2) a side
        self.min_w = min_w

    def forward(self, x: torch.Tensor):
        h = torch.log(melspectrogram(x, self.mel_cfg) + 1e-5)[:, None]  # [B, 1, M, T]
        if h.shape[-1] < self.min_w:
            h = F.pad(h, (0, self.min_w - h.shape[-1]), value=float(np.log(1e-5)))
        fmap = []
        for conv in self.convs:
            h = instance_norm(conv(h))
            a, g = torch.chunk(h, 2, dim=1)  # GLU over channels
            h = a * torch.sigmoid(g)
            fmap.append(h)
        h = self.postnet(h)
        return h.mean(dim=(2, 3)), fmap  # logits [B, 1]


class MultiMelSpecDiscriminator(nn.Module):
    def __init__(self, n_ffts: Sequence[int] = (1024, 256, 512),
                 win_lengths: Sequence[int] = (960, 240, 480),
                 hop_lengths: Sequence[int] = (240, 60, 120), n_mels: Sequence[int] = (128, 64, 80)):
        super().__init__()
        self.discs = []
        for i, (nf, wl, hp, nm) in enumerate(zip(n_ffts, win_lengths, hop_lengths, n_mels)):
            d = MelspecDiscriminator(n_fft=nf, win_length=wl, hop_length=hp, n_mels=nm)
            self.add_module(f"mel{i}", d)
            self.discs.append(d)

    def forward(self, x: torch.Tensor):
        out = [d(x) for d in self.discs]
        return [o[0] for o in out], [o[1] for o in out]


class HifiganVocoderDiscriminator24kMVD(nn.Module):
    """The shipped composite D: MPD, the multi-rate wave bank and the
    multi-mel bank (hifigan_dicriminator.py:201-254)."""

    def __init__(self, seed: int = 0):
        super().__init__()
        self.MPD = MultiPeriodDiscriminator()
        self.MVD = MultiWaveDiscriminator()
        self.MMD = MultiMelSpecDiscriminator()
        reset_parameters(self, torch.Generator().manual_seed(seed))

    def forward(self, x: torch.Tensor) -> Tuple[List, List]:
        banks = [self.MPD(x), self.MVD(x), self.MMD(x)]
        return [b[0] for b in banks], [b[1] for b in banks]


DiscriminatorRegistry.register("hifigan_vocoder_discriminator_24k_MVD")(
    HifiganVocoderDiscriminator24kMVD)
