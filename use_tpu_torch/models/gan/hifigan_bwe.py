"""HiFi-GAN+ bandwidth-extension generator (a WaveNet stack), NCW.

Port of use_tpu/models/gan/hifigan_bwe.py (reference
GAN/discriminator/hifigan/open_models.py:37-254): a kaiser-windowed sinc
resample to 24 kHz, zero padding of half the WaveNet's receptive field a
side, a stack of non-causal gated residual WaveNet layers, tanh, the pad
cut off. Parameters are named as use_tpu's Flax scopes, the WaveNet under
Flax's automatic name (``WaveNet_0.layer0_0.conv.weight``); weights are
drawn by discriminators.reset_parameters from ``seed``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from use_tpu_torch.models.gan.discriminators import reset_parameters
from use_tpu_torch.models.registry import GeneratorRegistry
from use_tpu_torch.ops.resample import resample

SAMPLE_RATE = 24000


class WaveNetLayer(nn.Module):
    """Gated residual layer: a dilated SAME conv to 2 x C/2 channels,
    tanh(a) sigmoid(g), 1x1 convs to the skip and the residual output;
    -> ((out + x) sqrt(1/2), skip)."""

    def __init__(self, channels: int, kernel_size: int = 3, dilation: int = 1):
        super().__init__()
        self.conv = nn.Conv1d(channels, channels, kernel_size, dilation=dilation,
                              padding=(kernel_size - 1) * dilation // 2)
        self.conv_skip = nn.Conv1d(channels // 2, channels, 1)
        self.conv_out = nn.Conv1d(channels // 2, channels, 1)

    def forward(self, x: torch.Tensor):
        a, g = torch.chunk(self.conv(x), 2, dim=1)
        h = torch.tanh(a) * torch.sigmoid(g)
        return (self.conv_out(h) + x) * math.sqrt(0.5), self.conv_skip(h)


class WaveNet(nn.Module):
    """(open_models.py:133-199): [B, 1, T] -> [B, out_channels, T]; the skip
    outputs summed and scaled by sqrt(1 / layers)."""

    shards_plain_convs = True  # parallel/sharding.py may cut its convs on the 'model' axis

    def __init__(self, stacks: int = 2, layers: int = 8, wavenet_channels: int = 128,
                 out_channels: int = 1, kernel_size: int = 3, dilation_base: int = 3):
        super().__init__()
        self.receptive_field = (kernel_size - 1) * stacks * sum(
            dilation_base ** i for i in range(layers))
        self.conv_in = nn.Conv1d(1, wavenet_channels, 1)
        self.layers = []
        for st in range(stacks):
            for i in range(layers):
                layer = WaveNetLayer(wavenet_channels, kernel_size, dilation_base ** i)
                self.add_module(f"layer{st}_{i}", layer)
                self.layers.append(layer)
        self.conv_out = nn.Conv1d(wavenet_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        s = 0.0
        for layer in self.layers:
            h, skip = layer(h)
            s = s + skip
        return self.conv_out(s * math.sqrt(1.0 / len(self.layers)))


class BandwidthExtender(nn.Module):
    """(open_models.py:74-131): [B, L] at `source_rate` -> [B, L'] at
    sample_rate (L' = ceil(L sample_rate / source_rate))."""

    shards_plain_convs = True  # parallel/sharding.py may cut its convs on the 'model' axis

    def __init__(self, sample_rate: int = SAMPLE_RATE, seed: int = 0):
        super().__init__()
        self.sample_rate = sample_rate
        self.WaveNet_0 = WaveNet()
        reset_parameters(self, torch.Generator().manual_seed(seed))

    def forward(self, x: torch.Tensor, source_rate: int) -> torch.Tensor:
        if source_rate != self.sample_rate:
            x = resample(x, source_rate, self.sample_rate, lowpass_filter_width=16,
                         rolloff=0.945, resampling_method="sinc_interp_kaiser",
                         beta=14.769656459379492)
        pad = self.WaveNet_0.receptive_field // 2
        h = torch.tanh(self.WaveNet_0(F.pad(x, (pad, pad))[:, None]))[:, 0]
        return h[:, pad:-pad]


GeneratorRegistry.register("hifigan_bwe")(BandwidthExtender)
