"""Spectrogram discriminators, NCHW.

Port of use_tpu/models/gan/spec_discriminator.py (reference
hifigan.py:479-611): the magnitude STFT of a [B, T] waveform, without a
gradient (the reference's torch.no_grad, use_tpu's stop_gradient), its
frequency bins as the input channels of a conv stack over the frames:
[B, F, frames, 1]. The (k, 1) convs take use_tpu's Flax padding
((k - 1) // 2, (k - 1) // 2), which Flax applies to both spatial axes, so
the width axis of 1 grows by k - 1 at each of them (conv_post alone pads
((1, 1), (0, 0))). Parameters are named as use_tpu's Flax scopes
(``spec0.conv_in.weight``).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from use_tpu_torch.models.gan import discriminators as disc
from use_tpu_torch.ops.stft import STFTConfig, stft


class SpecDiscriminator(nn.Module):
    """[B, T] -> (logits [B, frames', width'], feature maps [B, C, frames', width'])."""

    shards_plain_convs = True  # parallel/sharding.py may cut its convs on the 'model' axis

    def __init__(self, channels: int = 32, init_kernel: int = 15, kernel_size: int = 11,
                 stride: int = 2, fft_size: int = 1024, shift_size: int = 120,
                 win_length: int = 600, blocks: int = 3):
        super().__init__()
        self.stft_cfg = STFTConfig(n_fft=fft_size, hop_length=shift_size,
                                   win_length=win_length, center=True)
        p = (init_kernel - 1) // 2
        self.conv_in = nn.Conv2d(fft_size // 2 + 1, channels, (init_kernel, 1), padding=(p, p))
        self.convs = [self.conv_in]
        p = (kernel_size - 1) // 2
        for i in range(blocks):
            conv = nn.Conv2d(channels, channels, (kernel_size, 1), stride=(stride, 1),
                             padding=(p, p))
            self.add_module(f"conv{i}", conv)
            self.convs.append(conv)
        self.conv_final = nn.Conv2d(channels, channels, (5, 1), padding=(2, 2))
        self.convs.append(self.conv_final)
        self.conv_post = nn.Conv2d(channels, 1, (3, 1), padding=(1, 0))

    def forward(self, wav: torch.Tensor):
        with torch.no_grad():
            spec = stft(wav, self.stft_cfg)
        # the reference's floor: sqrt(clamp(|s|^2, 1e-7)) (audio_torch.py:29)
        h = torch.sqrt(torch.clamp(torch.sum(torch.square(spec), dim=-1), min=1e-7))[..., None]
        fmap = []
        for conv in self.convs:
            h = disc._lrelu(conv(h))
            fmap.append(h)
        h = self.conv_post(h)
        fmap.append(h)
        return h[:, 0], fmap


class MultiSpecDiscriminator(nn.Module):
    """Three resolutions (hifigan.py:565-611): [B, T] -> ([logits], [feature maps])."""

    def __init__(self, fft_sizes: Sequence[int] = (1024, 2048, 512),
                 hop_sizes: Sequence[int] = (120, 240, 50),
                 win_lengths: Sequence[int] = (600, 1200, 240), channels: int = 15,
                 init_kernel: int = 1):
        super().__init__()
        self.discs = []
        for i, (nf, hp, wl) in enumerate(zip(fft_sizes, hop_sizes, win_lengths)):
            d = SpecDiscriminator(channels=channels, init_kernel=init_kernel, fft_size=nf,
                                  shift_size=hp, win_length=wl)
            self.add_module(f"spec{i}", d)
            self.discs.append(d)

    def forward(self, wav: torch.Tensor):
        out = [d(wav) for d in self.discs]
        return [o[0] for o in out], [o[1] for o in out]
