"""HiFi-GAN vocoder generator (mel -> waveform), NCW.

Port of use_tpu/models/gan/hifigan_vocoder.py (reference
hifigan.py:24-199, layers.py:53-286): dual-path upsampling (a repeat
upsample and its conv, plus a transposed conv, summed), banks of
multi-kernel, multi-dilation residual blocks averaged a stage, optional
causal convolutions and the optional NSF harmonic-plus-noise source.

Parameters are named as use_tpu's Flax scopes, the wrapped convs under
Flax's automatic names (``conv_pre.Conv_0.weight``,
``transpose_up0.ConvTranspose_0.weight``); weights are drawn by
discriminators.reset_parameters from ``seed``. Flax's ConvTranspose is
lax.conv_transpose, which correlates the dilated input with the kernel as
given: torch's conv_transpose1d flips it, so engine/convert_jax.py
flips the taps (``hifigan_generator_params_to_state_dict``).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from use_tpu_torch.models.gan.discriminators import reset_parameters
from use_tpu_torch.models.registry import GeneratorRegistry


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


class Conv1dC(nn.Module):
    """1-D conv (layers.py:53-91): causal mode left-pads (k - 1) * dilation,
    else (k - 1) * dilation // 2 a side."""

    def __init__(self, in_channels: int, features: int, kernel_size: int, dilation: int = 1,
                 causal: bool = True):
        super().__init__()
        self.pad = (kernel_size - 1) * dilation
        self.causal = causal
        self.Conv_0 = nn.Conv1d(in_channels, features, kernel_size, dilation=dilation,
                                padding=0 if causal else self.pad // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.causal:
            x = F.pad(x, (self.pad, 0))
        return self.Conv_0(x)


class ConvTranspose1dC(nn.Module):
    """Transposed conv, output (T - 1) * stride + k, then trimmed by
    k - stride (layers.py:126-166): from the tail when causal, else
    (k - stride) // 2 from the head and the rest from the tail."""

    def __init__(self, in_channels: int, features: int, kernel_size: int, stride: int,
                 causal: bool = True):
        super().__init__()
        self.trim = kernel_size - stride
        self.causal = causal
        self.ConvTranspose_0 = nn.ConvTranspose1d(in_channels, features, kernel_size,
                                                  stride=stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.ConvTranspose_0(x)
        if self.trim <= 0:
            return y
        head = 0 if self.causal else self.trim // 2
        return y[..., head:y.shape[-1] - (self.trim - head)]


class ResidualBlock(nn.Module):
    """(layers.py:170-226): per dilation, lrelu, the dilated conv, lrelu, a
    conv, plus the input."""

    def __init__(self, channels: int, kernel_size: int = 3, dilation: Sequence[int] = (1, 3, 5),
                 causal: bool = True):
        super().__init__()
        self.pairs = []
        for i, d in enumerate(dilation):
            c1 = Conv1dC(channels, channels, kernel_size, d, causal)
            c2 = Conv1dC(channels, channels, kernel_size, 1, causal)
            self.add_module(f"conv1_{i}", c1)
            self.add_module(f"conv2_{i}", c2)
            self.pairs.append((c1, c2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2 in self.pairs:
            x = c2(_lrelu(c1(_lrelu(x)))) + x
        return x


class SourceModule(nn.Module):
    """NSF harmonic-plus-noise excitation (layers.py:229-283): pitch and
    voicing [B, 1, frames] -> excitation [B, 1, frames * upsample_ratio].
    use_tpu draws the harmonics' phases and the noise from jax.random; the
    port draws them from `generator` (``draw``), or takes them as `draws`."""

    def __init__(self, nb_harmonics: int, upsample_ratio: int, sampling_rate: int,
                 alpha: float = 0.1, sigma: float = 0.003):
        super().__init__()
        self.nb_harmonics, self.upsample_ratio = nb_harmonics, upsample_ratio
        self.sampling_rate, self.alpha, self.sigma = sampling_rate, alpha, sigma
        self.ffn = nn.Conv1d(nb_harmonics + 1, 1, 1)

    def draw(self, batch: int, samples: int, device: torch.device,
             generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (phase [B, H, 1], uniform in [-pi, pi) with the fundamental's 0;
        noise [B, H, samples], N(0, 1)), H = nb_harmonics + 1."""
        h = self.nb_harmonics + 1
        phase = (torch.rand((batch, h, 1), generator=generator, device=device) * 2 - 1) * math.pi
        phase[:, 0] = 0.0
        return phase, torch.randn((batch, h, samples), generator=generator, device=device)

    def forward(self, pitch: torch.Tensor, uv: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        r = self.upsample_ratio
        pitch_s = torch.repeat_interleave(pitch, r, dim=-1)
        uv_s = torch.repeat_interleave(uv, r, dim=-1)
        harmonics = torch.arange(1, self.nb_harmonics + 2, dtype=pitch.dtype,
                                 device=pitch.device)
        f_mat = pitch_s * harmonics[None, :, None] / self.sampling_rate  # [B, H, T]
        # the phase accumulated in float64: in float32 a 6 s sum reaches
        # ~1e4 cycles, where a cycle keeps ~1e-3 of its value, and the
        # phase would follow the device's summation order (use_tpu sums in
        # float32; on a short clip the two agree to float32 rounding)
        cycles = torch.remainder(torch.cumsum(f_mat.double(), dim=-1), 1.0).to(f_mat.dtype)
        theta = 2 * np.pi * cycles
        if draws is None:
            draws = self.draw(pitch.shape[0], f_mat.shape[-1], pitch.device, generator)
        phase, noise = draws
        noise = self.sigma * noise
        e_voice = self.alpha * torch.sin(theta + phase) + noise
        e_unvoice = self.alpha / 3 / self.sigma * noise
        e = (e_voice * uv_s + e_unvoice * (1 - uv_s)).detach()
        return torch.tanh(self.ffn(e))


class HifiganGenerator(nn.Module):
    """(hifigan.py:24-199): mel [B, in_channels, frames] (with NSF, pitch
    and voicing as two more channels) -> wav [B, frames * prod(upsample_scales)]
    ([B, out_channels, ...] where out_channels > 1)."""

    shards_plain_convs = True  # parallel/sharding.py may cut its convs on the 'model' axis

    def __init__(self, in_channels: int = 80, out_channels: int = 1, channels: int = 512,
                 kernel_size: int = 7, upsample_scales: Sequence[int] = (8, 8, 2, 2),
                 upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4),
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilations: Sequence[Sequence[int]] = ((1, 3, 5),) * 3,
                 causal: bool = True, use_conv_post: bool = True, use_out_tanh: bool = True,
                 nsf_params: Optional[dict] = None, seed: int = 0):
        super().__init__()
        self.out_channels, self.use_out_tanh = out_channels, use_out_tanh
        self.nsf = nsf_params is not None
        if self.nsf:
            self.source_module = SourceModule(
                nb_harmonics=nsf_params["nb_harmonics"],
                upsample_ratio=int(np.prod(upsample_scales)),
                sampling_rate=nsf_params["sampling_rate"])
        self.conv_pre = Conv1dC(in_channels, channels, kernel_size, 1, causal)
        self.stages = []
        in_ch = channels
        for i, (scale, k_up) in enumerate(zip(upsample_scales, upsample_kernel_sizes)):
            ch = channels // (2 ** (i + 1))
            rep = Conv1dC(in_ch, ch, kernel_size, 1, causal)
            up = ConvTranspose1dC(in_ch, ch, k_up, scale, causal)
            self.add_module(f"repeat_up{i}", rep)
            self.add_module(f"transpose_up{i}", up)
            down = None
            if self.nsf:
                # the excitation at this stage's rate (hifigan.py:126-145):
                # a stride-u conv of kernel 2u
                u = int(np.prod(upsample_scales[i + 1:]))
                down = (nn.Conv1d(1, ch, u * 2, stride=u, padding=u // 2) if u > 1
                        else nn.Conv1d(1, ch, 1))
                self.add_module(f"source_down{i}", down)
            blocks = []
            for j, (rk, rd) in enumerate(zip(resblock_kernel_sizes, resblock_dilations)):
                blocks.append(ResidualBlock(ch, rk, rd, causal))
                self.add_module(f"resblock{i}_{j}", blocks[-1])
            self.stages.append((scale, rep, up, down, blocks))
            in_ch = ch
        self.conv_post = (Conv1dC(in_ch, out_channels, kernel_size, 1, causal)
                          if use_conv_post else None)
        reset_parameters(self, torch.Generator().manual_seed(seed))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                source_draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
        """x -> wav; with NSF, the source's draws come from `generator`
        unless given as `source_draws` (SourceModule.draw's layout)."""
        if self.nsf:
            mel, pitch, uv = x[:, :-2], x[:, -2:-1], x[:, -1:]
            excitation = self.source_module(pitch, uv, generator, source_draws)
        else:
            mel = x
        h = self.conv_pre(mel)
        for scale, rep_conv, up_conv, down, blocks in self.stages:
            h = torch.sin(h) + h  # hifigan.py:159
            rep = rep_conv(_lrelu(torch.repeat_interleave(h, scale, dim=-1)))
            up = up_conv(_lrelu(h))
            h = rep + up[..., :rep.shape[-1]]
            if down is not None:
                h = h + down(excitation)[..., :h.shape[-1]]
            h = sum(block(h) for block in blocks) / len(blocks)
        # the reference's final activation takes F.leaky_relu's default slope
        # 0.01, not the 0.1 of every other (hifigan.py:178)
        h = F.leaky_relu(h, 0.01)
        if self.conv_post is not None:
            h = self.conv_post(h)
        if self.use_out_tanh:
            h = torch.tanh(h)
        return h[:, 0] if self.out_channels == 1 else h


GeneratorRegistry.register("hifigan_generator")(HifiganGenerator)
