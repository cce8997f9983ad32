"""Conv-TasNet: time-domain encoder / TCN mask / decoder backbone.

Port of use_tpu/models/convtasnet.py (reference
src/models/components/sgmse/backbones/convtasnet.py:14-112 and
convtasnet_utils/utils.py): a strided conv encoder, a dilated TCN giving a
sigmoid mask over the learned basis, a transposed-conv decoder with
overlap-add. Non-causal by default (gLN, symmetric padding); causal mode
pads on the left and normalizes with the cumulative layer norm.

Layout: waveforms [B, L]; encoder features [B, N, T]. Submodules carry
use_tpu's scope names (``encoder``, ``TCN.tcn_s0_l3``, Flax's ``Conv_0``,
``PReLU_0``, ``_Norm_0.GroupNorm_0`` / ``_Norm_0.CumLN1d_0``); weights are
drawn from ``seed`` as Flax initializes them. The decoder is a Flax
ConvTranspose in use_tpu (no kernel flip): engine/convert_jax.py::
convtasnet_params_to_state_dict flips its taps for torch's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from use_tpu_torch.models.gan.csmgan import CumLN1d, _prelu
from use_tpu_torch.models.gan.discriminators import reset_parameters
from use_tpu_torch.models.ncsnpp.normalization import FlaxGroupNorm
from use_tpu_torch.models.registry import BackboneRegistry

GLN_EPS = 1e-8  # Flax GroupNorm(num_groups=1, epsilon=1e-8): the variance E[x^2] - E[x]^2


class _Norm(nn.Module):
    """gLN (one group over C and T) or the causal cumulative layer norm."""

    def __init__(self, channels: int, causal: bool):
        super().__init__()
        self.name = "CumLN1d_0" if causal else "GroupNorm_0"
        self.add_module(self.name, CumLN1d(channels) if causal
                        else FlaxGroupNorm(1, channels, GLN_EPS))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, self.name)(x)


class DepthConv1d(nn.Module):
    """(convtasnet_utils/utils.py DepthConv1d): 1x1 conv, PReLU, norm, a
    dilated depthwise conv, PReLU, norm, then residual and skip 1x1 convs."""

    def __init__(self, input_channel: int, hidden_channel: int, kernel: int = 3,
                 dilation: int = 1, causal: bool = False, skip: bool = True):
        super().__init__()
        self.pad = (kernel - 1) * dilation
        self.causal, self.skip = causal, skip
        self.Conv_0 = nn.Conv1d(input_channel, hidden_channel, 1)
        self.PReLU_0 = _prelu()
        self._Norm_0 = _Norm(hidden_channel, causal)
        self.Conv_1 = nn.Conv1d(hidden_channel, hidden_channel, kernel, dilation=dilation,
                                groups=hidden_channel)
        self.PReLU_1 = _prelu()
        self._Norm_1 = _Norm(hidden_channel, causal)
        self.Conv_2 = nn.Conv1d(hidden_channel, input_channel, 1)
        if skip:
            self.Conv_3 = nn.Conv1d(hidden_channel, input_channel, 1)

    def forward(self, x: torch.Tensor):
        h = self._Norm_0(self.PReLU_0(self.Conv_0(x)))
        p = self.pad
        h = F.pad(h, (p, 0) if self.causal else (p // 2, p - p // 2))
        h = self._Norm_1(self.PReLU_1(self.Conv_1(h)))
        return self.Conv_2(h), (self.Conv_3(h) if self.skip else None)


class TasTCN(nn.Module):
    """(convtasnet_utils/utils.py TCN): norm, bottleneck, `stack` stacks of
    `layer` blocks with dilation 2 ** i restarting each stack, the skip
    outputs summed (or the residual stream), PReLU, output 1x1 conv."""

    def __init__(self, input_dim: int, output_dim: int, bn_dim: int, hidden_dim: int,
                 layer: int = 8, stack: int = 3, kernel: int = 3, causal: bool = False,
                 skip: bool = True):
        super().__init__()
        self.skip = skip
        self._Norm_0 = _Norm(input_dim, causal)
        self.Conv_0 = nn.Conv1d(input_dim, bn_dim, 1)
        self.blocks = []
        for s in range(stack):
            for i in range(layer):
                block = DepthConv1d(bn_dim, hidden_dim, kernel, 2 ** i, causal, skip)
                self.add_module(f"tcn_s{s}_l{i}", block)
                self.blocks.append(block)
        self.PReLU_0 = _prelu()
        self.Conv_1 = nn.Conv1d(bn_dim, output_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.Conv_0(self._Norm_0(x))
        skip_sum = 0.0
        for block in self.blocks:
            res, skip = block(h)
            h = h + res
            if self.skip:
                skip_sum = skip_sum + skip
        return self.Conv_1(self.PReLU_0(skip_sum if self.skip else h))


class ConvTasNet(nn.Module):
    """Waveform [B, L] -> enhanced waveform [B, L] (convtasnet.py:14-112).
    The window is int(fs * win_ms / 1000) samples (32 at 16 kHz, 48 at
    24 kHz), the stride half of it."""

    shards_plain_convs = True  # parallel/sharding.py may cut its convs on the 'model' axis

    def __init__(self, fs: int = 16000, win_ms: float = 2.0, enc_dim: int = 256,
                 feature_dim: int = 128, layer: int = 8, stack: int = 3, kernel: int = 3,
                 causal: bool = False, seed: int = 0):
        super().__init__()
        self.win = int(fs * win_ms / 1000)
        self.stride = self.win // 2
        self.encoder = nn.Conv1d(1, enc_dim, self.win, stride=self.stride, bias=False)
        self.TCN = TasTCN(enc_dim, enc_dim, feature_dim, feature_dim * 4, layer, stack, kernel,
                          causal=causal)
        self.decoder = nn.ConvTranspose1d(enc_dim, 1, self.win, stride=self.stride, bias=False)
        reset_parameters(self, torch.Generator().manual_seed(seed))

    def forward(self, x: torch.Tensor, time_cond=None, *, train: bool = False) -> torch.Tensor:
        win, stride = self.win, self.stride
        nsample = x.shape[-1]
        rest = (win - (stride + nsample % win) % win) % win
        enc = self.encoder(F.pad(x, (stride, rest + stride))[:, None])  # [B, N, T]
        masked = enc * torch.sigmoid(self.TCN(enc))
        out = self.decoder(masked)[:, 0]
        # the aux / rest padding trimmed back to the input length
        return out[:, stride : stride + nsample]


BackboneRegistry.register("convtasnet")(ConvTasNet)
