"""GaGNet: glance (magnitude) + gaze (complex) two-stage enhancement net.

Port of use_tpu/models/gagnet.py (reference
src/models/components/sgmse/backbones/gagnet.py:13-851): a U^2 (or plain
U-Net) encoder over the spectrum with gated convs, then q GlanceGaze
modules, each predicting a magnitude gain (glance) and a complex residual
(gaze) from squeezed TCN groups, and a final tanh complex mask multiplied
into the input spectrum.

Layout: the 2-D stages run on [B, C, T, F] (time the causal axis, on dim
2), so use_tpu's HWIO kernels are OIHW here with H = T and W = F; the TCN
heads on [B, C, T]. use_tpu flattens the encoder's [B, T, F', C] output
with C fastest and the spectrum's [B, T, F, 2] with real / imag fastest
before the heads' input convs: the port permutes to the same order before
it flattens. The backbone interface is use_tpu's: [B, F, T, 2] in,
[B, F, T, 1, 2] out.

use_tpu's transposed convs are Flax ConvTranspose (lax.conv_transpose, no
kernel flip): engine/convert_jax.py flips their taps for torch's
ConvTranspose2d. Submodules carry use_tpu's scope names (``en.u0.enco0``,
``gag0.glance.in_main``, Flax's ``Conv_0``, ``NormSwitch_1``); weights are
drawn from ``seed`` as Flax initializes them. The heads' widths follow the
input's frequency bins, as in use_tpu: they are built at the first forward
(or ``materialize(freqs)``), from the same seeded generator.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from use_tpu_torch.models.gan.discriminators import reset_parameters
from use_tpu_torch.models.registry import BackboneRegistry


class PReLUC(nn.Module):
    """Per-channel PReLU over dim 1 (torch nn.PReLU(c)), slope init 0.25."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((channels,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.alpha.reshape((1, -1) + (1,) * (x.dim() - 2))
        return torch.where(x >= 0, x, a * x)


def instance_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm(affine=True) over every axis after dim 1 of [B, C, ...]:
    biased variance, rsqrt."""
    if x.numel() == 0:  # the plain encoder's width-0 output (GateConv2d)
        return x
    dims = tuple(range(2, x.dim()))
    var, mean = torch.var_mean(x, dim=dims, keepdim=True, unbiased=False)
    shape = (1, -1) + (1,) * len(dims)
    return (x - mean) * torch.rsqrt(var + eps) * weight.reshape(shape) + bias.reshape(shape)


class NormSwitch(nn.Module):
    """IN with affine (gagnet.py:670-697; BN mapped to IN): statistics over
    all of T (and F), so the TCMs' norms see the future even when causal."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x, self.weight, self.bias)


class GateConv2d(nn.Module):
    """Causal gated conv (gagnet.py:613-646): time padded (k_t - 1) on the
    left, a VALID conv to 2C, value times sigmoid(gate)."""

    def __init__(self, cin: int, features: int, kernel_size: Tuple[int, int],
                 strides: Tuple[int, int]):
        super().__init__()
        self.kt = kernel_size[0]
        self.Conv_0 = nn.Conv2d(cin, 2 * features, kernel_size, stride=strides)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kt > 1:
            x = F.pad(x, (0, 0, self.kt - 1, 0))
        if x.shape[3] < self.Conv_0.kernel_size[1]:
            # XLA's VALID conv over fewer bins than its kernel gives no bins
            # (use_tpu's plain encoder at F 33 ends at width 0); torch's raises
            b, _, t, _ = x.shape
            return x.new_zeros((b, self.Conv_0.out_channels // 2, t - self.kt + 1, 0))
        out, g = torch.chunk(self.Conv_0(x), 2, dim=1)
        return out * torch.sigmoid(g)


class Conv2dUnit(nn.Module):
    """Conv (1, 2)-strided, then PReLU(norm) (gagnet.py:574-590)."""

    def __init__(self, cin: int, k: Tuple[int, int], c: int):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, c, k, stride=(1, 2))
        self.NormSwitch_0 = NormSwitch(c)
        self.PReLUC_0 = PReLUC(c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.PReLUC_0(self.NormSwitch_0(self.Conv_0(x)))


class Deconv2dUnit(nn.Module):
    """Transposed conv (1, 2)-strided, VALID, then PReLU(norm)
    (gagnet.py:593-610)."""

    def __init__(self, cin: int, k: Tuple[int, int], c: int):
        super().__init__()
        self.ConvTranspose_0 = nn.ConvTranspose2d(cin, c, k, stride=(1, 2))
        self.NormSwitch_0 = NormSwitch(c)
        self.PReLUC_0 = PReLUC(c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.PReLUC_0(self.NormSwitch_0(self.ConvTranspose_0(x)))


class EnUnetModule(nn.Module):
    """Recursive intra-block U-Net over frequency (gagnet.py:517-571). Each
    level's conv and transposed conv return the width they started from
    only while every width stays odd; elsewhere the residual's add fails,
    as use_tpu's does."""

    def __init__(self, cin: int, cout: int, k1: Tuple[int, int], k2: Tuple[int, int],
                 intra_connect: str = "cat", scale: int = 1):
        super().__init__()
        self.intra_connect, self.scale = intra_connect, scale
        self.GateConv2d_0 = GateConv2d(cin, cout, k1, (1, 2))
        self.NormSwitch_0 = NormSwitch(cout)
        self.PReLUC_0 = PReLUC(cout)
        for i in range(scale):
            self.add_module(f"enco{i}", Conv2dUnit(cout, k2, cout))
        for i in range(scale):
            cin_i = cout if i == 0 or intra_connect == "add" else 2 * cout
            self.add_module(f"deco{i}", Deconv2dUnit(cin_i, k2, cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.PReLUC_0(self.NormSwitch_0(self.GateConv2d_0(x)))
        x_resi = x
        xs = []
        for i in range(self.scale):
            x = getattr(self, f"enco{i}")(x)
            xs.append(x)
        for i in range(self.scale):
            if i > 0:
                skip = xs[-(i + 1)]
                x = x + skip if self.intra_connect == "add" else torch.cat([x, skip], dim=1)
            x = getattr(self, f"deco{i}")(x)
        return x_resi + x


ENCODER_OUT = 64  # the encoders' last gated conv's channels


class U2NetEncoder(nn.Module):
    """(gagnet.py:430-463): four intra-U-Nets of depth 4, 3, 2, 1, then a
    gated conv to ENCODER_OUT channels; the frequency halves five times."""

    def __init__(self, cin: int, k1: Tuple[int, int], k2: Tuple[int, int], c: int,
                 intra_connect: str):
        super().__init__()
        self.u0 = EnUnetModule(cin, c, (2, 5), k2, intra_connect, scale=4)
        self.u1 = EnUnetModule(c, c, k1, k2, intra_connect, scale=3)
        self.u2 = EnUnetModule(c, c, k1, k2, intra_connect, scale=2)
        self.u3 = EnUnetModule(c, c, k1, k2, intra_connect, scale=1)
        self.last_gate = GateConv2d(c, ENCODER_OUT, k1, (1, 2))
        self.NormSwitch_0 = NormSwitch(ENCODER_OUT)
        self.PReLUC_0 = PReLUC(ENCODER_OUT)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.u3(self.u2(self.u1(self.u0(x))))
        return self.PReLUC_0(self.NormSwitch_0(self.last_gate(x)))


class UNetEncoder(nn.Module):
    """(gagnet.py:466-515): five gated convs, each PReLU(norm)."""

    def __init__(self, cin: int, k1: Tuple[int, int], c: int):
        super().__init__()
        specs = [((2, 5), c), (k1, c), (k1, c), (k1, c), (k1, ENCODER_OUT)]
        self.n = len(specs)
        for i, (k, co) in enumerate(specs):
            self.add_module(f"gate{i}", GateConv2d(cin, co, k, (1, 2)))
            self.add_module(f"NormSwitch_{i}", NormSwitch(co))
            self.add_module(f"PReLUC_{i}", PReLUC(co))
            cin = co

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"gate{i}")(x)
            x = getattr(self, f"PReLUC_{i}")(getattr(self, f"NormSwitch_{i}")(x))
        return x


class SqueezedTCM(nn.Module):
    """Squeezed dilated TCN block over [B, C, T] (gagnet.py:388-427):
    norm(PReLU(h)) after each of its first two convs (the other blocks
    compute PReLU(norm(x)))."""

    def __init__(self, kd1: int, cd1: int, d_feat: int, dilation: int, causal: bool = True):
        super().__init__()
        self.pad = (kd1 - 1) * dilation
        self.causal = causal
        self.Conv_0 = nn.Conv1d(d_feat, cd1, 1, bias=False)
        self.PReLUC_0 = PReLUC(cd1)
        self.NormSwitch_0 = NormSwitch(cd1)
        self.Conv_1 = nn.Conv1d(cd1, cd1, kd1, dilation=dilation, bias=False)
        self.PReLUC_1 = PReLUC(cd1)
        self.NormSwitch_1 = NormSwitch(cd1)
        self.Conv_2 = nn.Conv1d(cd1, d_feat, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.NormSwitch_0(self.PReLUC_0(self.Conv_0(x)))
        p = self.pad
        h = F.pad(h, (p, 0) if self.causal else (p // 2, p - p // 2))
        h = self.NormSwitch_1(self.PReLUC_1(self.Conv_1(h)))
        return self.Conv_2(h) + x


class SqueezedTCNGroup(nn.Module):
    def __init__(self, kd1: int, cd1: int, d_feat: int, dilas: Sequence[int], causal: bool):
        super().__init__()
        self.blocks = []
        for i, d in enumerate(dilas):
            block = SqueezedTCM(kd1, cd1, d_feat, d, causal)
            self.add_module(f"tcm{i}", block)
            self.blocks.append(block)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return x


class _GatedInput(nn.Module):
    """The heads' input: conv(x) * sigmoid(conv_gate(x)), 1x1 over [B, C, T]."""

    def __init__(self, cin: int, d_feat: int):
        super().__init__()
        self.in_main = nn.Conv1d(cin, d_feat, 1)
        self.in_gate = nn.Conv1d(cin, d_feat, 1)

    def gated_input(self, inpt: torch.Tensor) -> torch.Tensor:
        return self.in_main(inpt) * torch.sigmoid(self.in_gate(inpt))


_ACTS = {"sigmoid": torch.sigmoid, "tanh": torch.tanh, "relu": F.relu}


class GlanceBlock(_GatedInput):
    """Magnitude gain head (gagnet.py:241-294): [B, C, T] -> [B, F, T]."""

    def __init__(self, cin: int, kd1: int, cd1: int, d_feat: int, p: int,
                 dilas: Sequence[int], freqs: int, causal: bool, acti_type: str = "sigmoid"):
        super().__init__(cin, d_feat)
        self.acti = _ACTS[acti_type]
        self.groups = []
        for i in range(p):
            group = SqueezedTCNGroup(kd1, cd1, d_feat, dilas, causal)
            self.add_module(f"tcn{i}", group)
            self.groups.append(group)
        self.linear_g = nn.Conv1d(d_feat, freqs, 1)

    def forward(self, inpt: torch.Tensor) -> torch.Tensor:
        x = self.gated_input(inpt)
        for group in self.groups:
            x = group(x)
        return self.acti(self.linear_g(x))


class GazeBlock(_GatedInput):
    """Complex residual head (gagnet.py:297-358): [B, C, T] -> ([B, F, T]
    real, [B, F, T] imaginary); separate real and imaginary TCN groups, or
    one shared when squeezed."""

    def __init__(self, cin: int, kd1: int, cd1: int, d_feat: int, p: int,
                 dilas: Sequence[int], freqs: int, causal: bool, is_squeezed: bool = False):
        super().__init__(cin, d_feat)
        self.p, self.is_squeezed = p, is_squeezed
        names = ("tcn_ri",) if is_squeezed else ("tcn_r", "tcn_i")
        for i in range(p):
            for name in names:
                self.add_module(f"{name}{i}",
                                SqueezedTCNGroup(kd1, cd1, d_feat, dilas, causal))
        self.linear_r = nn.Conv1d(d_feat, freqs, 1)
        self.linear_i = nn.Conv1d(d_feat, freqs, 1)

    def forward(self, inpt: torch.Tensor):
        x = self.gated_input(inpt)
        if self.is_squeezed:
            for i in range(self.p):
                x = getattr(self, f"tcn_ri{i}")(x)
            xr = xi = x
        else:
            xr = xi = x
            for i in range(self.p):
                xr = getattr(self, f"tcn_r{i}")(xr)
                xi = getattr(self, f"tcn_i{i}")(xi)
        return self.linear_r(xr), self.linear_i(xi)


class GlanceGazeModule(nn.Module):
    """One GGM stage (gagnet.py:188-238): feat [B, C1, T] and the previous
    estimate [B, T, F, 2] -> [B, T, F, 2]."""

    def __init__(self, feat_channels: int, kd1: int, cd1: int, d_feat: int, p: int,
                 dilas: Sequence[int], freqs: int, causal: bool, is_squeezed: bool,
                 acti_type: str):
        super().__init__()
        cin = feat_channels + 2 * freqs
        self.glance = GlanceBlock(cin, kd1, cd1, d_feat, p, dilas, freqs, causal, acti_type)
        self.gaze = GazeBlock(cin, kd1, cd1, d_feat, p, dilas, freqs, causal, is_squeezed)

    def forward(self, feat: torch.Tensor, pre: torch.Tensor) -> torch.Tensor:
        b, t, f, _ = pre.shape
        # use_tpu's pre.reshape(b, t, f * 2): real / imag fastest
        pre_flat = pre.reshape(b, t, f * 2).transpose(1, 2)
        inpt = torch.cat([feat, pre_flat], dim=1)
        gain = self.glance(inpt).transpose(1, 2)  # [B, T, F]
        r, i = (h.transpose(1, 2) for h in self.gaze(inpt))
        mag = torch.sqrt(torch.sum(pre ** 2, dim=-1) + 1e-12)
        phase = torch.atan2(pre[..., 1], pre[..., 0])
        filtered = mag * gain
        return torch.stack([filtered * torch.cos(phase) + r, filtered * torch.sin(phase) + i],
                           dim=-1)


class GaGNet(nn.Module):
    """Full GaGNet (gagnet.py:14-185); backbone interface [B, F, T, 2] ->
    [B, F, T, 1, 2]. An even F gets one zero bin on top for the encoder,
    stripped after the last stage. fft_num, norm_type and input_channels
    are accepted and unused, as in use_tpu (the bins come from the input)."""

    shards_plain_convs = True  # parallel/sharding.py may cut its convs on the 'model' axis

    def __init__(self, cin: int = 2, k1: Tuple[int, int] = (2, 3), k2: Tuple[int, int] = (1, 3),
                 c: int = 64, kd1: int = 3, cd1: int = 64, d_feat: int = 256, p: int = 2,
                 q: int = 3, dilas: Sequence[int] = (1, 2, 5, 9), fft_num: int = 320,
                 is_u2: bool = True, causal: bool = True, is_squeezed: bool = False,
                 acti_type: str = "sigmoid", intra_connect: str = "cat", norm_type: str = "IN",
                 input_channels: int = 2, seed: int = 0):
        super().__init__()
        self.head_args = (kd1, cd1, d_feat, p, tuple(dilas), causal, is_squeezed, acti_type)
        self.q, self.kf = q, k1[1]
        self.en = (U2NetEncoder(cin, tuple(k1), tuple(k2), c, intra_connect) if is_u2
                   else UNetEncoder(cin, tuple(k1), c))
        generator = torch.Generator().manual_seed(seed)
        reset_parameters(self, generator)
        self._head_draws = generator.get_state()  # where the stages' weights are drawn from
        self.freqs: Optional[int] = None

    def materialize(self, freqs: int) -> None:
        """Build the q stages for `freqs` (padded, odd) bins, on the
        encoder's device, with weights from the seeded generator."""
        ff = freqs
        for k in (5, self.kf, self.kf, self.kf, self.kf):  # the encoders' (1, 2)-strided convs
            ff = (ff - k) // 2 + 1
        kd1, cd1, d_feat, p, dilas, causal, is_squeezed, acti_type = self.head_args
        stages = [GlanceGazeModule(ENCODER_OUT * ff, kd1, cd1, d_feat, p, dilas, freqs,
                                   causal, is_squeezed, acti_type) for _ in range(self.q)]
        dev = next(self.en.parameters()).device
        generator = torch.Generator()
        generator.set_state(self._head_draws)
        for i, stage in enumerate(stages):
            reset_parameters(stage, generator)
            self.add_module(f"gag{i}", stage.to(dev))
        self.freqs = freqs

    def forward(self, x: torch.Tensor, time_cond=None, *, train: bool = False) -> torch.Tensor:
        spec = x.permute(0, 2, 1, 3)  # [B, T, F, 2]
        f = x.shape[1]
        padded = f % 2 == 0
        spec_in = F.pad(spec, (0, 0, 0, 1)) if padded else spec
        freqs = spec_in.shape[2]
        if self.freqs is None:
            self.materialize(freqs)
        elif self.freqs != freqs:
            raise ValueError(f"GaGNet was built for {self.freqs} (padded) bins, got {freqs}")

        feat = self.en(spec_in.permute(0, 3, 1, 2))  # [B, 64, T, F']
        b, cc, t, ff = feat.shape
        # use_tpu's feat.reshape(b, t, ff * cc) of [B, T, F', C]: C fastest
        z = feat.permute(0, 3, 1, 2).reshape(b, ff * cc, t)
        pre = spec_in
        for i in range(self.q):
            pre = getattr(self, f"gag{i}")(z, pre)
        if padded:
            pre = pre[:, :, :-1, :]
        mask = torch.tanh(pre)
        mr, mi = mask[..., 0], mask[..., 1]
        xr, xi = spec[..., 0], spec[..., 1]
        out = torch.stack([mr * xr - mi * xi, mr * xi + mi * xr], dim=-1)  # [B, T, F, 2]
        return out.permute(0, 2, 1, 3)[:, :, :, None, :]


def make_gagnet(**kwargs) -> GaGNet:
    kwargs.pop("dnn_channels", None)
    return GaGNet(**kwargs)


BackboneRegistry.register("gagnet")(make_gagnet)
