"""NCSNv1 / RefineNet legacy blocks as torch modules (NCHW).

Port of use_tpu/models/ncsnpp/legacy_layers.py (reference
src/models/components/sgmse/backbones/ncsnpp_utils/layers.py:170-560):
CRP / RCU / MSF / Refine blocks, the pool-fused convolutions and the NCSNv1
residual block. The NCSN++ forward does not use them; they are the public
layer surface of the reference's NCSNv1-style backbones.

Conditional variants take a ``normalizer`` factory, ``normalizer(channels)``
-> a conditional norm of models/ncsnpp/normalization.py called as
``norm(x, y)`` with class labels y; the unconditional ones pass None.
Submodules carry use_tpu's Flax scope names (``conv_0``, ``1_1_norm``,
``adapt_0``, ``msf``, ``crp``, ``output``, ``normalize1``, ``conv2.conv``),
so engine/convert_jax.py::flax_params_to_state_dict maps use_tpu's params
by their paths. ``reset_parameters(module, generator)`` redraws every
weight as use_tpu initializes it.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from use_tpu_torch.models.ncsnpp import normalization
from use_tpu_torch.models.ncsnpp.layers import default_init_

Act = Callable[[torch.Tensor], torch.Tensor]
Normalizer = Optional[Callable[[int], nn.Module]]


class Conv(nn.Conv2d):
    """Flax's nn.Conv: a LeCun-normal kernel and zero bias, or with
    `init_scale` the DDPM init (``default_init_``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, padding: int = 0,
                 dilation: int = 1, stride: int = 1, bias: bool = True,
                 init_scale: Optional[float] = None):
        self.init_scale = init_scale
        super().__init__(in_ch, out_ch, kernel, stride=stride, padding=padding,
                         dilation=dilation, bias=bias)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        o, i, kh, kw = self.weight.shape
        if self.init_scale is None:
            std = math.sqrt(1.0 / (i * kh * kw)) / 0.87962566103423978
            nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
        else:
            default_init_(self.weight, self.init_scale, i * kh * kw, o * kh * kw, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


def ncsn_conv3x3(in_planes: int, out_planes: int, stride: int = 1, bias: bool = True,
                 dilation: int = 1, init_scale: float = 1.0) -> Conv:
    """3x3 conv, NCSNv1 init (reference layers.py:121-143)."""
    return Conv(in_planes, out_planes, 3, padding=dilation, dilation=dilation, stride=stride,
                bias=bias, init_scale=init_scale)


def reset_parameters(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Redraw every conv and norm under `module` from `generator`, in
    registration order."""
    for m in module.modules():
        if isinstance(m, Conv):
            m.reset_parameters(generator)
    normalization.reset_parameters(module, generator)


def _pool5(x: torch.Tensor, maxpool: bool) -> torch.Tensor:
    """5x5 stride-1 max / avg pool, SAME padding (layers.py:177-180): max
    pads with -inf, avg divides by the whole window, padding included."""
    if maxpool:
        return F.max_pool2d(x, 5, stride=1, padding=2)
    return F.avg_pool2d(x, 5, stride=1, padding=2, count_include_pad=True)


class CRPBlock(nn.Module):
    """Chained residual pooling (layers.py:170-191)."""

    shards_plain_convs = True  # parallel/sharding.py may cut its convs on the 'model' axis

    def __init__(self, features: int, n_stages: int, act: Act = F.relu, maxpool: bool = True,
                 normalizer: Normalizer = None):
        super().__init__()
        self.act, self.n_stages = act, n_stages
        # the conditional CRP always average-pools (layers.py:204)
        self.maxpool = maxpool and normalizer is None
        self.conditional = normalizer is not None
        for i in range(n_stages):
            if normalizer is not None:
                self.add_module(f"norm_{i}", normalizer(features))
            self.add_module(f"conv_{i}", ncsn_conv3x3(features, features, bias=False))

    def forward(self, x: torch.Tensor, y: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.act(x)
        path = x
        for i in range(self.n_stages):
            if self.conditional:
                path = getattr(self, f"norm_{i}")(path, y)
            path = getattr(self, f"conv_{i}")(_pool5(path, self.maxpool))
            x = path + x
        return x


class RCUBlock(nn.Module):
    """Residual conv unit chain (layers.py:220-246)."""

    shards_plain_convs = True  # parallel/sharding.py may cut its convs on the 'model' axis

    def __init__(self, features: int, n_blocks: int, n_stages: int, act: Act = F.relu,
                 normalizer: Normalizer = None):
        super().__init__()
        self.act, self.n_blocks, self.n_stages = act, n_blocks, n_stages
        self.conditional = normalizer is not None
        for i in range(n_blocks):
            for j in range(n_stages):
                if normalizer is not None:
                    self.add_module(f"{i + 1}_{j + 1}_norm", normalizer(features))
                self.add_module(f"{i + 1}_{j + 1}_conv",
                                ncsn_conv3x3(features, features, bias=False))

    def forward(self, x: torch.Tensor, y: Optional[torch.Tensor] = None) -> torch.Tensor:
        for i in range(self.n_blocks):
            residual = x
            for j in range(self.n_stages):
                if self.conditional:
                    x = getattr(self, f"{i + 1}_{j + 1}_norm")(x, y)
                x = getattr(self, f"{i + 1}_{j + 1}_conv")(self.act(x))
            x = x + residual
        return x


def _bilinear_resize(x: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """align_corners=True bilinear (as F.interpolate, layers.py:295): the
    sample positions are linspace(0, size - 1, new), interpolated between
    their two neighbours, rows last."""
    h, w = x.shape[2:]
    nh, nw = shape
    rows = torch.linspace(0.0, h - 1.0, nh, device=x.device)
    cols = torch.linspace(0.0, w - 1.0, nw, device=x.device)
    r0, c0 = rows.floor().long(), cols.floor().long()
    r1, c1 = torch.clamp(r0 + 1, max=h - 1), torch.clamp(c0 + 1, max=w - 1)
    fr = (rows - r0).to(x.dtype)[:, None]
    fc = (cols - c0).to(x.dtype)
    top = x[:, :, r0][..., c0] * (1 - fc) + x[:, :, r0][..., c1] * fc
    bot = x[:, :, r1][..., c0] * (1 - fc) + x[:, :, r1][..., c1] * fc
    return top * (1 - fr) + bot * fr


class MSFBlock(nn.Module):
    """Multi-scale fusion: a conv per input, bilinear resize, sum
    (layers.py:283-300)."""

    shards_plain_convs = True  # parallel/sharding.py may cut its convs on the 'model' axis

    def __init__(self, in_planes: Sequence[int], features: int, normalizer: Normalizer = None):
        super().__init__()
        self.n_inputs = len(in_planes)
        self.conditional = normalizer is not None
        for i, p in enumerate(in_planes):
            if normalizer is not None:
                self.add_module(f"norm_{i}", normalizer(p))
            self.add_module(f"conv_{i}", ncsn_conv3x3(p, features, bias=True))

    def forward(self, xs: Sequence[torch.Tensor], shape: Tuple[int, int],
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        assert len(xs) == self.n_inputs
        out = None
        for i, h in enumerate(xs):
            if self.conditional:
                h = getattr(self, f"norm_{i}")(h, y)
            h = _bilinear_resize(getattr(self, f"conv_{i}")(h), shape)
            out = h if out is None else out + h
        return out


class RefineBlock(nn.Module):
    """RefineNet block: RCU adapters -> MSF -> CRP -> output RCU
    (layers.py:330-360)."""

    shards_plain_convs = True  # parallel/sharding.py may cut its convs on the 'model' axis

    def __init__(self, in_planes: Sequence[int], features: int, act: Act = F.relu,
                 start: bool = False, end: bool = False, maxpool: bool = True,
                 normalizer: Normalizer = None):
        super().__init__()
        self.adapt = []
        for i, p in enumerate(in_planes):
            block = RCUBlock(p, 2, 2, act, normalizer)
            self.add_module(f"adapt_{i}", block)
            self.adapt.append(block)
        # MSF's convs take the adapters' outputs, which keep each input's width
        self.msf = MSFBlock(in_planes, features, normalizer) if len(in_planes) > 1 else None
        self.crp = CRPBlock(features, 2, act, maxpool, normalizer)
        self.output = RCUBlock(features, 3 if end else 1, 2, act, normalizer)

    def forward(self, xs: Sequence[torch.Tensor], output_shape: Tuple[int, int],
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        hs = [block(x, y) for block, x in zip(self.adapt, xs)]
        h = self.msf(hs, output_shape, y) if self.msf is not None else hs[0]
        return self.output(self.crp(h, y), y)


def _mean_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """Sum of the four 2x2 phases / 4 (layers.py:419-431)."""
    return (x[:, :, ::2, ::2] + x[:, :, 1::2, ::2] + x[:, :, ::2, 1::2]
            + x[:, :, 1::2, 1::2]) / 4.0


class ConvMeanPool(nn.Module):
    """Conv, then a 2x mean pool (layers.py:404-431). adjust_padding pads
    one row and column on the top and left, then pads no more (k 3: VALID;
    k 1: k // 2 = 0)."""

    shards_plain_convs = True  # parallel/sharding.py may cut its convs on the 'model' axis

    def __init__(self, input_dim: int, output_dim: int, kernel_size: int = 3,
                 biases: bool = True, adjust_padding: bool = False):
        super().__init__()
        self.adjust_padding = adjust_padding
        pad = 0 if adjust_padding and kernel_size == 3 else kernel_size // 2
        self.conv = Conv(input_dim, output_dim, kernel_size, padding=pad, bias=biases)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.adjust_padding:
            x = F.pad(x, (1, 0, 1, 0))
        return _mean_pool_2x(self.conv(x))


class MeanPoolConv(nn.Module):
    """A 2x mean pool, then a conv (layers.py:434-454)."""

    shards_plain_convs = True  # parallel/sharding.py may cut its convs on the 'model' axis

    def __init__(self, input_dim: int, output_dim: int, kernel_size: int = 3,
                 biases: bool = True):
        super().__init__()
        self.conv = Conv(input_dim, output_dim, kernel_size, padding=kernel_size // 2,
                         bias=biases)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(_mean_pool_2x(x))


class UpsampleConv(nn.Module):
    """A nearest 2x upsample (the reference's 4x channel repeat and pixel
    shuffle), then a conv (layers.py:457-470)."""

    shards_plain_convs = True  # parallel/sharding.py may cut its convs on the 'model' axis

    def __init__(self, input_dim: int, output_dim: int, kernel_size: int = 3,
                 biases: bool = True):
        super().__init__()
        self.conv = Conv(input_dim, output_dim, kernel_size, padding=kernel_size // 2,
                         bias=biases)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3))


class ResidualBlock(nn.Module):
    """NCSNv1 residual block with an optional 'down' resample
    (layers.py:473-560); conditional when `normalizer` is given. The
    shortcut is the identity only when the widths match and nothing
    resamples."""

    shards_plain_convs = True  # parallel/sharding.py may cut its convs on the 'model' axis

    def __init__(self, input_dim: int, output_dim: int, resample: Optional[str] = None,
                 act: Act = F.elu, normalizer: Normalizer = None, dilation: int = 1,
                 adjust_padding: bool = False):
        super().__init__()
        self.act = act
        if resample not in ("down", None):
            raise ValueError("invalid resample value")
        if normalizer is not None:
            self.normalize1 = normalizer(input_dim)
        self.normalize2 = None
        d = dilation
        if resample == "down":
            self.conv1 = ncsn_conv3x3(input_dim, input_dim, dilation=d)
            mid = input_dim
            if d > 1:
                self.conv2 = ncsn_conv3x3(input_dim, output_dim, dilation=d)
                self.shortcut = ncsn_conv3x3(input_dim, output_dim, dilation=d)
            else:
                self.conv2 = ConvMeanPool(input_dim, output_dim, 3, adjust_padding=adjust_padding)
                self.shortcut = ConvMeanPool(input_dim, output_dim, 1,
                                             adjust_padding=adjust_padding)
        else:
            self.conv1 = ncsn_conv3x3(input_dim, output_dim, dilation=d)
            mid = output_dim
            self.conv2 = ncsn_conv3x3(output_dim, output_dim, dilation=d)
            if output_dim == input_dim:
                self.shortcut = None
            elif d > 1:
                self.shortcut = ncsn_conv3x3(input_dim, output_dim, dilation=d)
            else:
                self.shortcut = Conv(input_dim, output_dim, 1)
        if normalizer is not None:
            self.normalize2 = normalizer(mid)
        self.conditional = normalizer is not None

    def forward(self, x: torch.Tensor, y: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.normalize1(x, y) if self.conditional else x
        h = self.conv1(self.act(h))
        if self.conditional:
            h = self.normalize2(h, y)
        h = self.conv2(self.act(h))
        return h + (x if self.shortcut is None else self.shortcut(x))
