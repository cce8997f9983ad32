"""NCSN++ building blocks as torch modules (NCHW).

Port of use_tpu/models/ncsnpp/layers.py (reference: layerspp.py:30-314 and
layers.py:66-163,639-650): Gaussian-Fourier time embedding, NIN (1x1 dense
over channels), channelwise self-attention, FIR / nearest up- and
downsampling layers and BigGAN / DDPM residual blocks.

Layout: activations are ``[B, C, H(=freq), W(=frames)]``, contiguous, as the
reference's torch model and cuDNN have them. Parameters are held as the
reference holds them, so ``state_dict()`` keys and shapes are the
reference's: conv weights OIHW, Linear weights [out, in], GroupNorm
weight/bias, NIN and GFP ``W``/``b``. Submodule names match the reference
(GroupNorm_0, Conv_0, Dense_0, NIN_0, ...).

Compute dtype: every conv / dense / NIN layer has a compute ``dtype`` and
casts its input and its parameters to it at use, as Flax's ``dtype=`` does;
``ScoreModel.cast_params_for_inference`` pre-casts the weights once. The
GroupNorm statistics are always fp32 (ops/gn_stats.py). The layers that run
the hand-written kernels: ``GroupNormAct`` (K1, and under quant='int8' K1's
apply with its int8 epilogue), the ``Conv_2`` shortcut of
``ResnetBlockBigGANpp`` (K2), under quant='int8_pallas' ``FusedQConv3x3``
(K3) and under quant='int8' ``QConv`` (the s8 conv, ops/qconv.py).

Tensor parallelism (parallel/sharding.py): a ``Conv2d`` or ``Linear`` whose
``tp`` is set holds its output channels of this model rank; it computes
them with the rank's slice of the bias inside the conv or matmul, and
gathers them over the model group, so that each output channel goes
through the uncut layer's arithmetic (bit for bit on the CPU). The int8
convs (``FusedQConv3x3``, ``QConv``) pass the slice to K3's or the s8
conv's epilogue likewise. Where a BigGAN block's ``Conv_2`` is sharded, K2
runs on this rank's output channels of ``Conv_1`` and one gather follows
it.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from use_tpu_torch.ops import fused_qconv, qconv
from use_tpu_torch.ops.fused_qconv import true_div
from use_tpu_torch.ops.fused_skip import fused_skip_add
from use_tpu_torch.ops.gn_stats import gn_apply_int8, gn_fold, group_norm_act, num_groups
from use_tpu_torch.ops.upfirdn2d import (
    conv_downsample_2d,
    downsample_2d,
    naive_downsample_2d,
    naive_upsample_2d,
    upsample_2d,
    upsample_conv_2d,
)
from use_tpu_torch.parallel.sharding import (
    copy_to_model,
    gather_from_model,
    split_to_model,
)

_SKIP_SCALE = float(1.0 / np.sqrt(2.0))


def get_act(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Activation zoo (reference layers.py:29-41)."""
    if name == "elu":
        return F.elu
    if name == "relu":
        return F.relu
    if name == "lrelu":
        return lambda x: F.leaky_relu(x, negative_slope=0.2)
    if name == "swish":
        return F.silu
    raise NotImplementedError("activation function does not exist!")


def default_init_(w: torch.Tensor, scale: float, fan_in: int, fan_out: int,
                  generator: Optional[torch.Generator]) -> None:
    """DDPM initialization: variance_scaling(scale, fan_avg, uniform)
    (reference layers.py:66-103)."""
    scale = 1e-10 if scale == 0 else scale
    bound = math.sqrt(3.0 * scale / ((fan_in + fan_out) / 2.0))
    with torch.no_grad():
        w.uniform_(-bound, bound, generator=generator)


class Conv2d(nn.Module):
    """kxk conv (stride 1, 'same' padding) with DDPM init; OIHW weight."""

    tp = None  # the World whose model ranks hold the output channels (parallel/sharding.py)

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, bias: bool = True,
                 init_scale: float = 1.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None
        self.padding = kernel // 2
        self.init_scale = init_scale
        self.dtype = dtype

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        o, i, kh, kw = self.weight.shape
        default_init_(self.weight, self.init_scale, i * kh * kw, o * kh * kw, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_with(x, lambda x, w, b: F.conv2d(x, w, b, padding=self.padding),
                              self.dtype)

    def conv_with(self, x: torch.Tensor, conv: Callable, dtype: torch.dtype) -> torch.Tensor:
        """conv(x, weight, bias) in `dtype`. Sharded (``tp``): conv on this
        rank's output channels with their slice of the bias, gathered over
        the model group: each channel's arithmetic is the uncut conv's."""
        if self.tp is None:
            w = self.weight.to(dtype)
            return conv(x.to(dtype), w, None if self.bias is None else self.bias.to(dtype))
        return gather_from_model(self.local_with(x, conv, dtype), self.tp, 1)

    def local_with(self, x: torch.Tensor, conv: Callable, dtype: torch.dtype) -> torch.Tensor:
        """This model rank's output channels of conv_with (sharded convs
        only): its slice of the bias goes into the conv, and the bias's and
        x's gradients come back whole."""
        b = None if self.bias is None else split_to_model(self.bias.to(dtype), self.tp, 0)
        return conv(copy_to_model(x, self.tp).to(dtype), self.weight.to(dtype), b)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This model rank's output channels of forward(x) (sharded convs
        only)."""
        return self.local_with(x, lambda x, w, b: F.conv2d(x, w, b, padding=self.padding),
                               self.dtype)


def _state(t: torch.Tensor) -> Optional[tuple]:
    """What tells a tensor's values apart without reading them: its storage,
    its count of in-place updates, dtype and device. None for an inference
    tensor, whose in-place updates leave no trace: nothing made from one is
    kept."""
    if t.is_inference():
        return None
    return (t.data_ptr(), t._version, t.dtype, t.device)


def _kept(conv: nn.Module, u: Optional[torch.Tensor], make: Callable[[], tuple]) -> tuple:
    """make() (a conv's prepared weights), made without autograd and kept on
    the conv until its weight, its bias or u change: a new storage, dtype or
    device, an in-place update (``load_state_dict``, ``copy_``), or another
    u tensor. The kept tensors pin the storages they were made from, so that
    a storage address is not reused while it is a key. Parameters made under
    ``torch.inference_mode`` count no updates, so they are prepared on every
    call."""
    params = tuple(t for t in (conv.weight, conv.bias) if t is not None)
    key = tuple(_state(t) for t in params)
    kept = conv._prepared
    if kept is None or None in key or kept[0] != key or kept[1] is not u:
        with torch.no_grad():
            kept = (key, u, make(), tuple(t.detach() for t in params))
        conv._prepared = kept
    return kept[2]


class FusedQConv3x3(Conv2d):
    """3x3 conv with the GroupNorm apply + SiLU + int8 quantize fused into
    its operand read: the port of use_tpu's ``PallasQConv3x3``
    (layers.py:124-149), kernel K3 on the card (ops/fused_qconv.py).

    Holds ``weight`` (OIHW) and ``bias`` as ``Conv2d`` does, so fp32, bf16
    and int8 serving share state dicts. Takes the raw activation and the
    ``(a, off, u)`` of ``GroupNormAct(quant='fold')``; SiLU is hard-wired, the
    output is in the compute dtype. Serving only.

    The weight is quantized once and kept (with the fp32 bias) until the
    weight, the bias or u change (``_kept``)."""

    _prepared = None  # (key, u, (QConvWeights, fp32 bias), pinned parameters)

    def forward(self, x: torch.Tensor, gn_scale: torch.Tensor, gn_shift: torch.Tensor,
                u: torch.Tensor) -> torch.Tensor:
        y = self.local(x, gn_scale, gn_shift, u)
        return y if self.tp is None else gather_from_model(y, self.tp, 1)

    def local(self, x: torch.Tensor, gn_scale: torch.Tensor, gn_shift: torch.Tensor,
              u: torch.Tensor) -> torch.Tensor:
        """K3 on the output channels this model rank holds (all of them
        where the weight is not cut), their slice of the bias in K3's
        epilogue. A cut weight is prepared as its slice of the whole weight's
        preparation (both are per output channel)."""
        prepared, bias = _kept(self, u, lambda: (
            fused_qconv.prepare_qconv_weight(self.weight, u),
            None if self.bias is None else _bias_slice(self).float().contiguous()))
        return fused_qconv.qconv3x3_fused(x.contiguous(), self.weight, u, gn_scale, gn_shift,
                                          act=True, bias=bias, out_dtype=self.dtype,
                                          prepared=prepared)


def _bias_slice(conv: Conv2d) -> Optional[torch.Tensor]:
    """The bias of the output channels a conv's weight holds: the whole bias,
    or this model rank's slice of it where the weight is cut."""
    if conv.bias is None or conv.tp is None:
        return conv.bias
    n = conv.weight.shape[0]
    return conv.bias.narrow(0, conv.tp.model_rank * n, n)


class QConv(Conv2d):
    """use_tpu's ``QConv`` (ops/qconv.py:129-196): ``Conv2d``'s parameters
    (OIHW weight, bias), so fp32, bf16 and int8 serving share state dicts,
    run as an int8 conv on the s8 kernel (ops/qconv.py) in the compute dtype.

    ``forward(qx, prequant_scale)`` takes an operand its producer quantized
    (``GroupNormAct(quant='out')``, or ``quantize_with_scale`` after a
    resampling), in the kernel's C32 layout (ops/qconv.py ``pack_c32``) or
    NCHW: a per-input-channel scale [C] folds into the weight, a scalar or
    per-sample one [B, 1, 1, 1] dequantizes after the conv. ``forward(x)``
    quantizes x per sample (packed to C32) where min(C, O) reaches
    ``min_channels`` (scaled by 9 / (kh kw) for other kernels; O the whole
    output width of a cut weight, as use_tpu's sharded kernel has it), else
    runs the exact conv. The weight is quantized once and kept until the
    weight, the bias or the scale tensor change (``_kept``). Serving only."""

    _prepared = None  # (key, u, S8Weights, pinned parameters)

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, bias: bool = True,
                 init_scale: float = 1.0, dtype: torch.dtype = torch.float32,
                 min_channels: int = 192):
        super().__init__(in_ch, out_ch, kernel, bias, init_scale, dtype)
        self.min_channels = min_channels

    def quantizes(self) -> bool:
        """Whether ``forward(x)`` quantizes x: use_tpu's gate, on the whole
        output width of a cut weight."""
        o, c, kh, kw = self.weight.shape
        o *= 1 if self.tp is None else self.tp.model
        return min(c, o) >= self.min_channels * 9 // max(kh * kw, 1)

    def forward(self, x: torch.Tensor,
                prequant_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
        if prequant_scale is None and not self.quantizes():
            return super().forward(x)
        y = self.local(x, prequant_scale)
        return y if self.tp is None else gather_from_model(y, self.tp, 1)

    def local(self, x: torch.Tensor,
              prequant_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The s8 conv on the output channels this model rank holds, their
        slice of the bias in the kernel's epilogue (the exact conv's local
        channels where the dynamic path's gate is shut)."""
        if prequant_scale is None:
            if not self.quantizes():
                return super().local(x)
            x, post = qconv.quantize_per_sample(x)
            x, u = qconv.pack_c32(x), None
        elif prequant_scale.dim() == 1:
            u, post = prequant_scale, None
        else:
            u, post = None, prequant_scale.reshape(-1)
        prepared = _kept(self, u, lambda: qconv.prepare_s8_weight(self.weight, u))
        return qconv.s8_conv(x, prepared, post, _bias_slice(self), self.dtype,
                             padding=self.padding)


class Linear(nn.Module):
    """Dense layer with DDPM init; [out, in] weight."""

    tp = None  # as Conv2d's

    def __init__(self, in_features: int, out_features: int, init_scale: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))
        self.init_scale = init_scale
        self.dtype = dtype

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        o, i = self.weight.shape
        default_init_(self.weight, self.init_scale, i, o, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight.to(self.dtype), self.bias.to(self.dtype)
        if self.tp is None:
            return F.linear(x.to(self.dtype), w, b)
        # as Conv2d's: this rank's slice of the bias in the matmul
        y = F.linear(copy_to_model(x, self.tp).to(self.dtype), w, split_to_model(b, self.tp, 0))
        return gather_from_model(y, self.tp, 1)


class GroupNormAct(nn.Module):
    """GroupNorm(min(C//4, 32), eps=1e-6) fused with an optional activation.

    The same normalization as use_tpu's GroupNormAct (layers.py:160-272):
    fp32 one-pass statistics, var = max(E[x^2] - E[x]^2, 0), and an apply
    pass ``act(x * a + off)`` with the statistics and affine folded into
    per-(batch, channel) a/off, written in ``out_dtype``. Both passes are
    kernel K1 on the card (ops/gn_stats.py).

    int8 serving (layers.py:237-272), with u the analytic k-sigma activation
    scale (|bias| + quant_k |weight|) / 127 + 1e-12 [C] fp32:

    - ``quant='fold'`` (quant='int8_pallas') runs the statistics pass only,
      with the fold inside it (``gn_fold``), and returns ``(a [B, C],
      off [B, C], u)``, all fp32, for ``FusedQConv3x3`` to apply in its
      operand read;
    - ``quant='out'`` (quant='int8') runs the same statistics pass, then the
      apply with its int8 epilogue (``gn_apply_int8``): ``(q, u)``, q the
      int8 activation clip(round(y / u), -127, 127) of y in out_dtype, in
      the int8 conv's C32 layout [B, ceil(C/32), 2, H, W, 16] (``QConv`` takes
      it; ops/qconv.py ``unpack_c32`` gives NCHW);
    - ``quant='scale'`` (quant='int8' before a resampling) returns
      ``(y, u)``, y as ``quant='none'`` computes it.
    """

    def __init__(self, channels: int, act: Optional[str] = None,
                 out_dtype: torch.dtype = torch.float32, eps: float = 1e-6,
                 quant: str = "none", quant_k: float = 6.0):
        super().__init__()
        if quant not in ("none", "fold", "out", "scale"):
            raise ValueError(f"GroupNormAct quant={quant!r} (none | fold | out | scale)")
        self.channels = channels
        self.groups = num_groups(channels)
        self.act = act
        self.out_dtype = out_dtype
        self.eps = eps
        self.quant = quant
        self.quant_k = quant_k
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor):
        if x.shape[1] != self.channels:
            raise ValueError(f"GroupNormAct({self.channels}) got input {tuple(x.shape)}")
        if self.quant in ("none", "scale"):
            y = group_norm_act(x, self.weight, self.bias, self.groups, self.act,
                               self.out_dtype, self.eps)
            return y if self.quant == "none" else (y, self._act_scale())
        b, c = x.shape[:2]
        x3 = x.reshape(b, c, -1)
        a, off = gn_fold(x3, self.weight, self.bias, self.groups, self.eps)
        u = self._act_scale()
        if self.quant == "fold":
            return a, off, u
        q = gn_apply_int8(x3, a, off, u, self.act, self.out_dtype, c32=True)
        return q.reshape(*q.shape[:3], *x.shape[2:], q.shape[-1]), u

    _u = None  # (key, pinned affine, u)

    def _act_scale(self) -> torch.Tensor:
        """u, kept as one tensor until the affine changes (``FusedQConv3x3``
        and ``QConv`` key their prepared weights on u)."""
        key = (_state(self.weight), _state(self.bias))
        if self._u is None or None in key or self._u[0] != key:
            with torch.no_grad():
                u = true_div(self.bias.float().abs() + self.quant_k * self.weight.float().abs(),
                             127.0) + 1e-12
            self._u = (key, (self.weight.detach(), self.bias.detach()), u)
        return self._u[2]


class GaussianFourierProjection(nn.Module):
    """Gaussian Fourier features for (log-)noise levels (layerspp.py:30-39).

    W is a frozen random projection (requires_grad=False), kept in the
    state_dict so checkpoints carry it."""

    def __init__(self, embedding_size: int = 256, scale: float = 16.0):
        super().__init__()
        self.scale = scale
        self.W = nn.Parameter(torch.empty(embedding_size), requires_grad=False)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.W.normal_(generator=generator).mul_(self.scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_proj = x.float()[:, None] * self.W[None, :] * 2 * np.pi
        return torch.cat([torch.sin(x_proj), torch.cos(x_proj)], dim=-1)


class NIN(nn.Module):
    """1x1 'network-in-network' dense over the channel axis (layers.py:639-650),
    applied to channel-last input [..., C]."""

    def __init__(self, in_dim: int, num_units: int, init_scale: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.W = nn.Parameter(torch.empty(in_dim, num_units))
        self.b = nn.Parameter(torch.empty(num_units))
        self.init_scale = init_scale
        self.dtype = dtype

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        i, o = self.W.shape
        default_init_(self.W, self.init_scale, i, o, generator)
        nn.init.zeros_(self.b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x.to(self.dtype), self.W.to(self.dtype)) + self.b.to(self.dtype)


class Combine(nn.Module):
    """Combine a skip pyramid with features (layerspp.py:42-57)."""

    def __init__(self, dim1: int, dim2: int, method: str = "cat",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if method not in ("cat", "sum"):
            raise ValueError(f"Method {method} not recognized.")
        self.Conv_0 = Conv2d(dim1, dim2, kernel=1, dtype=dtype)
        self.method = method

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        h = self.Conv_0(x)
        if self.method == "cat":
            return torch.cat([h, y], dim=1)
        return h + y


class AttnBlockpp(nn.Module):
    """Channel-wise self-attention over the full F x T grid (layerspp.py:60-93):
    two batched matmuls over the flattened spatial axis with an fp32 softmax,
    as use_tpu computes it (torch.matmul, no fused attention call)."""

    def __init__(self, channels: int, skip_rescale: bool = False, init_scale: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.GroupNorm_0 = GroupNormAct(channels, act=None, out_dtype=dtype)
        self.NIN_0 = NIN(channels, channels, dtype=dtype)
        self.NIN_1 = NIN(channels, channels, dtype=dtype)
        self.NIN_2 = NIN(channels, channels, dtype=dtype)
        self.NIN_3 = NIN(channels, channels, init_scale=init_scale, dtype=dtype)
        self.skip_rescale = skip_rescale
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        hid = self.GroupNorm_0(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        q, k, v = self.NIN_0(hid), self.NIN_1(hid), self.NIN_2(hid)
        logits = torch.matmul(q.float(), k.float().transpose(1, 2)) * (int(c) ** (-0.5))
        attn = torch.softmax(logits, dim=-1).to(self.dtype)
        out = self.NIN_3(torch.matmul(attn, v))
        out = out.reshape(b, h, w, c).permute(0, 3, 1, 2).to(x.dtype)
        if not self.skip_rescale:
            return x + out
        return (x + out) * _SKIP_SCALE


class Upsample(nn.Module):
    """FIR or nearest 2x upsampling, optionally fused with a conv
    (layerspp.py:96-133; use_tpu layers.py:364-389). Without FIR: nearest
    (each pixel repeated 2 x 2, as ``jax.image.resize(..., 'nearest')`` does
    at exactly twice the size), then ``Conv_0``; with FIR and a conv:
    ``upsample_conv_2d`` on ``Conv2d_0``'s weight, plus its bias. The convs
    compute in fp32, as use_tpu's (param-dtype) convs there do; without a
    conv the layer keeps the input's dtype."""

    def __init__(self, in_ch: int, out_ch: Optional[int] = None, with_conv: bool = False,
                 fir: bool = False, fir_kernel: Tuple[float, ...] = (1.0, 3.0, 3.0, 1.0)):
        super().__init__()
        out_ch = out_ch if out_ch is not None else in_ch
        self.with_conv, self.fir, self.fir_kernel = with_conv, fir, tuple(fir_kernel)
        if with_conv:
            setattr(self, "Conv2d_0" if fir else "Conv_0", Conv2d(in_ch, out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fir:
            h = naive_upsample_2d(x, 2)
            return self.Conv_0(h) if self.with_conv else h
        if not self.with_conv:
            return upsample_2d(x, self.fir_kernel, factor=2)
        conv = self.Conv2d_0
        y = upsample_conv_2d(x.float(), conv.weight.float(), k=self.fir_kernel)
        return y + conv.bias.float()[None, :, None, None]


class Downsample(nn.Module):
    """FIR or average-pool 2x downsampling, optionally fused with a conv
    (layerspp.py:136-175; use_tpu layers.py:392-420). Without FIR: with a
    conv, a (0, 1) pad and ``Conv_0`` at stride 2 without padding, else a
    2 x 2 average pool; with FIR and a conv: ``conv_downsample_2d`` on
    ``Conv2d_0``'s weight, plus its bias. Dtypes as ``Upsample``."""

    def __init__(self, in_ch: int, out_ch: Optional[int] = None, with_conv: bool = False,
                 fir: bool = False, fir_kernel: Tuple[float, ...] = (1.0, 3.0, 3.0, 1.0)):
        super().__init__()
        out_ch = out_ch if out_ch is not None else in_ch
        self.with_conv, self.fir, self.fir_kernel = with_conv, fir, tuple(fir_kernel)
        if with_conv:
            setattr(self, "Conv2d_0" if fir else "Conv_0", Conv2d(in_ch, out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fir:
            if not self.with_conv:
                return F.avg_pool2d(x, 2)
            return self.Conv_0.conv_with(F.pad(x.float(), (0, 1, 0, 1)),
                                         lambda x, w, b: F.conv2d(x, w, b, stride=2),
                                         torch.float32)
        if not self.with_conv:
            return downsample_2d(x, self.fir_kernel, factor=2)
        conv = self.Conv2d_0
        y = conv_downsample_2d(x.float(), conv.weight.float(), k=self.fir_kernel)
        return y + conv.bias.float()[None, :, None, None]


def _quant_gates(quant: str, in_ch: int, out_ch: int, min_channels: int) -> Tuple[bool, bool]:
    """use_tpu's q0 / q1 (layers.py:440-446, 512-515): under quant='int8' a
    block's Conv_0 quantizes where min(in, out) >= min_channels, its Conv_1
    where out >= min_channels."""
    q = quant == "int8"
    return q and min(in_ch, out_ch) >= min_channels, q and out_ch >= min_channels


def _check_quant(quant: str) -> None:
    if quant not in ("none", "int8", "int8_pallas"):
        raise ValueError(f"quant={quant!r} (none | int8 | int8_pallas)")


class ResnetBlockDDPMpp(nn.Module):
    """DDPM residual block (layerspp.py:178-234).

    ``quant='int8'`` (serving) gates its 3x3 convs as use_tpu does
    (layers.py:440-469): a gated conv is a ``QConv`` fed by
    ``GroupNormAct(quant='out')``, and dropout drops out of the ``Conv_1``
    path. ``quant='int8_pallas'`` leaves the block unquantized, as in
    use_tpu."""

    def __init__(self, act: str, in_ch: int, out_ch: Optional[int] = None,
                 conv_shortcut: bool = False, dropout: float = 0.1, skip_rescale: bool = False,
                 init_scale: float = 0.0, temb_dim: Optional[int] = None,
                 dtype: torch.dtype = torch.float32, quant: str = "none",
                 quant_min_channels: int = 128, quant_k: float = 6.0):
        super().__init__()
        _check_quant(quant)
        out_ch = out_ch if out_ch is not None else in_ch
        self.act_name = act
        self.act = get_act(act)
        self.q0, self.q1 = _quant_gates(quant, in_ch, out_ch, quant_min_channels)
        self.GroupNorm_0 = GroupNormAct(in_ch, act=act, out_dtype=dtype,
                                        quant="out" if self.q0 else "none", quant_k=quant_k)
        self.Conv_0 = (QConv if self.q0 else Conv2d)(in_ch, out_ch, dtype=dtype)
        self.Dense_0 = Linear(temb_dim, out_ch, dtype=dtype) if temb_dim is not None else None
        self.GroupNorm_1 = GroupNormAct(out_ch, act=act, out_dtype=dtype,
                                        quant="out" if self.q1 else "none", quant_k=quant_k)
        self.Conv_1 = (QConv if self.q1 else Conv2d)(out_ch, out_ch, init_scale=init_scale,
                                                     dtype=dtype)
        self.Conv_2 = self.NIN_0 = None
        if in_ch != out_ch:
            if conv_shortcut:
                self.Conv_2 = Conv2d(in_ch, out_ch, dtype=dtype)
            else:
                self.NIN_0 = NIN(in_ch, out_ch, dtype=dtype)
        self.dropout = dropout
        self.skip_rescale = skip_rescale

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.q0:
            h = self.Conv_0(*self.GroupNorm_0(x))
        else:
            h = self.Conv_0(self.GroupNorm_0(x))
        if temb is not None and self.Dense_0 is not None:
            h = h + self.Dense_0(self.act(temb))[:, :, None, None]
        if self.q1:
            h = self.Conv_1(*self.GroupNorm_1(h))
        else:
            h = self.GroupNorm_1(h)
            h = F.dropout(h, self.dropout, training=self.training)
            h = self.Conv_1(h)
        if self.Conv_2 is not None:
            x = self.Conv_2(x)
        elif self.NIN_0 is not None:
            # contiguous NCHW again: a channels-last sum would reach the next
            # GroupNorm's kernels, which take NCHW only
            x = self.NIN_0(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2).contiguous()
        x = x.to(h.dtype)
        if not self.skip_rescale:
            return x + h
        return (x + h) * _SKIP_SCALE


class ResnetBlockBigGANpp(nn.Module):
    """BigGAN residual block with optional FIR up/down (layerspp.py:237-314).

    When the block changes its channel count or resamples, its 1x1 ``Conv_2``
    shortcut, the residual add and the skip rescale run as kernel K2
    (ops/fused_skip.py), on Conv_2's weight and bias in the compute dtype
    (cast once for serving by ``cast_backbone_for_inference``).

    int8 serving gates each 3x3 conv as use_tpu does (layers.py:506-526),
    and dropout drops out of a gated ``Conv_1`` path (serving only):

    - ``quant='int8_pallas'``: ``Conv_0`` when the block does not resample,
      its activation is SiLU and min(in, out) >= quant_min_channels;
      ``Conv_1`` when SiLU and out >= quant_min_channels. A gated conv is a
      ``FusedQConv3x3`` (kernel K3) fed by ``GroupNormAct(quant='fold')``.
    - ``quant='int8'``: ``Conv_0`` when min(in, out) >= quant_min_channels,
      resampling blocks included; ``Conv_1`` when out >= quant_min_channels.
      A gated conv is a ``QConv`` (the s8 kernel) fed by
      ``GroupNormAct(quant='out')``; in a resampling block GroupNorm_0
      returns (y, u) (``quant='scale'``), y is resampled and then quantized
      with u (``quantize_with_scale``, layers.py:546-552)."""

    def __init__(self, act: str, in_ch: int, out_ch: Optional[int] = None, up: bool = False,
                 down: bool = False, dropout: float = 0.1, fir: bool = False,
                 fir_kernel: Tuple[float, ...] = (1.0, 3.0, 3.0, 1.0), skip_rescale: bool = True,
                 init_scale: float = 0.0, temb_dim: Optional[int] = None,
                 dtype: torch.dtype = torch.float32, quant: str = "none",
                 quant_min_channels: int = 128, quant_k: float = 6.0):
        super().__init__()
        _check_quant(quant)
        out_ch = out_ch if out_ch is not None else in_ch
        self.act = get_act(act)
        self.up, self.down, self.fir = up, down, fir
        self.fir_kernel = tuple(fir_kernel)
        q = quant == "int8_pallas" and act == "swish"
        self.qp0 = q and not (up or down) and min(in_ch, out_ch) >= quant_min_channels
        self.qp1 = q and out_ch >= quant_min_channels
        self.q0, self.q1 = _quant_gates(quant, in_ch, out_ch, quant_min_channels)
        mode0 = ("fold" if self.qp0 else ("scale" if up or down else "out") if self.q0
                 else "none")
        self.GroupNorm_0 = GroupNormAct(in_ch, act=act, out_dtype=dtype, quant=mode0,
                                        quant_k=quant_k)
        self.Conv_0 = (FusedQConv3x3 if self.qp0 else QConv if self.q0 else Conv2d)(
            in_ch, out_ch, dtype=dtype)
        self.Dense_0 = Linear(temb_dim, out_ch, dtype=dtype) if temb_dim is not None else None
        self.GroupNorm_1 = GroupNormAct(
            out_ch, act=act, out_dtype=dtype,
            quant="fold" if self.qp1 else "out" if self.q1 else "none", quant_k=quant_k)
        self.Conv_1 = (FusedQConv3x3 if self.qp1 else QConv if self.q1 else Conv2d)(
            out_ch, out_ch, init_scale=init_scale, dtype=dtype)
        self.Conv_2 = (
            Conv2d(in_ch, out_ch, kernel=1, dtype=dtype) if (in_ch != out_ch or up or down) else None
        )
        self.dropout = dropout
        self.skip_rescale = skip_rescale
        self.dtype = dtype

    def _resample(self, x: torch.Tensor) -> torch.Tensor:
        if self.up:
            return upsample_2d(x, self.fir_kernel, factor=2) if self.fir else naive_upsample_2d(x, 2)
        if self.down:
            return downsample_2d(x, self.fir_kernel, factor=2) if self.fir else naive_downsample_2d(x, 2)
        return x

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.qp0:  # no resampling on this path
            h = self.Conv_0(x, *self.GroupNorm_0(x))
        elif self.q0 and (self.up or self.down):
            y, u = self.GroupNorm_0(x)
            # the normalized FIR kernel has unit DC gain per polyphase leg,
            # so the k-sigma bound of y still holds after the resampling
            h = self.Conv_0(qconv.pack_c32(qconv.quantize_with_scale(self._resample(y), u)), u)
            x = self._resample(x)
        elif self.q0:
            h = self.Conv_0(*self.GroupNorm_0(x))
        else:
            h = self.Conv_0(self._resample(self.GroupNorm_0(x)))
            x = self._resample(x)
        if temb is not None and self.Dense_0 is not None:
            h = h + self.Dense_0(self.act(temb))[:, :, None, None]
        scale = _SKIP_SCALE if self.skip_rescale else 1.0
        sharded = self.Conv_2 is not None and self.Conv_2.tp is not None
        if self.qp1 or self.q1:
            args = (h, *self.GroupNorm_1(h)) if self.qp1 else self.GroupNorm_1(h)
            if sharded:
                return self._sharded_skip(x, self.Conv_1.local(*args), scale)
            h = self.Conv_1(*args)
        else:
            h = F.dropout(self.GroupNorm_1(h), self.dropout, training=self.training)
            if sharded:
                return self._sharded_skip(x, self.Conv_1.local(h), scale)
            h = self.Conv_1(h)
        if self.Conv_2 is not None:
            conv = self.Conv_2
            return fused_skip_add(
                x.to(self.dtype).contiguous(), h.contiguous(), conv.weight.to(self.dtype),
                conv.bias.to(self.dtype), scale,
            )
        x = x.to(h.dtype)
        return (x + h) * scale if self.skip_rescale else x + h

    def _sharded_skip(self, x: torch.Tensor, h: torch.Tensor, scale: float) -> torch.Tensor:
        """K2 on this model rank's output channels (Conv_2 sharded, so Conv_1
        too: its 9 out^2 weights outnumber Conv_2's in x out in every NCSN++
        block): K2 takes h, Conv_1's output channels of this rank before
        their gather (``Conv_1.local``), Conv_2's weight slice and bias
        slice; one gather follows."""
        tp, conv = self.Conv_2.tp, self.Conv_2
        out = fused_skip_add(copy_to_model(x.to(self.dtype), tp).contiguous(), h.contiguous(),
                             conv.weight.to(self.dtype),
                             split_to_model(conv.bias.to(self.dtype), tp, 0), scale)
        return gather_from_model(out, tp, 1)
