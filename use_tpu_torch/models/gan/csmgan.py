"""CSMGAN: the causal streaming STFT U-Net generator.

Port of use_tpu/models/gan/csmgan.py (reference
GAN/generator/CSMGAN/generator5_24k.py:12-788): GLFB blocks (gated depthwise
conv, channel and frequency squeeze-excitation, cumulative layer norm), a
causal TCN bottleneck over the flattened C x F axis, a PixelShuffle
frequency-upsampling decoder, and causal 2-D convolutions throughout (left
padded in time, symmetric in frequency), so the network streams.

Layout: activations are [B, C, T, F], the reference's torch layout (time on
dim 2 is the causal axis). Weights are OIHW / OIK and the state_dict keys
are the reference's module paths (``in_proj.conv``,
``encoder.{i}.glfb.{d}.first_block.{n}``, ``encoder.{i}.conv``,
``bottleneck.TCN.{n}.dconv1d``, ``decoder.{i}.deconv.conv.conv``,
``out_proj.conv``), the keys use_tpu/engine/convert_torch.py::
convert_csmgan_state_dict reads. The PixelShuffle splits channels
scale-minor, as torch does (channel nc * 2 + s goes to frequency s * F + f).

Streaming: every causal module (``_Causal``) keeps, while a ``CSMGANStream``
step runs, its left time context or its cumulative (sum, pow, count) in a
dict of the session's (``streaming`` binds them), as tensors on the
module's device; the dicts start empty (all zeros), so chunk-wise outputs
equal one offline pass. Offline, the modules pad with zeros instead.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from use_tpu_torch.models.gan.discriminators import reset_parameters
from use_tpu_torch.models.registry import GeneratorRegistry
from use_tpu_torch.ops.stft import frames_irfft, frames_rfft, window_sq
from use_tpu_torch.ops.stft_feature import (
    STFTFeature,
    _compress,
    _decompress,
    mag_unit_phase,
)
from use_tpu_torch.utils.device import resolve_device

Batch = Dict[str, torch.Tensor]
EPS_1D, EPS_2D = 1e-8, 1e-6  # the cumulative norms' (cLN's, CumLN2d's)
UPSCALE = 2  # the decoder's frequency upsampling


def _steps(t: int, ndim: int, device) -> torch.Tensor:
    """1, 2, ..., t as float32 along dim 2 of an `ndim`-dim tensor."""
    return torch.arange(1, t + 1, dtype=torch.float32, device=device).reshape(
        (1, 1, t) + (1,) * (ndim - 3))


def _cumulative_stats(sums: torch.Tensor, pows: torch.Tensor, per_step: int):
    """Cumulative mean and variance over time (dim 2) from per-step channel
    sums. The variance is E[x^2] - E[x]^2, clamped at 0: the form can go
    slightly negative under cancellation, and rsqrt of that poisons
    training."""
    cnt = _steps(sums.shape[2], sums.dim(), sums.device) * per_step
    mean = torch.cumsum(sums, 2) / cnt
    var = torch.clamp(torch.cumsum(pows, 2) / cnt - mean ** 2, min=0.0)
    return mean, var


def _stream_cum_stats(state: Dict, sums: torch.Tensor, pows: torch.Tensor, per_step: int):
    """_cumulative_stats continued from the carried (sum, pow, count) in
    `state`, which it advances."""
    if not state:
        carry = sums.shape[:2] + (1,) + sums.shape[3:]
        state.update(sum=sums.new_zeros(carry), pow=sums.new_zeros(carry),
                     cnt=sums.new_zeros(()))
    cum_sum = state["sum"] + torch.cumsum(sums, 2)
    cum_pow = state["pow"] + torch.cumsum(pows, 2)
    t = sums.shape[2]
    cnt = (state["cnt"] + _steps(t, sums.dim(), sums.device)) * per_step
    mean = cum_sum / cnt
    var = torch.clamp(cum_pow / cnt - mean ** 2, min=0.0)
    state.update(sum=cum_sum[:, :, -1:], pow=cum_pow[:, :, -1:], cnt=state["cnt"] + t)
    return mean, var


def _stream_context(state: Dict, x: torch.Tensor, ctx: int) -> torch.Tensor:
    """Prepend the `ctx` carried time steps (dim 2) to x and carry the new
    tail: the streaming form of causal left zero padding."""
    if not state:
        state["ctx"] = x.new_zeros(x.shape[:2] + (ctx,) + x.shape[3:])
    ext = torch.cat([state["ctx"], x], dim=2)
    state["ctx"] = ext[:, :, -ctx:]
    return ext


class _Causal(nn.Module):
    """A module with state across a stream's chunks: ``_stream`` is its
    state dict while a stream step runs, None offline."""

    _stream: Optional[Dict] = None


def causal_modules(net: nn.Module) -> List[Tuple[str, _Causal]]:
    """The modules under `net` (itself included) that carry stream state,
    by name."""
    return [(n, m) for n, m in net.named_modules() if isinstance(m, _Causal)]


@contextlib.contextmanager
def streaming(modules: Sequence[Tuple[str, "_Causal"]], state: Dict[str, Dict]):
    """Bind each causal module of `modules` (name, module) to its dict in
    `state` for one stream step. One step at a time a network."""
    for name, m in modules:
        m._stream = state.setdefault(name, {})
    try:
        yield
    finally:
        for _, m in modules:
            m._stream = None


class CumLN1d(_Causal):
    """Cumulative layer norm over [B, C, T] (generator5_24k.py cLN:12-49)."""

    def __init__(self, channels: int):
        super().__init__()
        self.gain = nn.Parameter(torch.ones(1, channels, 1))
        self.bias = nn.Parameter(torch.zeros(1, channels, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[1]
        sums, pows = x.sum(1, keepdim=True), (x ** 2).sum(1, keepdim=True)
        if self._stream is not None:
            mean, var = _stream_cum_stats(self._stream, sums, pows, c)
        else:
            mean, var = _cumulative_stats(sums, pows, c)
        return (x - mean) * torch.rsqrt(var + EPS_1D) * self.gain + self.bias


class CumLN2d(_Causal):
    """Cumulative layer norm over the channels of [B, C, T, F], per
    frequency (CumLN2d:342-362)."""

    def __init__(self, channels: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(1, channels, 1, 1))
        self.beta = nn.Parameter(torch.zeros(1, channels, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[1]
        sums, pows = x.sum(1, keepdim=True), (x ** 2).sum(1, keepdim=True)
        if self._stream is not None:
            mean, var = _stream_cum_stats(self._stream, sums, pows, c)
        else:
            mean, var = _cumulative_stats(sums, pows, c)
        return (x - mean) * torch.rsqrt(var + EPS_2D) * self.gamma + self.beta


class CausalConv2d(_Causal):
    """Conv with left-only time padding and symmetric frequency padding
    (:365-389)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: Tuple[int, int],
                 dilation: Tuple[int, int] = (1, 1), groups: int = 1, bias: bool = True):
        super().__init__()
        kt, kf = kernel_size
        self.pt = (kt - 1) * dilation[0]
        self.pf = (kf - 1) * dilation[1] // 2
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, dilation=dilation,
                              groups=groups, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._stream is not None and self.pt > 0:
            x = F.pad(_stream_context(self._stream, x, self.pt), (self.pf, self.pf))
        else:
            x = F.pad(x, (self.pf, self.pf, self.pt, 0))
        return self.conv(x)


def gate(x: torch.Tensor) -> torch.Tensor:
    a, g = torch.chunk(x, 2, dim=1)
    return a * torch.sigmoid(g)


class Gate(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gate(x)


class SeChannelModule(nn.Module):
    """Frequency-pooled channel attention with causal time smoothing
    (:458-471)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = CausalConv2d(channels, channels, (3, 1), bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.conv(x.mean(3, keepdim=True))  # [B, C, T, 1]


class SeFreqModule(nn.Module):
    """Channel-pooled frequency attention (:474-489): F as the channels of
    a 1x1 conv."""

    def __init__(self, freq_dim: int):
        super().__init__()
        self.conv = CausalConv2d(freq_dim, freq_dim, (1, 1), bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pooled = x.mean(1).transpose(1, 2)[..., None]  # [B, F, T, 1]
        return x * self.conv(pooled).permute(0, 3, 2, 1)  # [B, 1, T, F]


def require_streamable(norm: str) -> None:
    if norm != "CLN":
        # the BN / IN substitutes normalize over the whole T axis: not
        # causal, so they cannot be carried across chunks
        raise NotImplementedError(f"Streaming requires norm='CLN', got {norm}")


def get_norm(norm: str, channels: int) -> nn.Module:
    """CLN: the cumulative layer norm; BN, SyncBN and IN: a batch-independent
    substitute, GroupNorm(1) (layer norm over C, T, F) at eps 1e-5, which a
    stream refuses (``require_streamable``)."""
    if norm == "CLN":
        return CumLN2d(channels)
    if norm in ("BN", "SyncBN", "IN"):
        return nn.GroupNorm(1, channels, eps=1e-5)
    raise NotImplementedError(f"Unsupported normalization: {norm}")


class GLFB(nn.Module):
    """Gated local-frequency block (:506-541)."""

    def __init__(self, channels: int, kernel_size: Tuple[int, int] = (3, 3),
                 dilation: Tuple[int, int] = (1, 1), norm: str = "CLN", freq_dim: int = 480):
        super().__init__()
        c = channels
        self.first_block = nn.Sequential(
            get_norm(norm, c),
            nn.Conv2d(c, 2 * c, 1, bias=False),
            CausalConv2d(2 * c, 2 * c, kernel_size, dilation=dilation, groups=2 * c),
            Gate(),
            SeChannelModule(c),
            SeFreqModule(freq_dim),
            nn.Conv2d(c, c, 1, bias=False),
        )
        self.second_block = nn.Sequential(
            get_norm(norm, c),
            nn.Conv2d(c, 2 * c, 1, bias=False),
            Gate(),
            nn.Conv2d(c, c, 1, bias=False),
        )
        self.beta = nn.Parameter(torch.ones(1, c, 1, 1))
        self.gamma = nn.Parameter(torch.ones(1, c, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.first_block(x) * self.beta
        return x + self.second_block(x) * self.gamma


def _prelu() -> nn.PReLU:
    return nn.PReLU(1, init=0.01)  # Flax's PReLU: one slope, initialized at 0.01


class DepthConv1d(_Causal):
    """Causal dilated depthwise TCN block over [B, C, T] (:158-205)."""

    def __init__(self, input_channel: int, hidden_channel: int, kernel: int = 3,
                 dilation: int = 1):
        super().__init__()
        self.pad = (kernel - 1) * dilation
        self.conv1d = nn.Conv1d(input_channel, hidden_channel, 1)
        self.nonlinearity1 = _prelu()
        self.reg1 = CumLN1d(hidden_channel)
        self.dconv1d = nn.Conv1d(hidden_channel, hidden_channel, kernel, dilation=dilation,
                                 groups=hidden_channel)
        self.nonlinearity2 = _prelu()
        self.reg2 = CumLN1d(hidden_channel)
        self.res_out = nn.Conv1d(hidden_channel, input_channel, 1)
        self.skip_out = nn.Conv1d(hidden_channel, input_channel, 1)

    def forward(self, x: torch.Tensor):
        h = self.reg1(self.nonlinearity1(self.conv1d(x)))
        if self._stream is not None:
            h = _stream_context(self._stream, h, self.pad)
        else:
            h = F.pad(h, (self.pad, 0))
        h = self.reg2(self.nonlinearity2(self.dconv1d(h)))
        return self.res_out(h), self.skip_out(h)


class TCN(nn.Module):
    """Causal TCN bottleneck (:209-297): the blocks' skip outputs summed."""

    def __init__(self, input_dim: int, output_dim: int, BN_dim: int, hidden_dim: int,
                 layer: int = 6, stack: int = 2, kernel: int = 3):
        super().__init__()
        self.LN = CumLN1d(input_dim)
        self.BN = nn.Conv1d(input_dim, BN_dim, 1)
        self.TCN = nn.ModuleList(
            DepthConv1d(BN_dim, hidden_dim, kernel, dilation=2 ** i)
            for _ in range(stack) for i in range(layer))
        self.output = nn.Sequential(_prelu(), nn.Conv1d(BN_dim, output_dim, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.BN(self.LN(x))
        skip_sum = 0.0
        for block in self.TCN:
            res, skip = block(h)
            h = h + res
            skip_sum = skip_sum + skip
        return self.output(skip_sum)


class PixelShuffleBlock(nn.Module):
    """Causal 3x3 conv, then a x UPSCALE shuffle of channels into frequency
    (:392-437)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = CausalConv2d(in_channels, out_channels * UPSCALE, (3, 3), bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv(x)
        b, c, t, f = h.shape
        h = h.reshape(b, c // UPSCALE, UPSCALE, t, f).transpose(2, 3)
        return h.reshape(b, c // UPSCALE, t, UPSCALE * f)


class DownBlock(nn.Module):
    def __init__(self, channels: int, out_channels: int, depth: int,
                 kernel_size: Tuple[int, int], norm: str, freq_dim: int):
        super().__init__()
        self.glfb = nn.ModuleList(
            GLFB(channels, kernel_size, dilation=(2 ** d, 1), norm=norm, freq_dim=freq_dim)
            for d in range(depth))
        # frequency downsample x2: kernel (1, 6), stride (1, 2), pad (0, 2)
        self.conv = nn.Conv2d(channels, out_channels, (1, 6), stride=(1, 2), padding=(0, 2),
                              bias=False)


class UpBlock(nn.Module):
    def __init__(self, in_channels: int, channels: int, depth: int,
                 kernel_size: Tuple[int, int], norm: str, freq_dim: int):
        super().__init__()
        self.deconv = PixelShuffleBlock(in_channels, channels)
        self.glfb = nn.ModuleList(
            GLFB(channels, kernel_size, dilation=(2 ** d, 1), norm=norm, freq_dim=freq_dim)
            for d in range(depth))


class CSMGAN(nn.Module):
    """Encoder, TCN, decoder over [B, 2, T, F] spectra (:603-688).

    Parameters are initialized from ``seed`` as use_tpu's Flax defaults
    (LeCun-normal kernels, unit norm gains, PReLU slopes 0.01), except the
    conv biases, drawn as torch's (and the reference's) U(+-1/sqrt(fan_in)):
    with zero biases, digitally silent frames at the start of a clip stay
    exactly 0 through every conv, where the cumulative norms' variance is
    0 and rsqrt(var + eps) multiplies the backward by 1e3 / 1e4 a norm, and
    through the TCN's 25 the gradient overflows (use_tpu's init does)."""

    def __init__(self, in_proj_channels: int = 8,
                 encoder_channels: Sequence[int] = (8, 8, 16, 16, 24),
                 encoder_depths: Sequence[int] = (1, 2, 1, 2),
                 encoder_glfb_kernel: Tuple[int, int] = (3, 3), tcn_input_dim: int = 720,
                 tcn_bn_dim: int = 600, tcn_hidden_dim: int = 600, tcn_layers: int = 6,
                 tcn_stacks: int = 2, tcn_kernel: int = 3,
                 decoder_depths: Sequence[int] = (1, 2, 1, 2),
                 decoder_glfb_kernel: Tuple[int, int] = (3, 3), glfb_norm: str = "CLN",
                 input_freq: int = 480, seed: int = 0):
        super().__init__()
        self.glfb_norm = glfb_norm
        enc = tuple(encoder_channels)
        self.in_proj = CausalConv2d(2, in_proj_channels, (3, 3))
        self.encoder = nn.ModuleList(
            DownBlock(enc[i], enc[i + 1], depth, tuple(encoder_glfb_kernel), glfb_norm,
                      input_freq // 2 ** i)
            for i, depth in enumerate(encoder_depths))
        self.bottleneck = TCN(tcn_input_dim, tcn_input_dim, tcn_bn_dim, tcn_hidden_dim,
                              layer=tcn_layers, stack=tcn_stacks, kernel=tcn_kernel)
        up: List[UpBlock] = []
        ch = enc[len(encoder_depths)]
        for i, depth in enumerate(decoder_depths):
            out_ch = enc[-i - 2]
            up.append(UpBlock(ch, out_ch, depth, tuple(decoder_glfb_kernel), glfb_norm,
                              input_freq // 2 ** (len(encoder_depths) - i - 1)))
            ch = out_ch
        self.decoder = nn.ModuleList(up)
        self.out_proj = CausalConv2d(ch, 2, (3, 3))
        gen = torch.Generator().manual_seed(seed)
        reset_parameters(self, gen)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv1d, nn.Conv2d)) and m.bias is not None:
                    bound = 1.0 / m.weight[0].numel() ** 0.5
                    m.bias.uniform_(-bound, bound, generator=gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.in_proj(x)
        skips = []
        for block in self.encoder:
            for g in block.glfb:
                x = g(x)
            skips.append(x)
            x = block.conv(x)
        b, c, t, f = x.shape
        # the TCN's channels are (C, F) flattened channel-major (:679-682)
        flat = self.bottleneck(x.transpose(2, 3).reshape(b, c * f, t))
        x = flat.reshape(b, c, f, t).transpose(2, 3)
        for block, skip in zip(self.decoder, reversed(skips)):
            x = block.deconv(x) + skip
            for g in block.glfb:
                x = g(x)
        return self.out_proj(x)


def _weights_key(net: nn.Module) -> Optional[tuple]:
    """What tells the net's weights apart without reading them: each
    parameter's storage and count of in-place updates. None where a
    parameter is an inference tensor, whose updates leave no trace."""
    params = list(net.parameters())
    if any(p.is_inference() for p in params):
        return None
    return tuple((p.data_ptr(), p._version) for p in params)


@GeneratorRegistry.register("csmgan")
class CSMGANWrapper:
    """Batch-dict wrapper with the STFT front-end (:691-761), in the LSGAN
    generator interface (models/gan/generator.py::Generator). The forward
    is crop-free, in training too: ``draw_start`` draws nothing.

    device: 'cuda' (default) or 'cpu'; CUDA without a card raises.
    seed: seed of the network's initialization.
    """

    def __init__(self, n_fft: int = 960, win_length: int = 960, hop_length: int = 480,
                 window: str = "hann", sampling_rate: int = 24000,
                 compression: Optional[str] = None, input_freq: int = 480,
                 device="cuda", seed: int = 0, **net_kwargs):
        self.device = resolve_device(device)
        self.feature = STFTFeature(n_fft=n_fft, win_length=win_length, hop_length=hop_length,
                                   window=window, sampling_rate=sampling_rate,
                                   compression=compression, inverse_keys=["fake"])
        net_kwargs = {k: tuple(v) if isinstance(v, list) else v for k, v in net_kwargs.items()}
        self.net = CSMGAN(input_freq=input_freq, seed=seed, **net_kwargs).to(self.device)
        # the discriminator-init wav length of use_tpu's LSGAN.init_params
        self.target_len = input_freq * hop_length

    # the last TCN block's res_out reaches no output (use_tpu's net as the
    # reference's): under DDP the reducer must look for unused parameters
    ddp_find_unused_parameters = True

    def draw_start(self, length: int, generator: Optional[torch.Generator] = None) -> int:
        return 0

    def cast_for_inference(self) -> None:
        """The network serves in fp32: nothing to cast."""

    def forward(self, batch: Batch) -> Batch:
        """Drop the Nyquist bin, the net, the bin back, the inverse STFT:
        writes batch['fake'], [B, L] as batch['perturbed']."""
        out = self.feature(batch)
        spec = out["perturbed_spectra"]  # [B, F, T, 2]
        y = self.net(spec.permute(0, 3, 2, 1)[..., :-1])  # [B, 2, T, F - 1]
        out["fake_spectra"] = F.pad(y, (0, 1)).permute(0, 3, 2, 1)
        return self.feature.inverse(out)

    @torch.inference_mode()
    def forward_infer(self, batch: Batch) -> Batch:
        return self.forward({**batch, "perturbed": torch.as_tensor(batch["perturbed"],
                                                                   device=self.device)})

    def __call__(self, batch: Batch, generator: Optional[torch.Generator] = None,
                 train: bool = False, start: Optional[int] = None) -> Batch:
        return self.forward(batch) if train else self.forward_infer(batch)

    @torch.inference_mode()
    def enhance_streaming(self, wav, chunk_frames: int = 4,
                          session: Optional["CSMGANStream"] = None):
        """Enhance [B, L] chunk by chunk through a CSMGANStream: L padded up
        to a whole chunk, streamed, flushed and cut back to L. -> (enhanced
        [B, L], session); pass the session back for the next call: it is
        reused (reset) where it was made by this wrapper for these weights
        (no parameter replaced or updated in place since), batch and
        chunk_frames, and made anew otherwise."""
        wav = torch.as_tensor(wav, dtype=torch.float32, device=self.device)
        b, length = wav.shape
        cs = chunk_frames * self.feature.hop_length
        wav = F.pad(wav, (0, (-length) % cs))
        key = _weights_key(self.net)
        if (session is None or session.wrapper is not self or session.batch != b
                or session.k != chunk_frames or key is None or session.weights != key):
            session = CSMGANStream(self, batch_size=b, chunk_frames=chunk_frames)
        else:
            session.reset()
        pieces = [session.step(wav[:, i : i + cs]) for i in range(0, wav.shape[1], cs)]
        pieces.append(session.flush())
        return torch.cat(pieces, dim=1)[:, :length], session


class CSMGANStream:
    """Streaming enhancement session: chunked wav in, enhanced wav out
    (use_tpu csmgan.py:475-652).

    Each causal module carries its left time context or cumulative
    statistics across chunks, so chunk-wise outputs equal one offline
    ``CSMGANWrapper.forward`` over the whole utterance. A chunk's frames go
    through a windowed real FFT (``frames_rfft``, use_tpu's DFT-matrix
    product), the streaming network, the windowed inverse
    (``frames_irfft``) and an overlap-add divided by the window-square
    envelope.

    Framing (centred STFT, n_fft = 2 hop): ``step`` takes chunk_frames x hop
    samples and emits as many, one hop late (the lookahead of centred
    frames); the first step emits chunk - hop samples, reflect-priming the
    centre pad, and ``flush`` emits the last hop from the reflected end
    frame, so a hop-aligned input comes out as long as it went in.
    """

    def __init__(self, wrapper: CSMGANWrapper, batch_size: int = 1, chunk_frames: int = 4):
        feat = wrapper.feature
        self.hop, self.n_fft = feat.hop_length, feat.n_fft
        if feat.cfg.wl != self.n_fft or self.n_fft != 2 * self.hop:
            raise NotImplementedError(
                "CSMGANStream requires win_length == n_fft == 2*hop "
                f"(got n_fft={self.n_fft}, win={feat.cfg.wl}, hop={self.hop})")
        if chunk_frames < 2:
            raise ValueError("chunk_frames must be >= 2 (reflect priming)")
        require_streamable(wrapper.net.glfb_norm)
        self.wrapper = wrapper
        self.weights = _weights_key(wrapper.net)
        self.k = chunk_frames
        self.chunk_samples = chunk_frames * self.hop
        self.batch = batch_size
        self.cfg = feat.cfg
        self.compression = feat.compression
        self.freqs = self.n_fft // 2 + 1
        self._causal = causal_modules(wrapper.net)
        wsq = window_sq(self.n_fft, self.n_fft, feat.window)
        env = wsq[: self.hop] + wsq[self.hop :]
        self._env = torch.as_tensor(np.where(env > 1e-11, env, 1.0), dtype=torch.float32,
                                    device=wrapper.device)
        self.reset()

    def reset(self) -> None:
        """Zero every carried state, to start a new stream."""
        dev = self.wrapper.device
        self.state = {
            "net": {},  # per causal module, filled with zeros at the first step
            # the last hop + 1 raw input samples (the + 1 feeds flush's reflection)
            "wav_ctx": torch.zeros((self.batch, self.hop + 1), device=dev),
            # the pending, unnormalized overlap-add tail
            "ola": torch.zeros((self.batch, self.hop), device=dev),
        }
        self._started = False
        self._flushed = False

    def _step(self, sig_new: torch.Tensor, k: int, update_wav_ctx: bool = True) -> torch.Tensor:
        """One chunk of k frames: the padded-signal window [B, (k + 1) hop]
        (one hop of carried context and the k new hops) -> the k hops the
        overlap-add completes."""
        hop, f, st = self.hop, self.freqs, self.state
        sig = torch.cat([st["wav_ctx"][:, 1:], sig_new], dim=1)
        spec = frames_rfft(sig.unfold(1, self.n_fft, hop), self.cfg)  # [B, k, F, 2]
        if self.compression is not None:
            mag, unit = mag_unit_phase(spec)
            spec = _compress(mag, self.compression)[..., None] * unit
        with streaming(self._causal, st["net"]):
            y = self.wrapper.net(spec[:, :, : f - 1].permute(0, 3, 1, 2))  # [B, 2, k, F - 1]
        y = F.pad(y, (0, 1)).permute(0, 2, 3, 1)  # [B, k, F, 2]
        if self.compression is not None:
            mag, unit = mag_unit_phase(y)
            y = _decompress(mag, self.compression)[..., None] * unit
        halves = frames_irfft(y, self.cfg).reshape(self.batch, k, 2, hop)
        acc = F.pad(halves[:, :, 0], (0, 0, 0, 1)) + F.pad(halves[:, :, 1], (0, 0, 1, 0))
        acc[:, 0] += st["ola"]  # [B, k + 1, hop]
        if update_wav_ctx:
            st["wav_ctx"] = sig[:, -hop - 1 :]
        st["ola"] = acc[:, k]
        return (acc[:, :k] / self._env).reshape(self.batch, k * hop)

    @torch.inference_mode()
    def step(self, chunk) -> torch.Tensor:
        """Feed [B, chunk_frames * hop] samples; -> the samples ready:
        chunk - hop on the first call (the framing's lookahead), a whole
        chunk afterwards."""
        if self._flushed:
            raise RuntimeError("stream already flushed; start a new session")
        chunk = torch.as_tensor(chunk, dtype=torch.float32, device=self.wrapper.device)
        if tuple(chunk.shape) != (self.batch, self.chunk_samples):
            raise ValueError(f"chunk of shape {tuple(chunk.shape)}, the session takes "
                             f"{(self.batch, self.chunk_samples)}")
        if self._started:
            return self._step(chunk, self.k)
        # the centred STFT's reflect pre-pad: pad[i] = x[hop - i]
        prime = chunk[:, 1 : self.hop + 1].flip(1)
        self.state["wav_ctx"] = torch.cat([chunk.new_zeros((self.batch, 1)), prime], dim=1)
        self._started = True
        return self._step(chunk, self.k)[:, self.hop :]

    @torch.inference_mode()
    def flush(self) -> torch.Tensor:
        """End of stream: -> the last hop of samples, synthesized from the
        last centred frame, the carried context and its reflection
        (torch.stft's end padding)."""
        if self._flushed:
            raise RuntimeError("stream already flushed; start a new session")
        if not self._started:
            raise RuntimeError("flush() before any step()")
        self._flushed = True
        endpad = self.state["wav_ctx"][:, : self.hop].flip(1)  # x[L - 2 - i], i = 0 .. hop - 1
        return self._step(endpad, 1, update_wav_ctx=False)
