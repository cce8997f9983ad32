"""STFT / iSTFT front-end on torch.stft / torch.istft.

Port of use_tpu/ops/stft.py. use_tpu computes the 1022-point real DFT as
matmuls built to match ``torch.stft(center=True, pad_mode='reflect',
onesided=True, window=periodic hann)`` and ``torch.istft`` (use_tpu
stft.py:1-20, 136-215); here those two calls are the implementation.

Complex spectra keep use_tpu's layout at every public function: a trailing
real pair ``[..., F, T, 2]`` (index 0 = real, 1 = imag).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


def get_window(window: str, win_length: int) -> np.ndarray:
    """Periodic windows matching torch.hann_window/hamming_window defaults.

    Reference parity: model_wrapper.py:14-20 ('hann' | 'sqrthann'),
    feature/stft.py:85-88 ('hann' | 'hamm').
    """
    n = np.arange(win_length, dtype=np.float64)
    if window in ("hann", "sqrthann"):
        w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
        if window == "sqrthann":
            w = np.sqrt(w)
    elif window == "hamm":
        w = 0.54 - 0.46 * np.cos(2.0 * np.pi * n / win_length)
    else:
        raise NotImplementedError(f"Window type {window} not implemented!")
    return w


@dataclass(frozen=True)
class STFTConfig:
    """Static STFT parameters."""

    n_fft: int = 1022
    hop_length: int = 160
    win_length: Optional[int] = None
    window: str = "hann"
    center: bool = True
    pad_mode: str = "reflect"

    @property
    def wl(self) -> int:
        return self.win_length if self.win_length is not None else self.n_fft

    @property
    def freqs(self) -> int:
        return self.n_fft // 2 + 1


def _window(cfg: STFTConfig, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(
        get_window(cfg.window, cfg.wl), dtype=torch.float32, device=like.device
    )


def _padded_window(n_fft: int, win_length: int, window: str) -> np.ndarray:
    """The window centre-padded to n_fft, as torch.stft pads a shorter one."""
    w = get_window(window, win_length)
    lpad = (n_fft - win_length) // 2
    return np.pad(w, (lpad, n_fft - win_length - lpad))


def window_sq(n_fft: int, win_length: int, window: str) -> np.ndarray:
    """The squared window over n_fft samples, float32: the envelope an
    overlap-add of synthesized frames is divided by (use_tpu
    stft.py::_window_sq)."""
    return (_padded_window(n_fft, win_length, window) ** 2).astype(np.float32)


def frames_rfft(frames: torch.Tensor, cfg: STFTConfig) -> torch.Tensor:
    """Windowed one-sided DFT of frames [..., n_fft] -> [..., F, 2]: one
    frame of ``stft`` (use_tpu's ``frames @ _dft_matrices()[0]``)."""
    w = torch.as_tensor(_padded_window(cfg.n_fft, cfg.wl, cfg.window), dtype=torch.float32,
                        device=frames.device)
    return torch.view_as_real(torch.fft.rfft(frames.float() * w, n=cfg.n_fft))


def frames_irfft(spec: torch.Tensor, cfg: STFTConfig) -> torch.Tensor:
    """Windowed frame synthesis [..., F, 2] -> [..., n_fft], before the
    overlap-add (use_tpu's ``spec @ _dft_matrices()[1]``): the imaginary
    parts of the DC and Nyquist bins do not enter, as in the matrix."""
    w = torch.as_tensor(_padded_window(cfg.n_fft, cfg.wl, cfg.window), dtype=torch.float32,
                        device=spec.device)
    z = torch.view_as_complex(spec.float().contiguous())
    return torch.fft.irfft(z, n=cfg.n_fft) * w


def reflect_pad(x: torch.Tensor, left: int, right: Optional[int] = None) -> torch.Tensor:
    """Reflect-pad the last axis by `left` and `right` (default `left`)
    samples, as numpy's (and jnp.pad's) mode='reflect': a pad longer than
    the signal reflects again at each end, where torch's reflect pad
    raises. One gather, whose backward has a deterministic CUDA
    implementation (torch's reflection pad's has none)."""
    right = left if right is None else right
    length = x.shape[-1]
    period = max(2 * (length - 1), 1)
    idx = torch.remainder(torch.arange(-left, length + right, device=x.device), period)
    return x[..., torch.where(idx >= length, period - idx, idx)]


def stft(x: torch.Tensor, cfg: STFTConfig = STFTConfig()) -> torch.Tensor:
    """STFT of real signal [..., L] -> spectrum [..., F, T, 2]. A window
    shorter than n_fft is centre-padded to it (torch.stft's and use_tpu's
    `_dft_matrices`); the centre's reflect pad is ``reflect_pad``'s, so a pad
    longer than the signal reflects again, as use_tpu's jnp.pad does."""
    batch_shape = x.shape[:-1]
    x = x.reshape(-1, x.shape[-1]).float()
    center = cfg.center
    if center and cfg.pad_mode == "reflect":
        x, center = reflect_pad(x, cfg.n_fft // 2), False
    spec = torch.stft(
        x, n_fft=cfg.n_fft, hop_length=cfg.hop_length,
        win_length=cfg.wl, window=_window(cfg, x), center=center,
        pad_mode=cfg.pad_mode, normalized=False, onesided=True, return_complex=True,
    )  # [B, F, T] complex
    spec = torch.view_as_real(spec)
    return spec.reshape(batch_shape + spec.shape[1:])


def istft(
    spec: torch.Tensor, cfg: STFTConfig = STFTConfig(), length: Optional[int] = None
) -> torch.Tensor:
    """Inverse STFT of [..., F, T, 2] -> [..., L] (torch.istft semantics:
    with an explicit `length`, only the leading centre pad is dropped and the
    signal is cut or zero-padded to `length`)."""
    batch_shape = spec.shape[:-3]
    f, t, _ = spec.shape[-3:]
    if f != cfg.freqs:
        raise ValueError(f"spectrum has {f} bins, STFT config expects {cfg.freqs}")
    z = torch.view_as_complex(spec.reshape(-1, f, t, 2).float().contiguous())
    sig = torch.istft(
        z, n_fft=cfg.n_fft, hop_length=cfg.hop_length, win_length=cfg.wl,
        window=_window(cfg, spec), center=cfg.center, normalized=False,
        onesided=True, length=length,
    )
    return sig.reshape(batch_shape + sig.shape[1:])


def spec_fwd(spec: torch.Tensor, factor: float = 0.15, abs_exponent: float = 0.5) -> torch.Tensor:
    """|s|^e * e^{i angle(s)} * factor on a real-pair spectrum [..., 2].

    Reference parity: model_wrapper.py:92-96. Computed as s * |s|^(e-1) with
    a zero-safe guard: exact-zero bins (zero-padded frames) map to zero.
    """
    if abs_exponent != 1.0:
        sq = torch.sum(spec * spec, dim=-1, keepdim=True)
        mag = torch.sqrt(torch.where(sq > 0, sq, torch.ones_like(sq)))
        spec = spec * torch.where(sq > 0, mag ** (abs_exponent - 1.0), torch.zeros_like(sq))
    return spec * factor


def spec_back(spec: torch.Tensor, factor: float = 0.15, abs_exponent: float = 0.5) -> torch.Tensor:
    """Inverse of spec_fwd (model_wrapper.py:98-103)."""
    spec = spec / factor
    if abs_exponent != 1.0:
        sq = torch.sum(spec * spec, dim=-1, keepdim=True)
        mag = torch.sqrt(torch.where(sq > 0, sq, torch.ones_like(sq)))
        spec = spec * torch.where(
            sq > 0, mag ** (1.0 / abs_exponent - 1.0), torch.zeros_like(sq)
        )
    return spec


def pad_spec(spec: torch.Tensor, multiple: int = 64) -> torch.Tensor:
    """Zero-pad the time-frame axis of [..., F, T, C] to a multiple.

    Reference parity: util/other.py:128-135 (pads T to T%64==0 for U-Net depth).
    """
    num_pad = (-spec.shape[-2]) % multiple
    if num_pad == 0:
        return spec
    return torch.nn.functional.pad(spec, (0, 0, 0, num_pad))


def to_complex(pair: torch.Tensor) -> torch.Tensor:
    """[..., 2] real pair -> complex."""
    return torch.complex(pair[..., 0], pair[..., 1])


def from_complex(z: torch.Tensor) -> torch.Tensor:
    """complex -> [..., 2] real pair."""
    return torch.stack([z.real, z.imag], dim=-1)
