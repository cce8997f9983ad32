"""Mel spectrograms and magnitude spectrograms.

Port of use_tpu/ops/mel.py: torchaudio.transforms.MelSpectrogram /
Spectrogram semantics (power 1, center=True, reflect pad, periodic hann
window centre-padded to n_fft where win_length is shorter, HTK mel scale,
no filterbank norm), as the mel discriminators and the reconstruction
criterion use them. The filterbank is built once per configuration in
float64 on the host and applied as one matmul.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from use_tpu_torch.ops.stft import STFTConfig, stft


def hz_to_mel(f: np.ndarray) -> np.ndarray:
    """HTK mel scale (torchaudio's default)."""
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def mel_to_hz(m: np.ndarray) -> np.ndarray:
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=None)
def mel_filterbank(n_freqs: int, n_mels: int, sample_rate: int, f_min: float = 0.0,
                   f_max: Optional[float] = None) -> np.ndarray:
    """Triangular HTK filterbank [n_freqs, n_mels] (torchaudio
    melscale_fbanks, norm=None), float32."""
    f_max = f_max if f_max is not None else sample_rate / 2.0
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    f_pts = mel_to_hz(np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2))
    f_diff = f_pts[1:] - f_pts[:-1]  # [n_mels + 1]
    slopes = f_pts[None, :] - all_freqs[:, None]  # [n_freqs, n_mels + 2]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


@dataclass(frozen=True)
class MelConfig:
    sample_rate: int = 24000
    n_fft: int = 2048
    win_length: Optional[int] = None
    hop_length: int = 240
    n_mels: int = 128
    f_min: float = 0.0
    f_max: Optional[float] = None
    power: float = 1.0

    @property
    def stft_cfg(self) -> STFTConfig:
        return STFTConfig(n_fft=self.n_fft, hop_length=self.hop_length,
                          win_length=self.win_length, window="hann")


def spectrogram(x: torch.Tensor, cfg: STFTConfig, power: float = 1.0) -> torch.Tensor:
    """Magnitude (power 1) or power spectrogram [..., F, T] of [..., L];
    the 1e-24 inside the sqrt keeps its gradient finite at silence."""
    spec = stft(x, cfg)
    mag = torch.sqrt(torch.sum(spec * spec, dim=-1) + 1e-24)
    return mag if power == 1.0 else mag ** power


def melspectrogram(x: torch.Tensor, cfg: MelConfig = MelConfig()) -> torch.Tensor:
    """[..., L] -> mel magnitude [..., n_mels, T]."""
    mag = spectrogram(x, cfg.stft_cfg, cfg.power)  # [..., F, T]
    fb = torch.from_numpy(mel_filterbank(cfg.n_fft // 2 + 1, cfg.n_mels, cfg.sample_rate,
                                         cfg.f_min, cfg.f_max)).to(mag.device)
    return torch.einsum("...ft,fm->...mt", mag, fb)
