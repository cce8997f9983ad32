"""Host-side numpy DSP helpers shared by the data pipeline.

The port's copy of use_tpu/data/dsp.py.

numpy STFT/iSTFT with librosa-compatible semantics (hann window, centered
reflect padding, one-sided) used by the spectral perturbations, plus small
envelope/filter utilities. Hot inner loops (dynamic-range compression
envelope, spectral hole punching) have C++ implementations in
use_tpu_torch/data/native.py with transparent numpy fallbacks.
"""
from __future__ import annotations

import numpy as np
from scipy import signal as sps


def hann(n: int) -> np.ndarray:
    return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)).astype(np.float64)


def np_stft(x: np.ndarray, n_fft: int = 2048, hop: int = 512, win_length=None) -> np.ndarray:
    """[L] -> complex [F, T]; centered, reflect-padded, hann (librosa.stft)."""
    win_length = win_length or n_fft
    w = hann(win_length)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        w = np.pad(w, (lpad, n_fft - win_length - lpad))
    pad = n_fft // 2
    xp = np.pad(x.astype(np.float64), (pad, pad), mode="reflect")
    t = 1 + len(x) // hop
    idx = np.arange(t)[:, None] * hop + np.arange(n_fft)[None, :]
    frames = xp[idx] * w[None, :]
    return np.fft.rfft(frames, axis=-1).T  # [F, T]


def np_istft(spec: np.ndarray, hop: int = 512, length=None, win_length=None) -> np.ndarray:
    """complex [F, T] -> [L]; window-squared OLA normalization."""
    f, t = spec.shape
    n_fft = (f - 1) * 2
    win_length = win_length or n_fft
    w = hann(win_length)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        w = np.pad(w, (lpad, n_fft - win_length - lpad))
    frames = np.fft.irfft(spec.T, n=n_fft, axis=-1) * w[None, :]
    full = (t - 1) * hop + n_fft
    out = np.zeros(full)
    env = np.zeros(full)
    wsq = w * w
    for i in range(t):
        out[i * hop : i * hop + n_fft] += frames[i]
        env[i * hop : i * hop + n_fft] += wsq
    out = out / np.where(env > 1e-11, env, 1.0)
    pad = n_fft // 2
    out = out[pad : full - pad]
    if length is not None:
        if len(out) >= length:
            out = out[:length]
        else:
            out = np.pad(out, (0, length - len(out)))
    return out


def fft_frequencies(sr: int, n_fft: int) -> np.ndarray:
    return np.linspace(0, sr / 2, n_fft // 2 + 1)


def resample_fft(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """FFT-domain resampling (scipy.signal.resample), the reference's
    'fft' resample_method."""
    if orig_sr == target_sr:
        return x
    n_out = int(round(len(x) * target_sr / orig_sr))
    return sps.resample(x, n_out)


def resample_poly(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    if orig_sr == target_sr:
        return x
    g = np.gcd(int(orig_sr), int(target_sr))
    return sps.resample_poly(x, target_sr // g, orig_sr // g)


def rms(x: np.ndarray, eps: float = 1e-12) -> float:
    return float(np.sqrt(np.mean(np.square(x)) + eps))


def compressor_envelope_np(
    level_db: np.ndarray, attack_coef: float, release_coef: float
) -> np.ndarray:
    """State-dependent one-pole smoothing of a level signal (numpy fallback;
    see use_tpu_torch/data/native.py for the C++ fast path)."""
    out = np.empty_like(level_db)
    state = level_db[0]
    for i in range(len(level_db)):
        x = level_db[i]
        coef = attack_coef if x > state else release_coef
        state = coef * state + (1.0 - coef) * x
        out[i] = state
    return out
