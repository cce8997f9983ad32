"""Formant-synthesized pseudo-speech probes.

The port's copy of use_tpu/data/synth_speech.py, bit-equal under the same seeds.

A tiny source-filter speech synthesizer used by the learning quality gates
(tests/test_learning.py, scripts/soak_train_tpu.py) and metric property
tests so that "does the trained model enhance?" is measured on speech-LIKE
spectra — pitch contour, 2-3 formant resonances, voiced/unvoiced segments —
rather than on a stationary harmonic comb. This approximates the EARS clean
speech distribution the reference trains on
(reference src/data/components/comm_distort_simu_dataset.py get_clean,
1000-1223) closely enough for short overfit probes, with no corpus needed.

Classic source-filter model: a glottal pulse train (voiced) or white noise
(unvoiced) excitation, -12 dB/oct source rolloff, cascaded second-order
formant resonators, and a first-difference radiation filter.
"""
from __future__ import annotations

import numpy as np
from scipy.signal import lfilter

# (F1, F2, F3) Hz — canonical vowel formant targets plus a fricative-ish
# high-frequency shape for unvoiced segments
_VOWELS = [
    (730, 1090, 2440),   # /a/
    (270, 2290, 3010),   # /i/
    (300, 870, 2240),    # /u/
    (530, 1840, 2480),   # /e/
    (570, 840, 2410),    # /o/
]
_FRICATIVE = (1500, 3200, 4500)


def _resonator(x: np.ndarray, freq: float, bw: float, sr: int) -> np.ndarray:
    """Second-order all-pole resonance at `freq` with bandwidth `bw`."""
    r = np.exp(-np.pi * bw / sr)
    theta = 2 * np.pi * freq / sr
    a = [1.0, -2 * r * np.cos(theta), r * r]
    # unit gain at the resonance peak
    return lfilter([1.0 - r], a, x)


def synth_speech(
    length: int, seed: int, sr: int = 24000,
    f0_base: float | None = None,
) -> np.ndarray:
    """Pseudo-speech waveform of `length` samples, peak-normalized to 0.3.

    Segments of 60-180 ms alternate voiced (glottal pulse train through
    vowel formants, with a slowly drifting pitch contour) and unvoiced
    (noise through a fricative-shaped filter, lower energy), with brief
    pauses — yielding a speech-shaped long-term spectrum and the temporal
    modulation structure intelligibility metrics key on.
    """
    rng = np.random.default_rng(seed)
    if f0_base is None:
        f0_base = float(rng.uniform(100.0, 220.0))
    out = np.zeros(length, dtype=np.float64)
    pos = 0
    phase = 0.0
    state = "voiced"  # start voiced so even very short probes carry a vowel
    while pos < length:
        seg = int(sr * rng.uniform(0.06, 0.18))
        seg = min(seg, length - pos)
        if seg <= 0:
            break
        if state == "voiced":
            t = np.arange(seg)
            # slow intra-segment pitch drift (declination-like contour)
            f0 = f0_base * (1.0 + 0.15 * np.sin(
                2 * np.pi * rng.uniform(1.0, 3.0) * t / sr + rng.uniform(0, 6.28)
            ))
            inst_phase = phase + 2 * np.pi * np.cumsum(f0) / sr
            phase = float(inst_phase[-1]) % (2 * np.pi)
            # glottal pulse train: impulses at phase wraps
            pulses = np.zeros(seg)
            wraps = np.where(np.diff(np.mod(inst_phase, 2 * np.pi)) < 0)[0]
            pulses[wraps] = 1.0
            # -12 dB/oct source spectrum: double leaky integrator
            src = lfilter([1.0], [1.0, -0.96], pulses)
            src = lfilter([1.0], [1.0, -0.96], src)
            fmts = _VOWELS[int(rng.integers(len(_VOWELS)))]
            y = src
            for f, bw in zip(fmts, (60.0, 90.0, 120.0)):
                y = _resonator(y, f, bw, sr)
            y = np.diff(y, prepend=0.0)  # radiation (first difference)
            amp = rng.uniform(0.8, 1.0)
        else:
            src = rng.standard_normal(seg)
            y = src
            for f, bw in zip(_FRICATIVE, (300.0, 500.0, 700.0)):
                y = _resonator(y, f, bw, sr)
            y = np.diff(y, prepend=0.0)
            amp = rng.uniform(0.15, 0.3)
        peak = np.max(np.abs(y)) + 1e-12
        # 5 ms raised-cosine edges avoid segment-boundary clicks
        edge = min(seg // 2, int(0.005 * sr))
        if edge > 0:
            ramp = 0.5 - 0.5 * np.cos(np.pi * np.arange(edge) / edge)
            y[:edge] *= ramp
            y[-edge:] *= ramp[::-1]
        out[pos : pos + seg] = amp * y / peak
        pos += seg
        # occasional short pause between segments
        if rng.random() < 0.2:
            pos += int(sr * rng.uniform(0.02, 0.06))
        state = "unvoiced" if (state == "voiced" and rng.random() < 0.5) else "voiced"
    peak = np.max(np.abs(out)) + 1e-12
    return (0.3 * out / peak).astype(np.float32)


def synth_pair(
    length: int, seed: int, snr_db: float = 5.0, sr: int = 24000,
) -> tuple[np.ndarray, np.ndarray]:
    """(clean, noisy) pseudo-speech pair with white noise at `snr_db`."""
    rng = np.random.default_rng(seed + 77_000)
    clean = synth_speech(length, seed, sr=sr)
    noise = rng.standard_normal(length).astype(np.float32)
    noise *= np.sqrt(
        np.mean(clean**2) / np.mean(noise**2) / 10 ** (snr_db / 10)
    )
    return clean, (clean + noise).astype(np.float32)
