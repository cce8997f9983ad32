"""Native ESTOI — extended short-time objective intelligibility.

The port's copy of use_tpu/utils/intelligibility.py.

From-scratch numpy implementation of the published algorithm (J. Jensen and
C. H. Taal, "An Algorithm for Predicting the Intelligibility of Speech
Masked by Modulated Noise Maskers", IEEE/ACM TASLP 24(11), 2016). The
reference computes ESTOI through the external `pystoi` package during
per-epoch validation (reference src/models/components/sgmse/util/
inference.py:49-51); where that package is not installed the metric is
computed here, and `pystoi`, when present, is preferred
(utils/metrics.py::estoi).

Pipeline (all host-side numpy, standard DSP):
  1. resample ref/deg to 10 kHz,
  2. drop frames whose CLEAN energy is >40 dB below the loudest frame
     (256-sample Hann frames, 128 hop, overlap-add reconstruction),
  3. STFT (512-point FFT of 256-sample Hann frames, hop 128),
  4. 15 one-third-octave band energies, first center 150 Hz,
  5. 384 ms segments (30 frames, sliding by one frame): row- then
     column-normalize the 15x30 band-energy matrices of clean and degraded,
  6. ESTOI = mean over segments of the normalized inner product / 30.
"""
from __future__ import annotations

import numpy as np

FS = 10_000            # analysis rate (Hz)
FRAME_LEN = 256        # 25.6 ms analysis frames
HOP = 128
NFFT = 512
NUM_BANDS = 15         # one-third-octave bands
MIN_FREQ = 150.0       # center frequency of the lowest band (Hz)
SEG_FRAMES = 30        # 384 ms intelligibility segments
DYN_RANGE_DB = 40.0    # silent-frame threshold below the loudest frame
_EPS = np.finfo(np.float64).eps


def _hann(n: int) -> np.ndarray:
    """Periodic-interior Hann (MATLAB hanning(n): no zero endpoints)."""
    return np.hanning(n + 2)[1:-1]


def _frame(x: np.ndarray, flen: int, hop: int) -> np.ndarray:
    # open-range framing — frames start at 0, hop, ... while start+flen <
    # len(x) (pystoi's convention, kept for golden cross-compatibility)
    n = max(0, -(-(len(x) - flen) // hop))
    idx = np.arange(n)[:, None] * hop + np.arange(flen)[None, :]
    return x[idx]


def third_octave_matrix(
    fs: int = FS, nfft: int = NFFT, num_bands: int = NUM_BANDS,
    min_freq: float = MIN_FREQ,
) -> np.ndarray:
    """[num_bands, nfft//2+1] 0/1 matrix pooling FFT bins into 1/3-octave
    bands; band edges are snapped to the nearest FFT bin frequency."""
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(num_bands, dtype=np.float64)
    lo = min_freq * 2.0 ** ((2 * k - 1) / 6)
    hi = min_freq * 2.0 ** ((2 * k + 1) / 6)
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        lo_bin = int(np.argmin((f - lo[i]) ** 2))
        hi_bin = int(np.argmin((f - hi[i]) ** 2))
        obm[i, lo_bin:hi_bin] = 1.0
    return obm


def remove_silent_frames(
    x: np.ndarray, y: np.ndarray, dyn_range_db: float = DYN_RANGE_DB,
    flen: int = FRAME_LEN, hop: int = HOP,
):
    """Drop frames where the CLEAN signal is more than dyn_range_db below
    its loudest frame, from both signals, and overlap-add reconstruct."""
    w = _hann(flen)
    xf = _frame(x, flen, hop) * w
    yf = _frame(y, flen, hop) * w
    energies_db = 20 * np.log10(np.linalg.norm(xf, axis=1) + _EPS)
    mask = energies_db > np.max(energies_db) - dyn_range_db
    xf, yf = xf[mask], yf[mask]
    n = len(xf)
    out_len = (n - 1) * hop + flen if n else 0
    xs = np.zeros(out_len)
    ys = np.zeros(out_len)
    # raw overlap-add of the Hann-windowed frames (the 50%-overlap Hann is
    # constant-overlap-add; edges are re-windowed by the analysis below
    # identically for ref and deg) — pystoi's convention, unnormalized
    for i in range(n):
        sl = slice(i * hop, i * hop + flen)
        xs[sl] += xf[i]
        ys[sl] += yf[i]
    return xs, ys


def _band_energies(x: np.ndarray, obm: np.ndarray) -> np.ndarray:
    """[num_bands, num_frames] one-third-octave band magnitudes."""
    w = _hann(FRAME_LEN)
    frames = _frame(x, FRAME_LEN, HOP) * w
    spec = np.fft.rfft(frames, NFFT, axis=1)  # [T, F]
    power = np.abs(spec) ** 2
    return np.sqrt(obm @ power.T)  # [J, T]


def _row_col_normalize(seg: np.ndarray) -> np.ndarray:
    """Mean/variance-normalize rows then columns of [..., J, N] segments."""
    seg = seg - np.mean(seg, axis=-1, keepdims=True)
    seg = seg / (np.linalg.norm(seg, axis=-1, keepdims=True) + _EPS)
    seg = seg - np.mean(seg, axis=-2, keepdims=True)
    seg = seg / (np.linalg.norm(seg, axis=-2, keepdims=True) + _EPS)
    return seg


def estoi_np(ref: np.ndarray, deg: np.ndarray, sr: int = FS) -> float:
    """ESTOI in [-1, 1] (≈1 for intelligible / identical speech).

    ref/deg are 1-D waveforms at `sr`; resampled to 10 kHz internally.
    Raises ValueError when fewer than 30 analysis frames survive
    silent-frame removal (matching pystoi's warning condition).
    """
    ref = np.asarray(ref, dtype=np.float64).reshape(-1)
    deg = np.asarray(deg, dtype=np.float64).reshape(-1)
    n = min(len(ref), len(deg))
    ref, deg = ref[:n], deg[:n]
    if sr != FS:
        from use_tpu_torch.data.dsp import resample_poly

        ref = resample_poly(ref, sr, FS)
        deg = resample_poly(deg, sr, FS)
    ref, deg = remove_silent_frames(ref, deg)
    obm = third_octave_matrix()
    x = _band_energies(ref, obm)  # [J, T]
    y = _band_energies(deg, obm)
    if x.shape[1] < SEG_FRAMES:
        raise ValueError(
            f"ESTOI needs >= {SEG_FRAMES} frames after silent-frame "
            f"removal (got {x.shape[1]}); signal too short or silent"
        )
    # sliding 30-frame segments, hop one frame: [S, J, N]
    starts = np.arange(x.shape[1] - SEG_FRAMES + 1)
    idx = starts[:, None] + np.arange(SEG_FRAMES)[None, :]
    xs = _row_col_normalize(np.transpose(x[:, idx], (1, 0, 2)))
    ys = _row_col_normalize(np.transpose(y[:, idx], (1, 0, 2)))
    return float(np.mean(np.sum(xs * ys, axis=(1, 2)) / SEG_FRAMES))
