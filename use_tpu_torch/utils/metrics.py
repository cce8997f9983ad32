"""Speech quality and separation metrics, numpy on the host.

Port of use_tpu/utils/metrics.py (reference src/models/components/sgmse/
util/other.py:23-135 and util/inference.py:49-51): SI-SDR and its
components (SI-SIR, SI-SAR), LSD, WER, SNR, mean/std, ESTOI (`pystoi` where it
imports, else the native utils/intelligibility.py) and wide-band PESQ (the
optional `pesq` package; its key is absent without it), and
``evaluate_pair``, one utterance's metric dict.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from use_tpu_torch.data.dsp import np_stft, resample_poly


def si_sdr(s: np.ndarray, s_hat: np.ndarray) -> float:
    """Scale-invariant SDR of the estimate s_hat against the reference s, in dB."""
    min_len = min(len(s), len(s_hat))
    s, s_hat = s[:min_len], s_hat[:min_len]
    alpha = np.dot(s_hat, s) / (np.linalg.norm(s) ** 2 + 1e-12)
    return float(
        10 * np.log10(
            (np.linalg.norm(alpha * s) ** 2 + 1e-12)
            / (np.linalg.norm(alpha * s - s_hat) ** 2 + 1e-12)
        )
    )


def si_sdr_components(s_hat, s, n, eps=1e-10):
    """(target, noise, artifact) parts of s_hat (other.py:33-45)."""
    alpha_s = np.dot(s_hat, s) / (eps + np.linalg.norm(s) ** 2)
    s_target = alpha_s * s
    alpha_n = np.dot(s_hat, n) / (eps + np.linalg.norm(n) ** 2)
    e_noise = alpha_n * n
    return s_target, e_noise, s_hat - s_target - e_noise


def energy_ratios(s_hat, s, n, eps=1e-10) -> Tuple[float, float, float]:
    """(si_sdr, si_sir, si_sar) (other.py:48-62)."""
    s_target, e_noise, e_art = si_sdr_components(s_hat, s, n)
    target = np.linalg.norm(s_target) ** 2

    def ratio(e):
        return float(10 * np.log10(eps + target / (eps + np.linalg.norm(e) ** 2)))

    return ratio(e_noise + e_art), ratio(e_noise), ratio(e_art)


def lsd(s_hat: np.ndarray, s: np.ndarray, eps: float = 1e-10) -> float:
    """Log-spectral distance (other.py:23-30; n_fft 510, hop 128)."""
    lp_hat = 2 * np.log(eps + np.abs(np_stft(s_hat, 510, 128)))
    lp = 2 * np.log(eps + np.abs(np_stft(s, 510, 128)))
    return float(np.mean(np.sqrt(np.mean(np.abs(lp_hat - lp)))))


def wer(r, h) -> float:
    """Word error rate of the hypothesis `h` against the reference `r`
    (sequences of words) by the edit distance's dynamic program (other.py's
    wer(); an int32 table where the reference's uint8 one overflows)."""
    d = np.zeros((len(r) + 1, len(h) + 1), dtype=np.int32)
    d[:, 0] = np.arange(len(r) + 1)
    d[0, :] = np.arange(len(h) + 1)
    for i in range(1, len(r) + 1):
        for j in range(1, len(h) + 1):
            if r[i - 1] == h[j - 1]:
                d[i, j] = d[i - 1, j - 1]
            else:
                d[i, j] = 1 + min(d[i - 1, j - 1], d[i, j - 1], d[i - 1, j])
    return float(d[len(r), len(h)]) / max(len(r), 1)


def snr_db(s: np.ndarray, n: np.ndarray) -> float:
    """(other.py:118-122)."""
    return float(10 * np.log10(np.mean(s ** 2) / (np.mean(n ** 2) + 1e-12)))


def mean_std(data: np.ndarray) -> Tuple[float, float]:
    data = np.asarray(data)
    data = data[~np.isnan(data)]
    return float(np.mean(data)), float(np.std(data))


def pesq_wb(ref: np.ndarray, deg: np.ndarray, sr: int = 16000) -> float:
    """Wide-band PESQ through the optional `pesq` package (inference.py:49);
    ImportError without it."""
    try:
        from pesq import pesq as _pesq
    except ImportError as e:
        raise ImportError("PESQ requires the 'pesq' package (not installed)") from e
    return float(_pesq(sr, ref, deg, "wb"))


def estoi(ref: np.ndarray, deg: np.ndarray, sr: int = 10000) -> float:
    """Extended STOI (inference.py:51): `pystoi` where it imports, else the
    native numpy implementation (utils/intelligibility.py)."""
    try:
        from pystoi import stoi as _stoi
    except ImportError:
        from use_tpu_torch.utils.intelligibility import estoi_np

        return estoi_np(ref, deg, sr)
    return float(_stoi(ref, deg, sr, extended=True))


def evaluate_pair(clean: np.ndarray, enhanced: np.ndarray, noisy: np.ndarray,
                  sr: int = 24000) -> Dict[str, float]:
    """One utterance's metrics (util/inference.py:23-101): si_sdr, lsd,
    si_sir, si_sar, estoi (at 10 kHz; absent for a clip too short or silent
    for its 384 ms segments) and pesq_wb (at 16 kHz; absent without the
    `pesq` package)."""
    out = {"si_sdr": si_sdr(clean, enhanced), "lsd": lsd(enhanced, clean)}
    n = noisy[: len(clean)] - clean[: len(noisy)]
    _, sir, sar = energy_ratios(enhanced[: len(clean)], clean[: len(enhanced)], n)
    out.update({"si_sir": sir, "si_sar": sar})
    try:
        out["estoi"] = estoi(resample_poly(clean, sr, 10000),
                             resample_poly(enhanced, sr, 10000), 10000)
    except ValueError:
        pass  # too short or silent for the 384 ms segments
    try:
        out["pesq_wb"] = pesq_wb(resample_poly(clean, sr, 16000),
                                 resample_poly(enhanced, sr, 16000), 16000)
    except ImportError:
        pass
    return out
