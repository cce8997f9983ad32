"""FRA-RIR: fast random approximation of room impulse responses (numpy).

The port's copy of use_tpu/data/fra_rir.py, bit-equal under the same seeds.

Re-implementation of the reference generator (reference:
src/data/components/FRA_RIR.py:7-123): sample T60 / source distances /
reflection counts, build a rescaled dirac comb at 64x the target rate,
two-stage downsample with an 80 Hz high-pass in between, and return both the
full RIR and the direct-path (first reflections) RIR used as the training
target.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import signal as sps

from use_tpu_torch.data.dsp import resample_poly


def _highpass_biquad(x: np.ndarray, sr: int, cutoff: float = 80.0, q: float = 0.707) -> np.ndarray:
    """RBJ high-pass biquad (torchaudio.functional.highpass_biquad)."""
    w0 = 2 * np.pi * cutoff / sr
    alpha = np.sin(w0) / (2 * q)
    cosw = np.cos(w0)
    b = np.array([(1 + cosw) / 2, -(1 + cosw), (1 + cosw) / 2])
    a = np.array([1 + alpha, -2 * cosw, 1 - alpha])
    return sps.lfilter(b / a[0], a / a[0], x, axis=-1)


def fra_rir(
    nsource: int = 1,
    sr: int = 16000,
    direct_range: Tuple[int, int] = (-6, 50),
    max_T60: float = 0.8,
    alpha: float = 0.25,
    a: float = -2.0,
    b: float = 2.0,
    tau: float = 0.2,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (rir [nsource, n], direct_rir [nsource, n]) at sample rate sr."""
    eps = np.finfo(np.float16).eps

    direct_dist = np.random.uniform(0.2, 12, nsource)
    t60 = np.random.uniform(0.05, max_T60)
    r_stat = np.random.uniform(0.1, 1.2)

    image = sr * 2
    ratio = 64
    sample_sr = sr * ratio
    velocity = 340.0

    direct_idx = np.ceil(direct_dist * sample_sr / velocity).astype(np.int64)
    rir_length = int(np.ceil(sample_sr * t60))

    reflect_coef = np.sqrt(1 - (1 - np.exp(-0.16 * r_stat / t60)) ** 2)

    # distance ratios sampled from a quadratic pdf over [1, vT60/d0 - 1]
    dist_prob = np.linspace(alpha, 1.0, image) ** 2
    dist_prob = dist_prob / dist_prob.sum()
    sel = np.random.choice(image, size=(nsource, image), p=dist_prob)
    dist_ratio = np.stack(
        [
            np.linspace(1.0, velocity * t60 / direct_dist[i] - 1, image)[sel[i]]
            for i in range(nsource)
        ]
    )
    dist = direct_dist[:, None] * dist_ratio

    reflect_max = (
        np.log10(velocity * t60) - np.log10(direct_dist) - 3
    ) / np.log10(reflect_coef + eps)
    reflect_ratio = (dist / (velocity * t60)) ** 2 * (reflect_max[:, None] - 1) + 1
    reflect_perturb = np.random.uniform(a, b, (nsource, image)) * dist_ratio ** tau
    reflect_ratio = np.maximum(reflect_ratio + reflect_perturb, 1.0)

    dist = np.concatenate([direct_dist[:, None], dist], axis=1)
    reflect_ratio = np.concatenate([np.zeros((nsource, 1)), reflect_ratio], axis=1)
    delta_idx = np.minimum(
        np.ceil(dist * sample_sr / velocity), rir_length - 1
    ).astype(np.int64)
    delta_decay = reflect_coef ** reflect_ratio / dist

    rir = np.zeros((nsource, rir_length))
    for i in range(nsource):
        np.add.at(rir[i], delta_idx[i], delta_decay[i])

    direct_mask = np.zeros((nsource, rir_length))
    for i in range(nsource):
        lo = max(direct_idx[i] + sample_sr * direct_range[0] // 1000, 0)
        hi = min(direct_idx[i] + sample_sr * direct_range[1] // 1000, rir_length)
        direct_mask[i, lo:hi] = 1.0
    rir_direct = rir * direct_mask

    mid_sr = sample_sr // int(np.sqrt(ratio))
    all_rir = np.concatenate([rir, rir_direct], axis=0)
    down1 = resample_poly(all_rir.T, sample_sr, mid_sr).T
    hp = _highpass_biquad(down1, mid_sr, 80.0)
    down2 = resample_poly(hp.T, mid_sr, sr).T.astype(np.float32)

    return down2[:nsource], down2[nsource:]
