"""Speech metrics of the port: SI-SDR.

Port of use_tpu/utils/metrics.py::si_sdr (reference other.py:105-108). The
rest of use_tpu's metrics (PESQ, ESTOI, energy ratios, LSD) come with
``eval``, which is not ported yet.
"""
from __future__ import annotations

import numpy as np


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
