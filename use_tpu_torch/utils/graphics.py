"""Spectrogram figures for logging (matplotlib, on the host).

Port of use_tpu/utils/graphics.py (reference src/models/components/sgmse/
util/graphics.py:24-110): stacked noisy / estimate / clean spectrograms.
matplotlib is imported inside ``visualize_example``, so the module imports
where it is not installed.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from use_tpu_torch.data.dsp import np_stft


def spec_db(x: np.ndarray, n_fft: int = 512, hop: int = 128, eps: float = 1e-10) -> np.ndarray:
    return 20 * np.log10(np.abs(np_stft(np.asarray(x, np.float64), n_fft, hop)) + eps)


def visualize_example(noisy: np.ndarray, estimate: np.ndarray,
                      clean: Optional[np.ndarray] = None, sr: int = 24000, n_fft: int = 512,
                      hop: int = 128):
    """A matplotlib Figure of the stacked spectrograms (80 dB range below
    the first one's peak); ImportError without matplotlib."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    names = ["noisy", "estimate"] + (["clean"] if clean is not None else [])
    sigs = [noisy, estimate] + ([clean] if clean is not None else [])
    fig, axes = plt.subplots(len(sigs), 1, figsize=(8, 3 * len(sigs)), sharex=True)
    vmax = None
    for ax, name, sig in zip(np.atleast_1d(axes), names, sigs):
        db = spec_db(sig, n_fft, hop)
        vmax = db.max() if vmax is None else vmax
        im = ax.imshow(db, origin="lower", aspect="auto", vmax=vmax, vmin=vmax - 80,
                       extent=[0, len(sig) / sr, 0, sr / 2 / 1000], cmap="magma")
        ax.set_ylabel(f"{name}\nkHz")
        fig.colorbar(im, ax=ax)
    np.atleast_1d(axes)[-1].set_xlabel("time (s)")
    fig.tight_layout()
    return fig
