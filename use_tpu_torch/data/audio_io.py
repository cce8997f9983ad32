"""WAV read/write without external audio deps (scipy.io.wavfile based).

Replaces the reference's soundfile usage (comm_distort_simu_dataset.py,
loadwav_dataset.py, SGMSE_module.py predict_step). Reads PCM16/24/32 and
float wavs to float32 [-1, 1]; writes float32 or PCM16.
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np
from scipy.io import wavfile


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """-> (float32 samples [L] or [L, C], sample_rate)."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    return data, int(sr)


def write_wav(path: str, data: np.ndarray, sr: int, subtype: str = "float") -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    data = np.asarray(data)
    if subtype == "pcm16":
        data = np.clip(data, -1.0, 1.0)
        wavfile.write(path, sr, (data * 32767.0).astype(np.int16))
    else:
        wavfile.write(path, sr, data.astype(np.float32))


def valid_audio(x: np.ndarray) -> bool:
    """librosa.util.valid_audio-style check (finite, non-empty, mono)."""
    return x.ndim == 1 and x.size > 0 and bool(np.isfinite(x).all())
