"""ctypes loader for the native DSP loops of the data pipeline (native/dsp.cpp).

The port's own loader of the repo's host-side C++ (use_tpu/data/native.py):
the library is compiled on first use with g++ -O3 into the port's ignored
build directory, ``use_tpu_torch/_build/``, never into ``native/``. Every
entry point has the same numpy fallback as use_tpu's, so the pipeline runs
on a host without a toolchain. Host DSP, not a device kernel.
"""
from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import warnings
from typing import Optional

import numpy as np

from use_tpu_torch.data.dsp import compressor_envelope_np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG_DIR), "native", "dsp.cpp")
_LIB_PATH = os.path.join(_PKG_DIR, "_build", "libusedsp.so")


@functools.lru_cache(maxsize=None)
def _load() -> Optional[ctypes.CDLL]:
    try:
        if not os.path.exists(_LIB_PATH) or os.path.getmtime(_SRC) > os.path.getmtime(_LIB_PATH):
            os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
            tmp = f"{_LIB_PATH}.tmp{os.getpid()}"
            subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, _LIB_PATH)
        lib = ctypes.CDLL(_LIB_PATH)
    except (OSError, subprocess.SubprocessError) as e:  # toolchain or source missing
        warnings.warn(f"native DSP unavailable ({e}); using numpy fallbacks")
        return None
    lib.envelope_follow.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_float, ctypes.c_float,
    ]
    lib.set_holes.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
    ]
    return lib


def envelope_follow(level: np.ndarray, attack_coef: float, release_coef: float) -> np.ndarray:
    lib = _load()
    if lib is not None:
        level32 = np.ascontiguousarray(level, np.float32)
        out = np.empty_like(level32)
        lib.envelope_follow(
            level32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(level32), ctypes.c_float(attack_coef), ctypes.c_float(release_coef),
        )
        return out.astype(level.dtype)
    return compressor_envelope_np(level, attack_coef, release_coef)


def set_holes(spec: np.ndarray, holes: np.ndarray) -> np.ndarray:
    """Zero rectangular holes in a complex [F, T] spectrogram.

    holes: int64 [n, 4] = (f_idx, t_idx, w_freq, w_time). Mirrors reference
    perturb.py:1593-1611 (numba set_holes).
    """
    lib = _load()
    if lib is not None and spec.dtype == np.complex64:
        ri = np.ascontiguousarray(spec).view(np.float32)
        h = np.ascontiguousarray(holes, np.int64)
        lib.set_holes(
            ri.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            spec.shape[0], spec.shape[1],
            h.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(h),
        )
        return ri.view(np.complex64)
    for f_idx, t_idx, wf, wt in holes:
        spec[max(f_idx - wf, 0) : f_idx + wf, max(t_idx - wt, 0) : t_idx + wt] = 0
    return spec
