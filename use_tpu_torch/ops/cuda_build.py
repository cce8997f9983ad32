"""Build and load the port's hand-written CUDA kernels (nvcc + ctypes).

Each source ``use_tpu_torch/csrc/<name>.cu`` has a plain C interface and is
compiled on its own into ``use_tpu_torch/_build/<name>-<hash>.so`` with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o <lib> <source>

The hash covers the source bytes and the flags, so an edited source builds
anew and an unchanged one is reused. ``build_all`` starts one nvcc per
missing library, all at once, and waits for them. Nothing here runs at
import time: the CPU tests import every module on a machine without nvcc.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, List

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
SOURCES = ("gn_stats", "fused_skip", "fused_qconv", "qconv_s8")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH); the port's CUDA kernels are built from use_tpu_torch/csrc"
        )
    return found


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def lib_path(name: str) -> str:
    with open(source_path(name), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"{name}-{digest[:16]}.so")


def build_all(names=SOURCES) -> Dict[str, float]:
    """Compile every missing library in parallel; -> {name: seconds}
    (0.0 for a library that was already built). Raises on a failed build."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs: List = []
    t0 = time.perf_counter()
    for name in names:
        out = lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.tmp{os.getpid()}"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, source_path(name)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        procs.append((name, proc, tmp, out))
    times = {name: 0.0 for name in names}
    errors = []
    for name, proc, tmp, out in procs:
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library for csrc/<name>.cu (built on first use), loaded as a
    ``ctypes.PyDLL``: its calls keep the GIL. Every entry point only enqueues
    work on a stream and returns, and letting go of the GIL and taking it
    back can cost more than that when another thread (the profiler's, a data
    loader's) asks for it in between."""
    build_all((name,))
    return ctypes.PyDLL(lib_path(name))


def stream(t) -> int:
    """The raw handle of the current CUDA stream on tensor t's device, as a
    kernel's C entry point takes it (the call PyTorch's own generated
    kernels use; cheaper than building a ``torch.cuda.Stream``)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
