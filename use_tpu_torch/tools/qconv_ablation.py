#!/usr/bin/env python3
"""Where the int8 convs' time goes: each kernel timed with one part left out.

    python3 -m use_tpu_torch.tools.qconv_ablation [--kernel k3|s8|both]

K3 (csrc/fused_qconv.cu) is built six times with nvcc, in parallel, into
use_tpu_torch/_build/ablation/: as shipped, and with -DQC_NO_X_LOAD (the raw
windows of x are not loaded), -DQC_NO_TRANSFORM (the int8 operand is not
computed), -DQC_NO_MMA (no products), -DQC_NO_WEIGHT_LOAD (the weights are
not loaded) or -DQC_NO_STORE (no output written). The s8 conv (csrc/qconv_s8.cu)
likewise: as shipped, -DS8_NO_OPERAND_TMA (the operand windows are not
loaded), -DS8_NO_MMA (no products), -DS8_NO_WEIGHT_LOAD (the weights are
not loaded) and -DS8_NO_STORE (no output written). Then, at the int8
predict path's shapes in bf16, it times each build with each of the
kernel's tiles (median of 20 CUDA-event timings after 3 warm-ups, one
launch each) and prints one JSON line a kernel, shape and tile, then the
card's name and power limit. Only the full build computes
the conv; the others time what is left. Needs one GPU.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys

import numpy as np

VARIANTS = {
    "k3": ("fused_qconv", {
        "full": [],
        "no_x_load": ["-DQC_NO_X_LOAD"],
        "no_transform": ["-DQC_NO_TRANSFORM"],
        "no_mma": ["-DQC_NO_MMA"],
        "no_weight_load": ["-DQC_NO_WEIGHT_LOAD"],
        "no_store": ["-DQC_NO_STORE"],
    }),
    "s8": ("qconv_s8", {
        "full": [],
        "no_operand_tma": ["-DS8_NO_OPERAND_TMA"],
        "no_mma": ["-DS8_NO_MMA"],
        "no_weight_load": ["-DS8_NO_WEIGHT_LOAD"],
        "no_store": ["-DS8_NO_STORE"],
    }),
}
SHAPES = [  # (B, C, O, H, W) of the int8 predict path, 8 lanes
    (8, 128, 128, 512, 192), (8, 256, 128, 512, 192), (8, 128, 128, 256, 96),
    (8, 512, 256, 128, 48), (8, 256, 256, 64, 24), (8, 512, 256, 32, 12),
    (8, 256, 256, 16, 6), (8, 256, 256, 8, 3),
]


def build(cuda_build, kernels):
    """{kernel: {variant: CDLL}}, every build started at once."""
    out_dir = os.path.join(cuda_build.BUILD_DIR, "ablation")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for kernel in kernels:
        source, variants = VARIANTS[kernel]
        for name, flags in variants.items():
            lib = os.path.join(out_dir, f"{source}_{name}.so")
            cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, *flags, "-o", lib,
                   cuda_build.source_path(source)]
            procs[kernel, name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.STDOUT), lib)
    libs = {kernel: {} for kernel in kernels}
    p, i32 = ctypes.c_void_p, ctypes.c_int
    for (kernel, name), (proc, lib) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the {kernel} {name} build:\n{log}")
        cdll = ctypes.CDLL(lib)
        if kernel == "k3":
            cdll.qconv3x3_fused.argtypes = [p, i32, p, p, p, p, p, p, p, i32, i32, i32, i32, i32,
                                            i32, i32, i32, i32, p, p]
            cdll.qconv3x3_fused.restype = i32
        else:
            cdll.qconv3x3_s8.argtypes = [p, p, p, p, i32, p, p, i32, i32, i32, i32, i32, i32,
                                         i32, p]
            cdll.qconv3x3_s8.restype = i32
        libs[kernel][name] = cdll
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=("k3", "s8", "both"), default="both")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("qconv_ablation: needs one NVIDIA GPU", file=sys.stderr)
        return 2
    from use_tpu_torch.ops import cuda_build
    from use_tpu_torch.ops import fused_qconv as fq
    from use_tpu_torch.ops import qconv as q

    kernels = ("k3", "s8") if args.kernel == "both" else (args.kernel,)
    libs = build(cuda_build, kernels)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def time_ms(fn, reps=20, warmup=3):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    for shape in SHAPES:
        b, c, o, h, w = shape
        x = (torch.randn((b, c, h, w), generator=gen, device=dev) + 0.5).bfloat16()
        weight = torch.randn((o, c, 3, 3), generator=gen, device=dev) / math.sqrt(9 * c)
        u = 6.0 / 127.0 + 0.1 * torch.rand((c,), generator=gen, device=dev)
        a = 1.0 + 0.2 * torch.randn((b, c), generator=gen, device=dev)
        off = 0.1 * torch.randn((b, c), generator=gen, device=dev)
        bias = 0.05 * torch.randn((o,), generator=gen, device=dev)
        out = torch.empty((b, o, h, w), dtype=torch.bfloat16, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        if "k3" in libs:
            qw, sw, iu = fq.prepare_qconv_weight(weight, u)
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            for tile, code in fq.TILES.items():
                splits, ws_ints = fq.split_plan(tile, b, c, h, w, o, sms)
                ws = fq._workspace(dev, ws_ints).data_ptr() if splits > 1 else None
                row = {}
                for name, lib in libs["k3"].items():
                    def launch():
                        status = lib.qconv3x3_fused(
                            x.data_ptr(), 1, a.data_ptr(), off.data_ptr(), iu.data_ptr(),
                            qw.data_ptr(), sw.data_ptr(), bias.data_ptr(), out.data_ptr(), 1,
                            b, c, h, w, o, 1, code, splits, ws, stream)
                        cuda_build.check(status, "qconv3x3_fused")
                    row[name] = time_ms(launch)
                print(json.dumps({"kernel": "k3", "shape": list(shape), "dtype": "bfloat16",
                                  "tile": tile, "picked": tile == fq.pick_tile(h, w, o, b),
                                  "splits": splits, "ms": row}), flush=True)
        if "s8" in libs:
            qx = q.pack_c32(torch.randint(-127, 128, (b, c, h, w), generator=gen, device=dev,
                                          dtype=torch.int8))
            prepared = q.prepare_s8_weight(weight, u)
            for tile, code in q.TILES.items():
                row = {}
                for name, lib in libs["s8"].items():
                    def launch():
                        status = lib.qconv3x3_s8(
                            qx.data_ptr(), prepared.qk.data_ptr(), prepared.sw.data_ptr(), None,
                            0, bias.data_ptr(), out.data_ptr(), 1, b, c, h, w, o, code, stream)
                        cuda_build.check(status, "qconv3x3_s8")
                    row[name] = time_ms(launch)
                print(json.dumps({"kernel": "s8", "shape": list(shape), "dtype": "bfloat16",
                                  "tile": tile, "picked": tile == q.pick_tile(w), "ms": row}),
                      flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
