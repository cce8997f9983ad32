#!/usr/bin/env python3
"""Chip smoke test of use_tpu_torch, the PyTorch / CUDA port, on one GPU.

    python3 chip_smoke.py              # the full check, one card
    python3 chip_smoke.py --kernels    # build + per-kernel phases only
    python3 chip_smoke.py --profile    # also profile one full-width forward

Phases, one line each (any failure raises and exits non-zero):
  1. environment: torch / CUDA versions, the card's name and power limit;
  2. build: every kernel from use_tpu_torch/csrc with nvcc, in parallel;
  3. kernels: each hand-written kernel against its plain torch version on the
     card at main-path shapes, fp32 and bf16, with the stated tolerance; its
     time (median of CUDA-event timings), the plain version's, one PyTorch
     library call's, and the bound (bytes at 3.35 TB/s or operations at the
     dtype's peak, whichever is larger), and for K1 and K2 the device time
     of one call from the profiler's kernel durations (`device_ms`), so that
     the host's cost of a call and the card's are told apart. K1's
     statistics are also checked with the GroupNorm fold inside
     (`gn_fold`), and K2 at a ragged shape. K3 (the int8 conv) is timed on
     weights prepared once (`prep_ms` times the preparation), in each of its
     tiles, also checked at a ragged shape, and a control broken on
     purpose (no edge mask) must fail its tolerance; the branch-free
     reciprocal of its SiLU is checked against IEEE 1/d at every float of
     [1, 2^126), the range it is used on;
  4. forward: full-width ncsnpplarge with seeded random weights on
     [8, 512, 192, 4] (the predict path's 8 chunk lanes, one t each), the
     card (kernels) against the CPU (plain versions), TF32 off; and its bf16
     compute path against fp32 on the card for a few seeds, within a limit
     that a deliberately broken bf16 path (GroupNorm sums in bf16) exceeds;
     then the int8 serving network (quant='int8_pallas') in fp32 and bf16,
     K3 against K3's plain version on the card, with K2's and K3's calls
     counted by image size and channels;
  5. predict: the port's CLI `predict experiment=SGMSE_Large` on two
     synthetic 24 kHz wavs (3 s full-clip, 6 s chunked into 8 lanes) with
     seeded random weights, once in fp32 and once as int8 bf16 serving;
     checks the mirrored, length-matched, finite outputs and that each
     kernel was launched exactly as often as each forward of that run needs;
  6. the LSGAN generator (`ncsnpp`, discriminative, full width) forward at
     [1, 512, 1536, 2], the card against the CPU, with its exact launches a
     forward (`PER_GENERATOR_FORWARD`) and K2's calls by level;
  7. flops: the arithmetic of one forward on the card at each of
     FLOPS_FORWARDS' full shapes (convolutions, matmuls, attention, and
     K2's 1x1 products), the work the predict runs' rates are read against;
  8. predict through the LSGAN and hybrid paths and the other samplers, fp32:
     `experiment=LSGAN` on the 3 s and 6 s clips; on the 6 s clip the chains
     `sgmse+gan` and `gan+sgmse` (condition=both, sde_input=denoised) at
     N=CHAIN_N, `infer.sampler_type=ode` at N=ODE_N and `parallel_pc`
     (PARALLEL_ARGS); per stage (SGMSE sampling, LSGAN enhance) the backbone
     forwards and each kernel's launches, checked against the per-forward
     counts, with NFE, sweeps, peak device memory and audio-s/s.
Each phase prints its seconds. Then a JSON line of the kernels, the card
line, and the last line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# fp32 outside tensor cores; bf16 and int8 dense tensor-core peaks
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
# Shapes the predict phase gives the kernels first (a clip of >= 5 s runs as
# 8 chunk lanes of 512 x 192), then a 10 s full clip at batch 1.
GN_SHAPES = [
    (8, 128, 512, 192),  # full resolution, 8 lanes
    (8, 256, 32, 12),  # a low level, 8 lanes
    (1, 128, 512, 1536),  # full resolution, 10 s full clip
    (8, 256, 8, 3),  # the lowest level, 8 lanes
    (1, 384, 512, 1536),  # LSGAN generator, 10 s clip: the up path's skip concat
    (1, 256, 256, 768),  # LSGAN generator, 10 s clip: level 1
    (8, 128, 512, 960),  # parallel_pc on the 6 s clip: W = 8 trajectory points of [512, 960]
    (8, 256, 512, 960),  # parallel_pc: the up path's skip concat at full resolution
]
SKIP_SHAPES = [  # (B, Ci, Co, H, W)
    (8, 256, 128, 512, 192),  # up path, full-resolution block, 8 lanes
    (8, 128, 128, 256, 96),  # first down block (shortcut after the FIR downsample), 8 lanes
    (1, 256, 128, 512, 1536),  # up path, full-resolution block, 10 s full clip
    (8, 512, 256, 128, 48),  # up path at 128 x 48 (Co 256: two channel tiles), 8 lanes
    # the LSGAN generator (ncsnpp) on a 10 s clip at batch 1
    (1, 128, 256, 256, 768),  # level 1's first block (128 -> 256)
    (1, 512, 256, 256, 768),  # up path, level 1
    (1, 384, 256, 256, 768),  # up path, level 1, the skip from level 0
    (1, 384, 128, 512, 1536),  # up path, full resolution
    # ncsnpplarge in a parallel_pc sweep on the 6 s clip: batch W = 8 of [512, 960]
    (8, 256, 128, 512, 960),  # up path, full resolution
    (8, 384, 128, 256, 480),  # up path at 256 x 480, the skip from level 2
    (8, 512, 256, 128, 240),  # up path at 128 x 240
]
SKIP_RAGGED = (2, 36, 40, 5, 7)  # ragged Ci, Co and positions, scalar path: checked, not timed
QCONV_SHAPES = [  # (B, C, O, H, W): int8 predict path, 8 lanes
    (8, 128, 128, 512, 192),  # full-resolution Conv_0 / Conv_1
    (8, 256, 128, 512, 192),  # full-resolution up-path Conv_0 (skip concat)
    (8, 512, 256, 128, 48),  # up-path Conv_0 at 128 x 48
    (8, 256, 256, 8, 3),  # the lowest level
    (8, 128, 128, 256, 96),  # Conv_0 / Conv_1 at 256 x 96
    (8, 256, 256, 64, 24),  # Conv_0 / Conv_1 at 64 x 24
]
QCONV_RAGGED = (2, 36, 40, 5, 7)  # ragged channel chunk, O and pixel edges: checked, not timed
FORWARD_BACKBONE, FORWARD_SHAPE = "ncsnpplarge", (8, 512, 192, 4)  # the 8 lanes of a 6 s clip
BF16_SEEDS = (1, 2, 3)
# bf16 forward against fp32, relative to max|fp32|: between the readings on
# BF16_SEEDS (<= 0.013) and the broken control's (0.023) on the H100 (PERF.md)
BF16_REL_TOL = 0.017
INT8_SEEDS = (1, 2)
KERNEL_REPS = 100  # single-call timings a median of K1's and K2's times takes
# int8 forward with K3 against the same forward with K3's plain version, on
# the card, relative to max|plain|: both read exactly 0 on INT8_SEEDS, as do
# two runs with K3, in fp32 and bf16 (PERF.md). Integer sums are exact, so
# any flipped quantum is a fault; the limit only leaves room for float
# rounding, which the two sides do alike. The edge-leak control must exceed it.
INT8_REL_TOL = 1e-6
PREDICT_EXPERIMENT = "SGMSE_Large"
PREDICT_CLIPS_S = (3, 6)  # full-clip, and >= 5 s: chunked into 8 lanes
PREDICT_N = 10
INT8_PREDICT_ARGS = ("model.backbone_kwargs.quant=int8_pallas",
                     "model.backbone_kwargs.dtype=bfloat16")
# the LSGAN generator's forward: a 10 s clip (1501 frames, padded to 1536)
GAN_FORWARD_SHAPE = (1, 512, 1536, 2)
CHAIN_N, ODE_N = 4, 3  # ODE: 4N + 1 = 13 network evaluations
PARALLEL_ARGS = ("infer.sampler_type=parallel_pc", "infer.N=10", "infer.window=8",
                 "infer.tol=0.1")
# kernel launches per forward of the LSGAN generator (ncsnpp, discriminative, fp32)
PER_GENERATOR_FORWARD = {"channel_sums": 45, "gn_apply": 45, "fused_skip_add": 15,
                         "qconv3x3_fused": 0}
# the forwards whose arithmetic phase 7 counts: (backbone, kwargs, input shape)
FLOPS_FORWARDS = [
    ("ncsnpp", {"discriminative": True}, GAN_FORWARD_SHAPE),  # the LSGAN generator, 10 s
    ("ncsnpplarge", {"input_channels": 4}, FORWARD_SHAPE),  # 8 chunk lanes of a 6 s clip
    ("ncsnpplarge", {"input_channels": 6}, (1, 512, 960, 6)),  # gan+sgmse, 6 s full clip
    ("ncsnpplarge", {"input_channels": 4}, (8, 512, 960, 4)),  # a parallel_pc sweep, W = 8
]
# kernel launches per ncsnpplarge forward on each predict run
PER_FORWARD = {
    "float32": {"channel_sums": 106, "gn_apply": 106, "fused_skip_add": 34, "qconv3x3_fused": 0},
    "int8_bfloat16": {"channel_sums": 106, "gn_apply": 20, "fused_skip_add": 34,
                      "qconv3x3_fused": 86},
}


def phase(phase_name, **fields):
    print(json.dumps({"phase": phase_name, **fields}), flush=True)


def bound(bytes_moved, ops, dtype):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels", action="store_true", help="build and kernel phases only")
    ap.add_argument("--profile", action="store_true", help="profile one full-width forward")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs one NVIDIA GPU",
              file=sys.stderr)
        return 2
    import use_tpu_torch.models  # noqa: F401 (registries)
    from use_tpu_torch.ops import cuda_build

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    phase("environment", python=sys.version.split()[0], torch=torch.__version__,
          cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), nvidia_smi=smi)

    t0 = time.perf_counter()
    per_lib = cuda_build.build_all()
    phase("build", seconds=round(time.perf_counter() - t0, 2),
          libraries={k: round(v, 2) for k, v in per_lib.items()}, nvcc=cuda_build.nvcc_path())

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.inference_mode():  # as the predict path's sampler calls the kernels
        results = timed("kernels", kernel_phases, torch, dev)
    runs = {label: {name: None for name in results} for label in PER_FORWARD}
    if not args.kernels:
        timed("forward", forward_phase, torch, dev)
        timed("int8_forward", int8_forward_phase, torch, dev)
        runs = {"float32": timed("predict float32", predict_phase, torch, dev, "float32", ()),
                "int8_bfloat16": timed("predict int8_bfloat16", predict_phase, torch, dev,
                                       "int8_bfloat16", INT8_PREDICT_ARGS)}
        timed("lsgan_forward", lsgan_forward_phase, torch, dev)
        timed("flops", flops_phase, torch, dev)
        sgmse, gan = PER_FORWARD["float32"], PER_GENERATOR_FORWARD
        both = ("second.model.condition=both", "second.model.sde_input=denoised")
        for label, experiment, extra, clips, per_stage in (
                ("lsgan", "LSGAN", (), PREDICT_CLIPS_S, {"lsgan": gan}),
                ("sgmse+gan", "SGMSE_Large", ("predict.chain=sgmse+gan",
                                              "predict.second_experiment=LSGAN",
                                              f"infer.N={CHAIN_N}"),
                 (6,), {"sgmse": sgmse, "lsgan": gan}),
                ("gan+sgmse", "LSGAN", ("predict.chain=gan+sgmse",
                                        "predict.second_experiment=SGMSE_Large", *both,
                                        f"infer.N={CHAIN_N}"),
                 (6,), {"lsgan": gan, "sgmse": sgmse}),
                ("ode", "SGMSE_Large", ("infer.sampler_type=ode", f"infer.N={ODE_N}"), (6,),
                 {"sgmse": sgmse}),
                ("parallel_pc", "SGMSE_Large", PARALLEL_ARGS, (6,), {"sgmse": sgmse})):
            runs[label] = timed(f"predict {label}", stage_predict_phase, torch, dev, label,
                                experiment, extra, clips, per_stage)
        if args.profile:
            timed("profile", profile_phase, torch, dev)

    line = []
    for name, cases in results.items():
        main_case = cases[0]
        entry = {k: main_case[k] for k in (
            "name", "route", "source", "replaces", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "shape", "dtype", "device_ms") if k in main_case}
        # the count of the predict run whose path the kernel is on (K3: int8)
        entry["launches"] = runs["int8_bfloat16" if name == "qconv3x3_fused" else "float32"][name]
        entry["launches_per_run"] = {label: counts[name] for label, counts in runs.items()}
        if "prep_ms" in main_case:
            entry["prep_ms"] = main_case["prep_ms"]
        entry["cases"] = [{k: c[k] for k in (
            "variant", "shape", "dtype", "max_abs_err", "tol", "ms", "device_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "library_device_ms", "kernels_per_call",
            "profiler_kernels_per_call", "profiler_exact", "tile", "tile_ms", "prep_ms") if k in c}
            for c in cases]
        line.append(entry)
    print(json.dumps({"kernels": line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def timed(name, fn, *args):
    """fn(*args), then a line with the phase's wall seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    phase("seconds", of=name, seconds=round(time.perf_counter() - t0, 2))
    return out


def time_ms(torch, fn, reps=20, warmup=3):
    """Median over `reps` CUDA-event timings of fn(), after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def time_pair_ms(torch, fn, other, reps):
    """Medians of `reps` single-call CUDA-event timings of fn() and of
    other(), taken in turns (other, fn, fn, other, ...), so that a drift of
    the host's speed falls on both alike."""
    a, b = [], []
    for r in range(reps):
        for f, out in (((other, b), (fn, a)) if r % 2 == 0 else ((fn, a), (other, b))):
            out.append(time_ms(torch, f, reps=1, warmup=1 if r == 0 else 0))
    return float(np.median(a)), float(np.median(b))


def device_ms(torch, fn, reps=10):
    """Device time of one fn() call and its kernel launches a call, from the
    kernels that the profiler records over `reps` calls (no host time), and
    whether every kernel was recorded `reps` times (or a whole multiple). A
    session that misses launches, as one now and then does, is run again, up
    to three times, and the last one's counts are rounded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        exact = bool(events) and all(e.count % reps == 0 for e in events)
        if exact:
            break
    if not events:
        raise AssertionError("device_ms: three profiler sessions recorded no kernel on the card")
    key = "self_device_time_total" if hasattr(events[0], "self_device_time_total") else "self_cuda_time_total"
    per_call = {e.key: max(1, round(e.count / reps)) for e in events}
    ms = sum(getattr(e, key) / e.count * per_call[e.key] for e in events) / 1e3
    return ms, sum(per_call.values()), exact


def kernel_phases(torch, dev):
    """K1 and K2 against their plain versions at GN_SHAPES and SKIP_SHAPES.
    Their times are medians of KERNEL_REPS single calls, the kernel's and
    the library call's taken in turns: at the low levels a call is a few
    microseconds on the card, so its event time is mostly the host's
    enqueue, which varies by tens of microseconds from call to call.
    `device_ms` is the profiler's kernel time of one call (beside it the
    library call's). Every statistics call must put exactly its kernels on
    the stream, one for short rows and two for split rows, counted in a
    CUDA graph captured around the call (`kernels_per_call`; the profiler's
    count is kept beside it).
    Runs under torch.inference_mode, as the sampler does: there a view or an
    allocation costs the host less than with autograd's bookkeeping."""
    import torch.nn.functional as F

    from use_tpu_torch.ops import gn_stats as g
    from use_tpu_torch.ops import fused_skip as fs

    gen = torch.Generator(device=dev).manual_seed(0)
    results = {"channel_sums": [], "gn_apply": [], "fused_skip_add": []}
    common_gn = dict(route="cuda", source="use_tpu_torch/csrc/gn_stats.cu",
                     replaces="use_tpu/ops/gn_stats.py:85")
    for dtype_name in ("float32", "bfloat16"):
        dt = getattr(torch, dtype_name)
        for shape in GN_SHAPES:
            b, c, hh, ww = shape
            s = hh * ww
            x = torch.randn(shape, generator=gen, device=dev).add_(0.5).to(dt)
            x3 = x.reshape(b, c, s)
            groups = g.num_groups(c)
            sums, sumsq = g.channel_sums(x3)
            ref_s, ref_ss = g.channel_sums_plain(x3)
            torch.cuda.synchronize()
            err = max(float((sums - ref_s).abs().max()), float((sumsq - ref_ss).abs().max()))
            tol = 1e-5 * float(ref_ss.abs().max())  # fp32 sums of S terms, other order
            check("channel_sums", shape, dtype_name, err, tol)
            nbytes = x.numel() * x.element_size() + 2 * b * c * 4
            bms, by = bound(nbytes, 3 * x.numel(), dtype_name)
            launches = 1 if g.split_rows(b * c, s)[0] == 1 else 2  # short rows: no finalize
            ms, lib_ms = time_pair_ms(torch, lambda: g.channel_sums(x3),
                                      lambda: torch.var_mean(x3, dim=2), KERNEL_REPS)
            dev_ms, per_call, exact = device_ms(torch, lambda: g.channel_sums(x3))
            graph_kernels = check_launches(torch, "channel_sums", shape, dtype_name,
                                           lambda: g.channel_sums(x3), launches)
            results["channel_sums"].append(dict(
                name="channel_sums", variant="sums", **common_gn, shape=list(shape),
                dtype=dtype_name, max_abs_err=err, tol=tol, ms=ms, device_ms=dev_ms,
                kernels_per_call=graph_kernels, profiler_kernels_per_call=per_call,
                profiler_exact=exact,
                plain_ms=time_ms(torch, lambda: g.channel_sums_plain(x3), reps=KERNEL_REPS),
                library_ms=lib_ms,
                library_device_ms=device_ms(torch, lambda: torch.var_mean(x3, dim=2))[0],
                bound_ms=bms, bound_by=by))
            phase("kernel", **{k: v for k, v in results["channel_sums"][-1].items()
                               if k not in ("route", "source", "replaces")})

            weight = 1.0 + 0.1 * torch.randn((c,), generator=gen, device=dev)
            bias = 0.1 * torch.randn((c,), generator=gen, device=dev)
            a, off = g.gn_fold(x3, weight, bias, groups, 1e-6)
            ref_a, ref_off = g.gn_fold_plain(x3, weight, bias, groups, 1e-6)
            torch.cuda.synchronize()
            # the group sums in another order, then the same rounded steps
            # (rsqrt to nearest in the kernel, torch.rsqrt in the plain
            # version): relative to the largest |a| and |off|
            err = max(float((a - ref_a).abs().max()) / float(ref_a.abs().max()),
                      float((off - ref_off).abs().max()) / float(ref_off.abs().max()))
            tol = 1e-5
            check("gn_fold", shape, dtype_name, err, tol)
            bms, by = bound(nbytes + 2 * c * 4, 3 * x.numel(), dtype_name)
            dev_ms, per_call, exact = device_ms(torch, lambda: g.gn_fold(x3, weight, bias, groups,
                                                                         1e-6))
            graph_kernels = check_launches(
                torch, "gn_fold", shape, dtype_name,
                lambda: g.gn_fold(x3, weight, bias, groups, 1e-6), launches)
            results["channel_sums"].append(dict(
                name="channel_sums", variant="gn_fold", **common_gn, shape=list(shape),
                dtype=dtype_name, max_abs_err=err, tol=tol,
                ms=time_ms(torch, lambda: g.gn_fold(x3, weight, bias, groups, 1e-6),
                           reps=KERNEL_REPS),
                device_ms=dev_ms, kernels_per_call=graph_kernels,
                profiler_kernels_per_call=per_call, profiler_exact=exact,
                plain_ms=time_ms(torch, lambda: g.gn_fold_plain(x3, weight, bias, groups, 1e-6),
                                 reps=KERNEL_REPS),
                library_ms=None, bound_ms=bms, bound_by=by))
            phase("kernel", **{k: v for k, v in results["channel_sums"][-1].items()
                               if k not in ("route", "source", "replaces")})
            y = g.gn_apply(x3, sums, sumsq, weight, bias, groups, 1e-6, "swish", dt)
            ref = g.gn_apply_plain(x3, sums, sumsq, weight, bias, groups, 1e-6, "swish", dt)
            torch.cuda.synchronize()
            err = float((y.float() - ref.float()).abs().max())
            top = max(1.0, float(ref.float().abs().max()))
            # fp32: same arithmetic, fold summed in another order; bf16: one ulp
            tol = (1e-5 if dtype_name == "float32" else 2.0 ** -7) * top
            check("gn_apply", shape, dtype_name, err, tol)
            nbytes = x.numel() * x.element_size() * 2 + 2 * b * c * 4 + 2 * c * 4
            bms, by = bound(nbytes, 6 * x.numel(), dtype_name)
            results["gn_apply"].append(dict(
                name="gn_apply", **common_gn, shape=list(shape), dtype=dtype_name,
                max_abs_err=err, tol=tol,
                ms=time_ms(torch, lambda: g.gn_apply(x3, sums, sumsq, weight, bias, groups,
                                                     1e-6, "swish", dt), reps=KERNEL_REPS),
                device_ms=device_ms(torch, lambda: g.gn_apply(x3, sums, sumsq, weight, bias,
                                                              groups, 1e-6, "swish", dt))[0],
                plain_ms=time_ms(torch, lambda: g.gn_apply_plain(x3, sums, sumsq, weight, bias,
                                                                 groups, 1e-6, "swish", dt),
                                 reps=KERNEL_REPS),
                library_ms=time_ms(torch, lambda: F.group_norm(x, groups, weight.to(dt),
                                                               bias.to(dt), 1e-6), reps=KERNEL_REPS),
                bound_ms=bms, bound_by=by))
            phase("kernel", **{k: v for k, v in results["gn_apply"][-1].items()
                               if k not in ("route", "source", "replaces")})
            del x, x3, y, ref

        for shape in (*SKIP_SHAPES, SKIP_RAGGED):
            b, ci, co, hh, ww = shape
            x = torch.randn((b, ci, hh, ww), generator=gen, device=dev).to(dt)
            h = torch.randn((b, co, hh, ww), generator=gen, device=dev).to(dt)
            w = (torch.randn((co, ci), generator=gen, device=dev) / math.sqrt(ci)).to(dt)
            bias = (0.1 * torch.randn((co,), generator=gen, device=dev)).to(dt)
            scale = 2 ** -0.5
            out = fs.fused_skip_add(x, h, w, bias, scale)
            ref = fs.fused_skip_add_plain(x, h, w, bias, scale)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            top = max(1.0, float(ref.float().abs().max()))
            # fp32: Ci-term dot products summed in another order; bf16: one ulp
            tol = (2e-5 if dtype_name == "float32" else 2.0 ** -7) * top
            check("fused_skip_add", shape, dtype_name, err, tol)
            if shape == SKIP_RAGGED:
                phase("kernel_check", name="fused_skip_add", shape=list(shape), dtype=dtype_name,
                      max_abs_err=err, tol=tol)
                continue
            s = hh * ww
            esz = x.element_size()
            nbytes = (b * ci * s + 2 * b * co * s + co * ci + co) * esz
            bms, by = bound(nbytes, 2 * b * ci * co * s + 3 * b * co * s, dtype_name)
            w4 = w[:, :, None, None]
            ms, lib_ms = time_pair_ms(torch, lambda: fs.fused_skip_add(x, h, w, bias, scale),
                                      lambda: (h + F.conv2d(x, w4, bias)) * scale, KERNEL_REPS)
            results["fused_skip_add"].append(dict(
                name="fused_skip_add", route="cuda", source="use_tpu_torch/csrc/fused_skip.cu",
                replaces="use_tpu/ops/pallas_skip.py:44", shape=list(shape), dtype=dtype_name,
                max_abs_err=err, tol=tol,
                ms=ms, device_ms=device_ms(torch, lambda: fs.fused_skip_add(x, h, w, bias, scale))[0],
                plain_ms=time_ms(torch, lambda: fs.fused_skip_add_plain(x, h, w, bias, scale),
                                 reps=KERNEL_REPS),
                library_ms=lib_ms,
                library_device_ms=device_ms(torch, lambda: (h + F.conv2d(x, w4, bias)) * scale)[0],
                bound_ms=bms, bound_by=by))
            phase("kernel", **{k: v for k, v in results["fused_skip_add"][-1].items()
                               if k not in ("route", "source", "replaces")})
            del x, h, out, ref
    torch.cuda.empty_cache()
    results["qconv3x3_fused"] = qconv_phase(torch, dev, gen)
    return results


def qconv_phase(torch, dev, gen):
    """K3 against its plain version at the int8 predict path's shapes, fp32
    and bf16 input (output in the same dtype), with GroupNorm affine, SiLU
    and bias, in each of the kernel's tiles; and a control broken on
    purpose (x zero-padded before the affine, so act(off) leaks into the
    edges) that the same check must reject. fp32 tolerance: max |err| <= 4
    quanta of the largest output channel (4 * 127 * max sw) with at most
    1e-3 of the outputs off by more than 1e-6 * max|ref| (a quantum flipped
    by a last-bit difference of the sigmoid); bf16: one bf16 ulp of max|ref|.
    The kernel's time is on prepared weights (`ms`, with the tile the
    wrapper picks; `tile_ms` with each of the kernel's tiles), and
    `prep_ms` is the weight preparation alone. QCONV_RAGGED is checked, not
    timed."""
    import torch.nn.functional as F

    from use_tpu_torch.ops import fused_qconv as fq

    def judge(out, ref, tol):
        diff = (out.float() - ref.float()).abs()
        top = float(ref.float().abs().max())
        flips = int((diff > 1e-6 * top).sum())
        err = float(diff.max())
        return err, flips, flips / diff.numel(), (err <= tol and flips / diff.numel() <= 1e-3)

    mismatches = fq.rcp_mismatches(dev)
    phase("kernel_check", name="rcp_newton", floats="[1, 2^126)", mismatches=mismatches)
    if mismatches:
        raise AssertionError(f"K3's reciprocal differs from IEEE 1/d at {mismatches} floats")
    cases = []
    for dtype_name in ("float32", "bfloat16"):
        dt = getattr(torch, dtype_name)
        for shape in (*QCONV_SHAPES, QCONV_RAGGED):
            b, c, o, hh, ww = shape
            x = (torch.randn((b, c, hh, ww), generator=gen, device=dev) + 0.5).to(dt)
            w = (torch.randn((o, c, 3, 3), generator=gen, device=dev) / math.sqrt(9 * c)).to(dt)
            scale = 1.0 + 0.1 * torch.randn((c,), generator=gen, device=dev)
            shift = 0.1 * torch.randn((c,), generator=gen, device=dev)
            u = (shift.abs() + 6.0 * scale.abs()) / 127.0 + 1e-12  # GroupNormAct's k-sigma scale
            a = 1.0 + 0.2 * torch.randn((b, c), generator=gen, device=dev)
            off = 0.1 * torch.randn((b, c), generator=gen, device=dev)
            bias = 0.05 * torch.randn((o,), generator=gen, device=dev)
            args = (x, w, u, a, off, True, bias, dt)
            prepared = fq.prepare_qconv_weight(w, u)
            tile = fq.pick_tile(hh, ww, o)
            run_args = (x, prepared, a, off, True, bias, dt)
            out_tiles = {t: fq.qconv3x3_fused_prepared(*run_args, tile=t) for t in fq.TILES}
            out = out_tiles[tile]
            out_public = fq.qconv3x3_fused(*args)  # prepares, picks the tile, launches
            ref = fq.qconv3x3_fused_plain(*args)
            ctrl = fq.qconv3x3_edge_leak_plain(*args)
            torch.cuda.synchronize()
            top = max(1.0, float(ref.float().abs().max()))
            if dtype_name == "float32":
                tol = 4 * 127 * float(fq.quantize_weight_folded(w, u)[1].max())
            else:
                tol = 2.0 ** -7 * top
            err, flips, share, ok = judge(out, ref, tol)
            tile_errs = {t: judge(v, ref, tol) for t, v in out_tiles.items()}
            ctrl_err, _, ctrl_share, ctrl_ok = judge(ctrl, ref, tol)
            if not (ok and all(v[3] for v in tile_errs.values())):
                by_tile = {t: v[:2] for t, v in tile_errs.items()}
                raise AssertionError(f"qconv3x3_fused {shape} {dtype_name}: max_abs_err {err} "
                                     f"(tol {tol}), {flips} outputs off; (err, flips) by tile "
                                     f"{by_tile}")
            if not torch.equal(out_public, out):
                raise AssertionError(f"qconv3x3_fused {shape} {dtype_name}: the public call "
                                     "differs from the prepared one")
            if ctrl_ok:
                raise AssertionError(f"qconv3x3_fused {shape} {dtype_name}: the edge-leak control "
                                     f"passes (err {ctrl_err}, share {ctrl_share:.2e})")
            checked = dict(shape=list(shape), dtype=dtype_name, tile=tile, max_abs_err=err,
                           tol=tol, flips=flips, flip_share=share,
                           tile_max_abs_err={t: v[0] for t, v in tile_errs.items()},
                           tile_flips={t: v[1] for t, v in tile_errs.items()},
                           control_max_abs_err=ctrl_err, control_share=ctrl_share)
            if shape == QCONV_RAGGED:
                phase("kernel_check", name="qconv3x3_fused", **checked)
                del x, out, out_tiles, out_public, ref, ctrl
                continue
            esz = x.element_size()
            nbytes = (x.numel() + out.numel()) * esz + prepared.qw.numel() + (2 * b * c + c + 2 * o) * 4
            bms, by = bound(nbytes, 2 * 9 * b * hh * ww * c * o, "int8")
            act_x = F.silu(x.float() * a[:, :, None, None] + off[:, :, None, None]).to(dt)
            bias_dt = bias.to(dt)
            cases.append(dict(
                name="qconv3x3_fused", route="cuda", source="use_tpu_torch/csrc/fused_qconv.cu",
                replaces="use_tpu/ops/pallas_qconv.py:186", **checked,
                ms=time_ms(torch, lambda: fq.qconv3x3_fused_prepared(*run_args)),
                device_ms=device_ms(torch, lambda: fq.qconv3x3_fused_prepared(*run_args))[0],
                tile_ms={t: time_ms(torch, lambda: fq.qconv3x3_fused_prepared(*run_args, tile=t))
                         for t in fq.TILES},
                prep_ms=time_ms(torch, lambda: fq.prepare_qconv_weight(w, u)),
                plain_ms=time_ms(torch, lambda: fq.qconv3x3_fused_plain(*args), reps=3, warmup=1),
                library_ms=time_ms(torch, lambda: F.conv2d(act_x, w, bias_dt, padding=1)),
                bound_ms=bms, bound_by=by))
            phase("kernel", **{k: v for k, v in cases[-1].items()
                               if k not in ("route", "source", "replaces")})
            del x, out, out_tiles, out_public, ref, ctrl, act_x
    torch.cuda.empty_cache()
    return cases


def graph_nodes(torch, fn):
    """(kernel nodes, all nodes) of a CUDA graph captured around one fn()
    call: what the call puts on the stream, counted with libcuda's
    cuGraphGetNodes and cuGraphNodeGetType, not by the profiler."""
    import ctypes

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    cuda = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(raw, None, ctypes.byref(count)) != 0:
        raise AssertionError("graph_nodes: cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    if count.value and cuda.cuGraphGetNodes(raw, nodes, ctypes.byref(count)) != 0:
        raise AssertionError("graph_nodes: cuGraphGetNodes failed")
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) != 0:
            raise AssertionError("graph_nodes: cuGraphNodeGetType failed")
        kinds.append(kind.value)
    graph.reset()
    return kinds.count(0), len(kinds)  # 0: CU_GRAPH_NODE_TYPE_KERNEL


def check_launches(torch, name, shape, dtype, fn, want):
    """One call of a statistics wrapper puts exactly `want` kernels on the
    stream and nothing else (no copy, no memset); -> the kernel count."""
    kernels, nodes = graph_nodes(torch, fn)
    if kernels != want or nodes != kernels:
        raise AssertionError(f"{name} {shape} {dtype}: {kernels} kernels and {nodes - kernels} "
                             f"other operations a call, expected {want} kernels")
    return kernels


def check(name, shape, dtype, err, tol):
    if not (err <= tol):  # also catches NaN
        raise AssertionError(f"{name} {shape} {dtype}: max_abs_err {err} > tol {tol}")


def _randomize(torch, net, seed):
    """Seeded weights of unit-scale activations (the DDPM init zeroes some
    output convs, which would hide errors): kernels N(0, 1/fan_in), norm
    scales 1 + N(0, 0.1), biases N(0, 0.1); the frozen Fourier W is kept."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if "GroupNorm" in name and leaf == "weight":
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=gen))
            elif leaf in ("bias", "b"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
            elif p.dim() >= 2:
                fan_in = p.shape[0] if leaf == "W" else p[0].numel()
                p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(fan_in))


@contextlib.contextmanager
def bf16_statistics_control(torch, lanes=256):
    """A bf16 path broken on purpose, for the bf16 check to reject: GroupNorm
    channel sums accumulated in bf16, as a stats kernel with `lanes` bf16
    accumulators per channel would (the port accumulates in fp32)."""
    import torch.nn.functional as F

    from use_tpu_torch.ops import gn_stats

    def sums_bf16(x):
        b, c, s = x.shape
        xb = F.pad(x.bfloat16(), (0, -s % lanes)).reshape(b, c, -1, lanes)
        acc = torch.zeros((b, c, lanes), dtype=torch.bfloat16, device=x.device)
        acc2 = torch.zeros_like(acc)
        for k in range(xb.shape[2]):
            v = xb[:, :, k]
            acc, acc2 = acc + v, acc2 + v * v
        return acc.float().sum(-1), acc2.float().sum(-1)

    real = gn_stats.channel_sums
    gn_stats.channel_sums = sums_bf16
    try:
        yield
    finally:
        gn_stats.channel_sums = real


def forward_phase(torch, dev):
    """Full-width forward at the predict path's chunked shape, one t per
    lane: the card (kernels) against the CPU (plain versions) in fp32; then
    the bf16 compute path against fp32 on the card for BF16_SEEDS, and a
    broken bf16 control that the same limit must reject."""
    from use_tpu_torch.models import BackboneRegistry
    from use_tpu_torch.models.ncsnpp.ncsnpp import cast_backbone_for_inference

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    net = BackboneRegistry.get_by_name(FORWARD_BACKBONE)(input_channels=4, seed=0)
    _randomize(torch, net, seed=BF16_SEEDS[0])
    gen = torch.Generator().manual_seed(0)
    x = 0.5 * torch.randn(FORWARD_SHAPE, generator=gen)
    t = torch.linspace(0.1, 0.9, FORWARD_SHAPE[0])
    with torch.inference_mode():
        t0 = time.perf_counter()
        ref = net(x, t)
        cpu_s = time.perf_counter() - t0
        gnet = copy.deepcopy(net).to(dev)
        xd, td = x.to(dev), t.to(dev)
        out = gnet(xd, td)
        torch.cuda.synchronize()
        err = float((out.cpu() - ref).abs().max())
        top = float(ref.abs().max())
        tol = 1e-3 * top  # fp32 on both sides, ~100 layers summed in other orders
        if not (torch.isfinite(out).all() and err <= tol):
            raise AssertionError(f"forward: card vs CPU max_abs_err {err} > tol {tol}")
        phase("forward", backbone=FORWARD_BACKBONE, shape=list(FORWARD_SHAPE), dtype="float32",
              tf32=False, t=[round(float(v), 4) for v in t],
              max_abs_err=err, tol=tol, max_abs_ref=top, cpu_seconds=round(cpu_s, 2))
        del net, ref

        bnet = BackboneRegistry.get_by_name(FORWARD_BACKBONE)(input_channels=4, dtype="bfloat16")
        bnet = bnet.to(dev)
        cast_backbone_for_inference(bnet)  # as the CLI serves it; loads below round to bf16
        rel_errs, control = [], None
        for seed in BF16_SEEDS:
            if seed != BF16_SEEDS[0]:
                _randomize(torch, gnet, seed=seed)
                out = gnet(xd, td)
            bnet.load_state_dict(gnet.state_dict())
            out16 = bnet(xd, td)
            top = float(out.abs().max())
            if not torch.isfinite(out16).all():
                raise AssertionError(f"forward bf16 seed {seed}: non-finite output")
            rel_errs.append(float((out16 - out).abs().max()) / top)
            if control is None:
                with bf16_statistics_control(torch):
                    control = float((bnet(xd, td) - out).abs().max()) / top
        phase("forward", backbone=FORWARD_BACKBONE, shape=list(FORWARD_SHAPE), dtype="bfloat16",
              against="float32 on the card", seeds=list(BF16_SEEDS), max_rel_err=rel_errs,
              tol=BF16_REL_TOL, control="GroupNorm sums accumulated in bf16", control_rel_err=control)
        if not max(rel_errs) <= BF16_REL_TOL:
            raise AssertionError(f"forward bf16: max_rel_err {rel_errs} > tol {BF16_REL_TOL}")
        if not control > BF16_REL_TOL:
            raise AssertionError(f"forward bf16: control {control} passes tol {BF16_REL_TOL}")
    del gnet, bnet
    torch.cuda.empty_cache()


@contextlib.contextmanager
def swap_qconv(name):
    """fused_qconv.<name> (a plain version) in place of K3's kernel; K1 and
    K2 stay kernels."""
    from use_tpu_torch.ops import fused_qconv

    real = fused_qconv.qconv3x3_fused
    plain = getattr(fused_qconv, name)
    # the plain version quantizes the weight itself: drop FusedQConv3x3's prepared weights
    fused_qconv.qconv3x3_fused = lambda *args, prepared=None, **kw: plain(*args, **kw)
    try:
        yield
    finally:
        fused_qconv.qconv3x3_fused = real


@contextlib.contextmanager
def count_calls(owner, attr, out_channels):
    """Counts the calls of owner.<attr>(x, second, ...) by "HxW CtoO" (C from
    x, O = out_channels(second)) while it is in effect."""
    real = getattr(owner, attr)
    counts = {}

    def counting(x, second, *args, **kw):
        key = f"{x.shape[2]}x{x.shape[3]} {x.shape[1]}to{out_channels(second)}"
        counts[key] = counts.get(key, 0) + 1
        return real(x, second, *args, **kw)

    setattr(owner, attr, counting)
    try:
        yield counts
    finally:
        setattr(owner, attr, real)


def by_level(counts):
    return dict(sorted(counts.items(), key=lambda kv: -int(kv[0].split("x")[0])))


def int8_forward_phase(torch, dev):
    """Full-width int8 ncsnpplarge (quant='int8_pallas') at the chunked
    predict shape, fp32 and bf16 compute, for INT8_SEEDS: the card with K3
    against the card with K3's plain version, within INT8_REL_TOL of
    max|plain|, and the edge-leak control, which must exceed it; beside it,
    as readings and not gates, the same check between two runs with the
    kernel, the int8 output's relative L2 distance to the fp32 network
    without quantization, the forward's time with K3, and K3's and K2's calls
    by image size and channels."""
    from use_tpu_torch.models import BackboneRegistry
    from use_tpu_torch.models.ncsnpp import layers
    from use_tpu_torch.models.ncsnpp.ncsnpp import cast_backbone_for_inference
    from use_tpu_torch.ops import fused_qconv

    gen = torch.Generator().manual_seed(0)
    x = (0.5 * torch.randn(FORWARD_SHAPE, generator=gen)).to(dev)
    t = torch.linspace(0.1, 0.9, FORWARD_SHAPE[0]).to(dev)
    fnet = BackboneRegistry.get_by_name(FORWARD_BACKBONE)(input_channels=4).to(dev)
    for dtype in ("float32", "bfloat16"):
        # built outside inference mode, as the CLI builds it, so that its
        # parameters count in-place updates and K3's prepared weights are kept
        qnet = BackboneRegistry.get_by_name(FORWARD_BACKBONE)(
            input_channels=4, dtype=dtype, quant="int8_pallas").to(dev)
        cast_backbone_for_inference(qnet)  # as the CLI serves it (bf16: before quantizing)
        with torch.inference_mode():
            readings, control = [], None
            for seed in INT8_SEEDS:
                _randomize(torch, fnet, seed=seed)
                qnet.load_state_dict(fnet.state_dict())
                ref32 = fnet(x, t)
                with count_calls(fused_qconv, "qconv3x3_fused", lambda w: w.shape[0]) as calls, \
                        count_calls(layers, "fused_skip_add", lambda h: h.shape[1]) as skip_calls:
                    out = qnet(x, t)
                again = qnet(x, t)
                with swap_qconv("qconv3x3_fused_plain"):
                    plain = qnet(x, t)
                torch.cuda.synchronize()
                if not torch.isfinite(out).all():
                    raise AssertionError(f"int8 forward {dtype} seed {seed}: non-finite output")
                top = float(plain.abs().max())
                readings.append(dict(
                    seed=seed, max_rel_err=float((out - plain).abs().max()) / top,
                    repeat_max_rel_err=float((again - out).abs().max()) / top,
                    rel_l2_vs_fp32=float((out - ref32).norm() / ref32.norm())))
                if control is None:
                    with swap_qconv("qconv3x3_edge_leak_plain"):
                        control = float((qnet(x, t) - plain).abs().max()) / top
            ms = time_ms(torch, lambda: qnet(x, t), reps=3, warmup=1)
            phase("int8_forward", backbone=FORWARD_BACKBONE, shape=list(FORWARD_SHAPE), dtype=dtype,
                  quant="int8_pallas", against="K3's plain version on the card",
                  tol=INT8_REL_TOL, readings=readings, control="edge mask removed",
                  control_max_rel_err=control, ms=ms,
                  qconv_calls=by_level(calls), skip_calls=by_level(skip_calls))
            worst = max(r["max_rel_err"] for r in readings)
            if not worst <= INT8_REL_TOL:
                raise AssertionError(f"int8 forward {dtype}: max_rel_err {worst} > "
                                     f"tol {INT8_REL_TOL}")
            if not control > INT8_REL_TOL:
                raise AssertionError(f"int8 forward {dtype}: control {control} passes "
                                     f"tol {INT8_REL_TOL}")
            del qnet
    del fnet
    torch.cuda.empty_cache()


def predict_phase(torch, dev, label, extra_args):
    """The CLI's predict on two synthetic clips with `extra_args`; checks the
    outputs and that each kernel launched exactly PER_FORWARD[label] times a
    forward (one forward a sampler step and file)."""
    from use_tpu_torch import ops
    from use_tpu_torch.cli.main import main as cli_main

    sr = 24000
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        src, dst = os.path.join(tmp, "in"), os.path.join(tmp, "out")
        lengths = write_clips(src, PREDICT_CLIPS_S, sr)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        summary = cli_main(["predict", f"experiment={PREDICT_EXPERIMENT}",
                            f"predict.data_folder={src}", f"predict.target_folder={dst}",
                            f"infer.N={PREDICT_N}", f"device={dev}", *extra_args])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        check_outputs(dst, lengths, sr, summary)
    forwards = len(lengths) * PREDICT_N
    want = {k: v * forwards for k, v in PER_FORWARD[label].items()}
    if counts != want:
        raise AssertionError(f"predict {label}: kernel launches {counts}, expected {want} "
                             f"({PER_FORWARD[label]} x {forwards} forwards)")
    phase("predict", run=label, experiment=PREDICT_EXPERIMENT, args=list(extra_args), N=PREDICT_N,
          clips_s=list(PREDICT_CLIPS_S), tf32=bool(torch.backends.cudnn.allow_tf32),
          files=summary["files"], audio_seconds=summary["audio_seconds"],
          sampling_seconds=summary["seconds"], wall_seconds=wall,
          audio_s_per_s=summary["audio_seconds"] / summary["seconds"], launches=counts)
    return counts


def write_clips(src, clips_s, sr):
    """Synthetic wavs (a 220 Hz tone in noise) of `clips_s` seconds under
    src/; -> {relative path: samples}."""
    from use_tpu_torch.data.audio_io import write_wav

    rng = np.random.default_rng(3)
    lengths = {}
    for i, secs in enumerate(clips_s):
        n = secs * sr
        tt = np.arange(n) / sr
        wav = 0.3 * np.sin(2 * np.pi * 220 * tt) + 0.05 * rng.standard_normal(n)
        rel = ("a/short.wav", "b/long.wav")[i] if len(clips_s) == 2 else f"clip{i}.wav"
        write_wav(os.path.join(src, rel), wav.astype(np.float32), sr)
        lengths[rel] = n
    return lengths


def check_outputs(dst, lengths, sr, summary):
    """The predict run wrote every clip, mirrored, length-matched, finite."""
    from use_tpu_torch.data.audio_io import read_wav

    for rel, n in lengths.items():
        data, got_sr = read_wav(os.path.join(dst, rel))
        if got_sr != sr or data.shape != (n,) or not np.isfinite(data).all():
            raise AssertionError(f"predict output {rel}: sr {got_sr}, shape {data.shape}")
    if summary["files"] != len(lengths):
        raise AssertionError(f"predict wrote {summary['files']} files")


def lsgan_forward_phase(torch, dev):
    """The shipped LSGAN generator's backbone (`ncsnpp`, discriminative, fp32,
    full width) with seeded random weights at GAN_FORWARD_SHAPE: the card
    (kernels) against the CPU (plain versions) within 1e-3 x max|ref|, as
    forward_phase; the launches of one forward on the card must equal
    PER_GENERATOR_FORWARD; K2's calls by level; the forward's time."""
    from use_tpu_torch import ops
    from use_tpu_torch.models import BackboneRegistry
    from use_tpu_torch.models.ncsnpp import layers

    net = BackboneRegistry.get_by_name("ncsnpp")(discriminative=True, seed=0)
    _randomize(torch, net, seed=1)
    x = 0.5 * torch.randn(GAN_FORWARD_SHAPE, generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        t0 = time.perf_counter()
        ref = net(x, None)
        cpu_s = time.perf_counter() - t0
        gnet = copy.deepcopy(net).to(dev)
        xd = x.to(dev)
        ops.reset_launch_counts()
        with count_calls(layers, "fused_skip_add", lambda h: h.shape[1]) as skip_calls:
            out = gnet(xd, None)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        err = float((out.cpu() - ref).abs().max())
        top = float(ref.abs().max())
        tol = 1e-3 * top
        ms = time_ms(torch, lambda: gnet(xd, None), reps=5, warmup=1)
    phase("lsgan_forward", backbone="ncsnpp", discriminative=True, shape=list(GAN_FORWARD_SHAPE),
          dtype="float32", tf32=False, max_abs_err=err, tol=tol, max_abs_ref=top,
          cpu_seconds=round(cpu_s, 2), ms=ms, launches=counts, skip_calls=by_level(skip_calls))
    if not (torch.isfinite(out).all() and err <= tol):
        raise AssertionError(f"lsgan forward: card vs CPU max_abs_err {err} > tol {tol}")
    if counts != PER_GENERATOR_FORWARD:
        raise AssertionError(f"lsgan forward: launches {counts}, expected {PER_GENERATOR_FORWARD}")
    del net, gnet, ref, out
    torch.cuda.empty_cache()


def flops_phase(torch, dev):
    """TFLOP of one forward at each of FLOPS_FORWARDS' full shapes, on the
    card: torch.utils.flop_counter counts the convolutions, matmuls and the
    attention as they dispatch; K2 runs outside torch's dispatch, so each of
    its calls adds its 2 * B * S * Ci * Co here. GroupNorm, SiLU and the FIR
    resampling are not counted."""
    from torch.utils.flop_counter import FlopCounterMode

    from use_tpu_torch.models import BackboneRegistry
    from use_tpu_torch.models.ncsnpp import layers

    real = layers.fused_skip_add
    for backbone, kwargs, shape in FLOPS_FORWARDS:
        net = BackboneRegistry.get_by_name(backbone)(seed=0, **kwargs).to(dev)
        x = torch.zeros(shape, device=dev)
        t = None if kwargs.get("discriminative") else torch.full((shape[0],), 0.5, device=dev)
        skip_flops = [0]

        def counting(x, h, *args, **kw):
            skip_flops[0] += 2 * x.shape[0] * x.shape[2] * x.shape[3] * x.shape[1] * h.shape[1]
            return real(x, h, *args, **kw)

        layers.fused_skip_add = counting
        try:
            with torch.inference_mode(), FlopCounterMode(display=False) as counter:
                net(x, t)
        finally:
            layers.fused_skip_add = real
        torch.cuda.synchronize()
        total = counter.get_total_flops() + skip_flops[0]
        phase("flops", backbone=backbone, kwargs=kwargs, shape=list(shape), tflop=total / 1e12,
              k2_tflop=skip_flops[0] / 1e12)
        del net, x
        torch.cuda.empty_cache()


@contextlib.contextmanager
def stage_counts():
    """Per stage of a predict run, "sgmse" (ScoreModel.sample) and "lsgan"
    (LSGAN.enhance): the backbone forwards (NCSNpp.forward calls) and each
    kernel's launches it made, summed over the run."""
    from use_tpu_torch import ops
    from use_tpu_torch.models.gan.lsgan import LSGAN
    from use_tpu_torch.models.ncsnpp.ncsnpp import NCSNpp
    from use_tpu_torch.models.sgmse.score_model import ScoreModel

    stages = {}
    forwards = [0]
    real_forward, real_sample, real_enhance = NCSNpp.forward, ScoreModel.sample, LSGAN.enhance

    def forward(self, *args, **kw):
        forwards[0] += 1
        return real_forward(self, *args, **kw)

    def staged(name, real):
        def run(self, *args, **kw):
            before, f0 = ops.launch_counts(), forwards[0]
            out = real(self, *args, **kw)
            after = ops.launch_counts()
            st = stages.setdefault(name, {"forwards": 0, "launches": dict.fromkeys(after, 0)})
            st["forwards"] += forwards[0] - f0
            for k in after:
                st["launches"][k] += after[k] - before[k]
            return out
        return run

    NCSNpp.forward = forward
    ScoreModel.sample = staged("sgmse", real_sample)
    LSGAN.enhance = staged("lsgan", real_enhance)
    try:
        yield stages
    finally:
        NCSNpp.forward, ScoreModel.sample, LSGAN.enhance = real_forward, real_sample, real_enhance


def stage_predict_phase(torch, dev, label, experiment, extra_args, clips_s, per_stage):
    """The CLI's predict with `extra_args` on synthetic clips of `clips_s`
    seconds, fp32; checks the outputs, that the stages in `per_stage` ran,
    and per stage that each kernel launched exactly per_stage[stage] times a
    backbone forward, with the SGMSE stage's forwards equal to its NFE (pc,
    ode) or its sweeps (parallel_pc: W trajectory points a forward) and one
    LSGAN forward a file. Reports NFE, sweeps, peak device memory (after a
    reset of the peak) and audio-s/s; -> the run's launches by kernel."""
    from use_tpu_torch import ops
    from use_tpu_torch.cli.main import main as cli_main

    sr = 24000
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        src, dst = os.path.join(tmp, "in"), os.path.join(tmp, "out")
        lengths = write_clips(src, clips_s, sr)
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with stage_counts() as stages:
            summary = cli_main(["predict", f"experiment={experiment}",
                                f"predict.data_folder={src}", f"predict.target_folder={dst}",
                                f"device={dev}", *extra_args])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        counts = ops.launch_counts()
        check_outputs(dst, lengths, sr, summary)
    phase("predict", run=label, experiment=experiment, args=list(extra_args),
          clips_s=list(clips_s), tf32=bool(torch.backends.cudnn.allow_tf32),
          files=summary["files"], audio_seconds=summary["audio_seconds"],
          sampling_seconds=summary["seconds"], wall_seconds=wall,
          audio_s_per_s=summary["audio_seconds"] / summary["seconds"],
          nfe=summary.get("nfe"), sweeps=summary.get("sweeps"), peak_memory_bytes=peak,
          stages=stages, launches=counts)
    if set(stages) != set(per_stage):
        raise AssertionError(f"predict {label}: stages {sorted(stages)}, expected {sorted(per_stage)}")
    for name, st in stages.items():
        want = {k: v * st["forwards"] for k, v in per_stage[name].items()}
        if st["launches"] != want:
            raise AssertionError(f"predict {label}, stage {name}: launches {st['launches']}, "
                                 f"expected {want} ({st['forwards']} forwards)")
    if "lsgan" in stages and stages["lsgan"]["forwards"] != len(lengths):
        raise AssertionError(f"predict {label}: {stages['lsgan']['forwards']} generator forwards "
                             f"for {len(lengths)} files")
    if "sgmse" in stages:
        calls = summary["sweeps"] if "sweeps" in summary else summary["nfe"]
        if stages["sgmse"]["forwards"] != calls or calls == 0:
            raise AssertionError(f"predict {label}: {stages['sgmse']['forwards']} score-net "
                                 f"forwards, the sampler reports {calls}")
    return counts


def profile_phase(torch, dev):
    """One full-width forward at the chunked predict shape (8 lanes of a 6 s
    clip): wall ms in fp32 and bf16 (median of 5, CUDA events); then for the
    fp32, the bf16 and the int8 bf16 serving forward, and the LSGAN
    generator's fp32 forward at GAN_FORWARD_SHAPE, the kernel time of one
    profiled forward by name, against that forward's profiled wall time
    (`busy_share`) and against the unprofiled wall time (`unprofiled_ms`,
    median of 5, CUDA events; `unprofiled_busy_share`): the profiler's own
    host overhead leaves the card idle in the profiled run. `op_counts`
    counts the host's torch ops (those called 20 times or more) in the
    profiled forward. Every net is built outside inference mode and its
    weights cast for serving (``cast_backbone_for_inference``), as the CLI
    builds it, so that the weights the layers prepare once are kept."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from use_tpu_torch.models import BackboneRegistry
    from use_tpu_torch.models.ncsnpp.ncsnpp import cast_backbone_for_inference

    shape = FORWARD_SHAPE
    x = torch.randn(shape, device=dev)
    t = torch.full((shape[0],), 0.5, device=dev)
    for dtype in ("float32", "bfloat16"):
        net = BackboneRegistry.get_by_name("ncsnpplarge")(input_channels=4, dtype=dtype).to(dev)
        cast_backbone_for_inference(net)
        with torch.inference_mode():
            phase("forward_timing", shape=list(shape), dtype=dtype, tf32=False,
                  ms=time_ms(torch, lambda: net(x, t), reps=5, warmup=2))
    nets = [(dict(backbone="ncsnpplarge", dtype=dtype, quant=quant), (x, t))
            for dtype, quant in (("float32", "none"), ("bfloat16", "none"),
                                 ("bfloat16", "int8_pallas"))]
    # the LSGAN generator, fp32 as shipped, at the 10 s clip
    nets.append((dict(backbone="ncsnpp", dtype="float32", quant="none", discriminative=True),
                 (torch.randn(GAN_FORWARD_SHAPE, device=dev), None)))
    for kw, net_args in nets:
        kw = dict(kw)
        name = kw.pop("backbone")
        if not kw.get("discriminative"):
            kw["input_channels"] = 4
        net = BackboneRegistry.get_by_name(name)(**kw).to(dev)
        cast_backbone_for_inference(net)
        with torch.inference_mode():
            unprofiled_ms = time_ms(torch, lambda: net(*net_args), reps=5, warmup=2)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                net(*net_args)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            events = prof.key_averages()
            key = "device_time_total" if hasattr(events[0], "device_time_total") else "cuda_time_total"
            kernel_ms = sum(getattr(e, "self_" + key) for e in events
                            if e.device_type == DeviceType.CUDA) / 1e3
            op_counts = {e.key: e.count for e in events
                         if e.device_type == DeviceType.CPU and e.key.startswith("aten::")
                         and e.count >= 20}
            phase("profile", backbone=name, shape=list(net_args[0].shape), dtype=kw["dtype"],
                  quant=kw["quant"], wall_ms=wall_ms,
                  kernel_ms=kernel_ms, busy_share=kernel_ms / wall_ms,
                  unprofiled_ms=unprofiled_ms, unprofiled_busy_share=kernel_ms / unprofiled_ms,
                  op_counts=dict(sorted(op_counts.items(), key=lambda kv: -kv[1])))
            print(events.table(sort_by="self_" + key, row_limit=30))
        del net


if __name__ == "__main__":
    sys.exit(main())
