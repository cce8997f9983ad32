#!/usr/bin/env python3
"""Chip smoke test of use_tpu_torch, the PyTorch / CUDA port, on one GPU.

    python3 chip_smoke.py              # the full check, one card
    python3 chip_smoke.py --kernels    # build + per-kernel phases (and gradients) only
    python3 chip_smoke.py --profile    # also profile one full-width forward and
                                       # one training microbatch
    python3 chip_smoke.py --gan        # build, kernels, then only the LSGAN
                                       # training and eval phases (13-16)

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
     counts, with NFE, sweeps, peak device memory and audio-s/s;
  9. grad_check: at training shapes, the gradients through K1's statistics
     and apply (group_norm_act, swish and none) and through K2 on the card
     against autograd through their plain versions on the card, within
     GRAD_REL_TOL of each gradient's largest value, and a control broken on
     purpose (the statistics' backward without its factor 2) that must
     exceed it;
 10. train_step: one full-width ncsnpplarge microbatch of the SGMSE_Large
     recipe ([2, 512, 512, 4] net input, fp32, remat conv_outs) through
     train_loss, backward and one optimizer step: loss and every gradient on
     the card against the CPU on the same weights, batch and draws
     (each gradient within TRAIN_GRAD_REL_TOL of its own largest value; the
     same microbatch with TF32 on is a control that must exceed it), each
     kernel's launches per microbatch exactly TRAIN_LAUNCHES (with and
     without remat), time and peak device memory with remat and without;
 11. train: the CLI's `train experiment=SGMSE_Large` on TRAIN_CLIPS
     synth_speech clips (3 optimizer steps of batch 2 x accumulation 4),
     with seconds per optimizer step and per microbatch, trained audio-s/s,
     peak memory, the losses, one profiled step's device busy share and the
     run's exact launches; then `predict ckpt_path=<out_dir>/checkpoints
     infer.N=3` on one clip serves what was trained;
 12. learn: use_tpu's learning gate (tests/test_learning.py::
     test_sgmse_learns_to_enhance) on the card at its seed 0, one run with
     deterministic algorithms: a tiny score net overfit for 600 steps must
     enhance held-out speech probes by more than 2 dB SI-SDR;
 13. gan_train_step: one full-width microbatch of the LSGAN recipe (the
     `ncsnpp` generator, fp32, remat conv_outs, net input [2, 512, 480, 2];
     the 24k_MVD bank on 76 640-sample clips): its D phase and G phase on
     the card against the CPU on the same weights, batch and crop start
     (the losses, and every D and G gradient within TRAIN_GRAD_REL_TOL of
     its own tensor's largest value; the same microbatch with TF32 on is a
     control that must exceed it), then gan_train_step with both Adam
     steps: its exact launches (GAN_TRAIN_LAUNCHES, with remat and
     without), seconds per microbatch and peak device memory;
 14. train_lsgan: the CLI's `train experiment=LSGAN` as shipped (micro 2 x
     accumulation 16) on GAN_TRAIN_CLIPS synth_speech clips, two optimizer
     steps: finite losses, a checkpoint of G and D, optimized_metric.json,
     the run's exact launches (training microbatches, validation and test
     forwards), seconds per optimizer step, trained audio-s/s, the
     loader's wait and peak memory; then `predict experiment=LSGAN
     ckpt_path=<out_dir>/checkpoints` on one clip, and `eval
     experiment=LSGAN` of that checkpoint (phase 15's checks);
 15. eval: `eval experiment=SGMSE_Large infer.N=3 eval.max_files=2` with
     seeded weights on EVAL_CLIPS clips: finite test losses, the rich
     metrics (si_sdr, si_sir, si_sar, lsd, estoi; pesq_wb where the `pesq`
     package imports), whether figures were drawn, and exact launches (per
     backbone forward, the forwards being the test batches and the
     sampler's steps);
 16. learn_lsgan: use_tpu's LSGAN learning gate (tests/test_learning.py::
     test_lsgan_generator_learns_to_enhance) at its seed 0, probe sizes and
     rates, six runs at once (one with deterministic algorithms, reported):
     each G loss falls, and the median gain of the enhanced SI-SDR of
     held-out probes over the noisy one, over the five runs without
     deterministic algorithms, must exceed 1 dB.
Each phase prints its seconds. Then a JSON line of the kernels, the card
line, and the last line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
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
    (2, 128, 512, 512),  # training: a microbatch of the recipe at full resolution
    (2, 128, 512, 480),  # LSGAN training: a generator microbatch at full resolution
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
    (2, 256, 128, 512, 512),  # training: up path, full resolution, a microbatch of the recipe
    (2, 128, 256, 256, 240),  # LSGAN training: level 1's first block (128 -> 256), a microbatch
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
# training (phases 9-12)
GRAD_GN_SHAPES = [(2, 128, 512, 512), (2, 256, 32, 32)]  # full resolution and a low level
GRAD_SKIP_SHAPES = [(2, 256, 128, 512, 512), (2, 512, 256, 128, 128)]  # (B, Ci, Co, H, W)
# gradient through a kernel's Function against autograd through its plain
# version, both on the card in fp32, relative to the gradient's largest
# value: the same math in another summation order (PERF.md: readings at
# ~1e-6, the broken control at >= 1e-2)
GRAD_REL_TOL = 1e-4
TRAIN_EXPERIMENT = "SGMSE_Large"
TRAIN_SHAPE = (2, 512, 512, 4)  # one microbatch of net input: batch 2, 512 bins x 512 frames
# a gradient on the card against the CPU's: within TRAIN_GRAD_REL_TOL of its
# own tensor's largest value, every tensor but the attention's key biases,
# whose gradient is zero in exact arithmetic (softmax ignores a shift that
# is the same for every key): both devices must leave them below
# KEY_BIAS_GRAD_FLOOR of the net's largest gradient (PERF.md: fp32 readings
# at <= 2.3e-5, the TF32 control at 2.2e-3 worst and 8.2e-4 median)
TRAIN_GRAD_REL_TOL = 2e-4
KEY_BIAS_GRAD_FLOOR = 1e-6
# kernel launches per full-width microbatch (forward and backward); counted
# on the CPU by tests/test_torch_train.py::test_remat_launch_constants_of_chip_smoke
TRAIN_LAUNCHES = {
    "remat": {"channel_sums": 204, "gn_apply": 204, "fused_skip_add": 68, "qconv3x3_fused": 0},
    "no_remat": {"channel_sums": 106, "gn_apply": 106, "fused_skip_add": 34, "qconv3x3_fused": 0},
}
TRAIN_CLIPS, TRAIN_CLIP_S = 24, 4  # 24 clips: 3 optimizer steps of 2 x 4 an epoch
TRAIN_PREDICT_N = 3
CROP_S = 81760 / 24000  # a training crop: 511 hops of 160 samples at 24 kHz
JAX_LEARN_GAIN_DB = 5.65  # tests/test_learning.py:16
# LSGAN training (phases 13-16)
GAN_EXPERIMENT = "LSGAN"
GAN_TRAIN_SHAPE = (2, 512, 480, 2)  # a microbatch of generator input: 2 clips, 512 bins x 480 frames
# kernel launches per full-width LSGAN microbatch: the D phase's generator
# forward without autograd (45 / 45 / 15, PER_GENERATOR_FORWARD), the G
# phase's forward (45 / 45 / 15) and, under remat, its recomputation of the
# residual blocks (the 40 GroupNorms and 15 shortcuts inside them); counted
# on the CPU by tests/test_torch_gan_train.py::test_gan_launch_constants_of_chip_smoke
GAN_TRAIN_LAUNCHES = {
    "remat": {"channel_sums": 130, "gn_apply": 130, "fused_skip_add": 45, "qconv3x3_fused": 0},
    "no_remat": {"channel_sums": 90, "gn_apply": 90, "fused_skip_add": 30, "qconv3x3_fused": 0},
}
GAN_TRAIN_CLIPS = 64  # two optimizer steps of 2 x 16 an epoch
# the items of train_lsgan spliced to 3.5 s (the recipe's 6 s): still longer
# than the 3.19 s crop, and the loaders' synthesis of the 64 training, 64
# validation and 64 test items, most of that phase's time, shrinks with them
GAN_SPLICE_S = 3.5
GAN_CROP_S = 76640 / 24000  # a generator training crop: 479 hops of 160 samples
EVAL_SGMSE, EVAL_CLIPS, EVAL_FILES, EVAL_N = "SGMSE_Large", 4, 2, 3
JAX_GAN_LEARN_GAIN_DB = (1.9, 7.0)  # tests/test_learning.py:160, :183 (CPU runs)
# the LSGAN gate's runs at seed 0, deterministic algorithms or not: the gate
# is the median of the runs without; the deterministic run, one fixed
# trajectory (-1.51 dB on an H100 in four calls), is reported beside them.
# Nine of ten runs without read +3.8 to +5.6 dB, one -0.53 (PERF.md).
LEARN_LSGAN_RUNS = (True, False, False, False, False, False)
RICH_KEYS = {"si_sdr", "si_sir", "si_sar", "lsd", "estoi"}

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
    ap.add_argument("--gan", action="store_true",
                    help="build, kernels, then only the LSGAN training and eval phases")
    args = ap.parse_args()
    # the learn phase runs cuBLAS deterministically, which needs this before its first call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

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
    timed("grad_check", grad_check_phase, torch, dev)
    runs = {label: {name: None for name in results}
            for label in (*PER_FORWARD, "train", "train_lsgan")}
    if args.gan:
        runs.update(gan_phases(torch, dev))
    elif not args.kernels:
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
        timed("train_step", train_step_phase, torch, dev)
        runs["train"] = timed("train", train_phase, torch, dev)
        timed("learn", learn_phase, torch, dev)
        runs.update(gan_phases(torch, dev))
        if args.profile:
            timed("profile", profile_phase, torch, dev)
            timed("profile_train", profile_train_phase, torch, dev)

    line = []
    for name, cases in results.items():
        main_case = cases[0]
        entry = {k: main_case[k] for k in (
            "name", "route", "source", "replaces", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "shape", "dtype", "device_ms") if k in main_case}
        # the count of the run whose path the kernel is on: K3 int8 serving,
        # K1 and K2 this slice's LSGAN training (both phases, validation, test)
        entry["launches"] = runs["int8_bfloat16" if name == "qconv3x3_fused"
                                 else "train_lsgan"][name]
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


def _rel_err(got, want):
    """max |got - want| relative to max |want|."""
    top = float(want.abs().max())
    return float((got - want).abs().max()) / (top if top > 0 else 1.0)


@contextlib.contextmanager
def sums_backward_without_factor_2(torch):
    """A statistics backward broken on purpose, for the gradient check to
    reject: dx = ds + x dss (the 2 of d(x^2)/dx dropped)."""
    from use_tpu_torch.ops import gn_stats

    real = gn_stats._ChannelSums.backward

    def broken(ctx, ds, dss):
        (x,) = ctx.saved_tensors
        return (ds[:, :, None] + x.float() * dss[:, :, None]).to(x.dtype)

    gn_stats._ChannelSums.backward = staticmethod(broken)
    try:
        yield
    finally:
        gn_stats._ChannelSums.backward = real


def grad_check_phase(torch, dev):
    """Gradients through the kernels' autograd Functions (the kernel in the
    forward, torch ops in the backward) against autograd through their plain
    versions, on the card in fp32, at the training shapes: K1 as
    group_norm_act (statistics + apply, act swish and none) for x, weight
    and bias, K2 for x, h, W and b. The cotangent is noise plus the plain
    output, so that the statistics' share of dx is large; the control (the
    statistics' backward without its factor 2) must fail GRAD_REL_TOL."""
    from use_tpu_torch.ops import fused_skip as fs
    from use_tpu_torch.ops import gn_stats as g

    gen = torch.Generator(device=dev).manual_seed(4)

    def gn_grads(x, w, b, act, dy, groups, plain):
        leaves = [t.detach().clone().requires_grad_() for t in (x, w, b)]
        x3 = leaves[0].reshape(x.shape[0], x.shape[1], -1)
        if plain:
            y = g.gn_apply_plain(x3, *g.channel_sums_plain(x3), leaves[1], leaves[2], groups,
                                 1e-6, act)
        else:
            y = g.gn_apply(x3, *g.channel_sums(x3), leaves[1], leaves[2], groups, 1e-6, act)
        return torch.autograd.grad(y.reshape(x.shape), leaves, dy)

    for shape in GRAD_GN_SHAPES:
        c = shape[1]
        groups = g.num_groups(c)
        x = torch.randn(shape, generator=gen, device=dev) + 0.5
        w = 1.0 + 0.1 * torch.randn((c,), generator=gen, device=dev)
        b = 0.1 * torch.randn((c,), generator=gen, device=dev)
        for act in ("swish", None):
            x3 = x.reshape(shape[0], c, -1)
            with torch.no_grad():
                y = g.gn_apply_plain(x3, *g.channel_sums_plain(x3), w, b, groups, 1e-6, act)
            dy = torch.randn(shape, generator=gen, device=dev) + y.reshape(shape)
            ref = gn_grads(x, w, b, act, dy, groups, plain=True)
            before = dict(channel_sums=g.channel_sums.launches, gn_apply=g.gn_apply.launches)
            got = gn_grads(x, w, b, act, dy, groups, plain=False)
            launched = {k: getattr(g, k).launches - v for k, v in before.items()}
            with sums_backward_without_factor_2(torch):
                ctrl = gn_grads(x, w, b, act, dy, groups, plain=False)
            torch.cuda.synchronize()
            errs = {n: _rel_err(a, r) for n, a, r in zip(("x", "weight", "bias"), got, ref)}
            ctrl_err = max(_rel_err(a, r) for a, r in zip(ctrl, ref))
            phase("grad_check", name="group_norm_act", shape=list(shape), act=act,
                  dtype="float32", max_rel_err=errs, tol=GRAD_REL_TOL, launches=launched,
                  control="channel_sums backward without its factor 2",
                  control_max_rel_err=ctrl_err)
            if not (max(errs.values()) <= GRAD_REL_TOL and all(torch.isfinite(t).all()
                                                                for t in got)):
                raise AssertionError(f"grad_check group_norm_act {shape} {act}: {errs} > "
                                     f"tol {GRAD_REL_TOL}")
            if launched != {"channel_sums": 1, "gn_apply": 1}:
                raise AssertionError(f"grad_check group_norm_act {shape}: launches {launched}")
            if not ctrl_err > GRAD_REL_TOL:
                raise AssertionError(f"grad_check group_norm_act {shape} {act}: the control "
                                     f"passes ({ctrl_err} <= {GRAD_REL_TOL})")
        del x, x3, y, dy, ref, got, ctrl

    for shape in GRAD_SKIP_SHAPES:
        bsz, ci, co, hh, ww = shape
        args = [torch.randn((bsz, ci, hh, ww), generator=gen, device=dev),
                torch.randn((bsz, co, hh, ww), generator=gen, device=dev),
                torch.randn((co, ci, 1, 1), generator=gen, device=dev) / math.sqrt(ci),
                0.1 * torch.randn((co,), generator=gen, device=dev)]
        dy = torch.randn((bsz, co, hh, ww), generator=gen, device=dev)
        scale = 2 ** -0.5

        def skip_grads(fn):
            leaves = [t.detach().clone().requires_grad_() for t in args]
            return torch.autograd.grad(fn(*leaves, scale), leaves, dy)

        ref = skip_grads(fs.fused_skip_add_plain)
        before = fs.fused_skip_add.launches
        got = skip_grads(fs.fused_skip_add)
        launched = fs.fused_skip_add.launches - before
        torch.cuda.synchronize()
        errs = {n: _rel_err(a, r) for n, a, r in zip(("x", "h", "W", "b"), got, ref)}
        phase("grad_check", name="fused_skip_add", shape=list(shape), dtype="float32",
              max_rel_err=errs, tol=GRAD_REL_TOL, launches=launched)
        if not max(errs.values()) <= GRAD_REL_TOL or launched != 1:
            raise AssertionError(f"grad_check fused_skip_add {shape}: {errs} (tol "
                                 f"{GRAD_REL_TOL}), {launched} launches")
        del args, dy, ref, got
    torch.cuda.empty_cache()


def _train_model(torch, device, remat=True):
    """The recipe's score model (SGMSE_Large: ncsnpplarge, fp32, remat
    conv_outs) on `device`, seeded random unit-scale weights."""
    from use_tpu_torch.config.config import load_config
    from use_tpu_torch.models.sgmse.score_model import ScoreModel

    cfg = load_config(TRAIN_EXPERIMENT)
    mcfg = dict(cfg["model"])
    mcfg["backbone_kwargs"] = {**mcfg["backbone_kwargs"], "remat": remat}
    model = ScoreModel(**mcfg, device="cpu", seed=0)
    _randomize(torch, model.score_net, seed=1)
    model.score_net.to(device)
    model.device = torch.device(device)
    return model, cfg


def _train_batch(torch, model, seed=5):
    """One microbatch of two clips a little longer than the crop, and the
    loss's draws (crop start, t, z) from a CPU generator."""
    length = model.target_len + 4000
    rng = np.random.default_rng(seed)
    clean = (0.3 * rng.standard_normal((TRAIN_SHAPE[0], length))).astype(np.float32)
    noisy = (clean + 0.1 * rng.standard_normal(clean.shape)).astype(np.float32)
    batch = {"clean": torch.from_numpy(clean), "perturbed": torch.from_numpy(noisy)}
    return batch, model.draw_train(TRAIN_SHAPE[0], length, torch.Generator().manual_seed(seed))


def _microbatch(torch, model, batch, draws):
    """Forward and backward of one microbatch; -> (loss, seconds) after a
    synchronize."""
    dev = model.device
    model.score_net.zero_grad(set_to_none=True)
    t0 = time.perf_counter()
    loss = model.train_loss({k: v.to(dev) for k, v in batch.items()},
                            draws=(draws[0], draws[1].to(dev), draws[2].to(dev)))
    loss.backward()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return loss.detach(), time.perf_counter() - t0


def _grad_errors(net, want, key_biases):
    """Each gradient of `net` against `want` (the CPU's): -> ({name: max
    |got - want| / max |want|} over every tensor but `key_biases`, {key
    bias: [max |got|, max |want|] / the largest |want| of all}). A tensor
    with a gradient on one side only fails."""
    top = max(float(g.abs().max()) for g in want.values())
    rel, key_bias = {}, {}
    for k, p in net.named_parameters():
        if (p.grad is None) != (k not in want):
            raise AssertionError(f"train_step: {k} has a gradient on one device only")
        if p.grad is None:
            continue
        got = p.grad.cpu()
        if k in key_biases:
            key_bias[k] = [float(got.abs().max()) / top, float(want[k].abs().max()) / top]
        else:
            rel[k] = float((got - want[k]).abs().max()) / float(want[k].abs().max())
    return rel, key_bias


def _small_grads(want, rel, share):
    """{name: [max |want| / the largest of all, its relative error]} of the
    checked tensors whose gradient is below `share` of the net's largest."""
    top = max(float(g.abs().max()) for g in want.values())
    return {k: [float(want[k].abs().max()) / top, e] for k, e in rel.items()
            if float(want[k].abs().max()) < share * top}


def train_step_phase(torch, dev):
    """One full-width microbatch of the recipe through train_loss and
    backward on the CPU (plain versions) and on the card (kernels), on the
    same weights, batch and draws: the loss within 1e-4 relative, every
    gradient within TRAIN_GRAD_REL_TOL of its own tensor's largest value
    (the attention's key biases, zero in exact arithmetic, below
    KEY_BIAS_GRAD_FLOOR of the largest of all on both devices), the same
    microbatch with TF32 on off by more than that; each kernel launched exactly
    TRAIN_LAUNCHES["remat"] times; then one optimizer step (clip, L2, Adam)
    leaves finite, changed weights. Then the microbatch's time and peak
    device memory with remat (median of 3) and without, whose launches must
    be TRAIN_LAUNCHES["no_remat"]."""
    from use_tpu_torch import ops
    from use_tpu_torch.engine.loop import build_train_state

    cpu, cfg = _train_model(torch, "cpu")
    batch, draws = _train_batch(torch, cpu)
    loss_cpu, cpu_s = _microbatch(torch, cpu, batch, draws)
    grads_cpu = {k: p.grad for k, p in cpu.score_net.named_parameters() if p.grad is not None}
    gpu, _ = _train_model(torch, dev)
    gpu.score_net.load_state_dict(cpu.score_net.state_dict())
    del cpu
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    loss, _ = _microbatch(torch, gpu, batch, draws)
    counts = ops.launch_counts()
    peak_first = torch.cuda.max_memory_allocated(dev)
    key_biases = {f"{name}.NIN_1.b" for name, m in gpu.score_net.named_modules()
                  if type(m).__name__ == "AttnBlockpp"}
    rel, key_bias = _grad_errors(gpu.score_net, grads_cpu, key_biases)
    worst_key = max(rel, key=rel.get)
    # the control: the same microbatch with TF32 on for cuDNN and cuBLAS
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        _microbatch(torch, gpu, batch, draws)
    finally:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    rel_tf32, _ = _grad_errors(gpu.score_net, grads_cpu, key_biases)
    worst_tf32 = max(rel_tf32, key=rel_tf32.get)
    _microbatch(torch, gpu, batch, draws)  # the fp32 gradients for the optimizer step
    loss_err = abs(float(loss) - float(loss_cpu)) / abs(float(loss_cpu))
    t = cfg["train"]
    state = build_train_state(gpu, t["lr"], t["weight_decay"], t["grad_clip"])
    before = {k: p.detach().clone() for k, p in gpu.score_net.named_parameters()}
    state.apply_gradients()
    moved = sum(int(not torch.equal(before[k], p)) for k, p in gpu.score_net.named_parameters())
    finite = all(bool(torch.isfinite(p).all()) for p in gpu.score_net.parameters())
    del before, state
    times = []
    for _ in range(3):
        torch.cuda.reset_peak_memory_stats(dev)
        times.append(_microbatch(torch, gpu, batch, draws)[1])
    peak_remat = torch.cuda.max_memory_allocated(dev)
    net = gpu.score_net
    net.cfg = dataclasses.replace(net.cfg, remat=False)
    gpu.score_net.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    _, no_remat_s = _microbatch(torch, gpu, batch, draws)
    counts_no_remat = ops.launch_counts()
    peak_no_remat = torch.cuda.max_memory_allocated(dev)
    no_remat_s = min(no_remat_s, _microbatch(torch, gpu, batch, draws)[1])
    phase("train_step", experiment=TRAIN_EXPERIMENT, shape=list(TRAIN_SHAPE), dtype="float32",
          tf32=bool(torch.backends.cudnn.allow_tf32), remat_policy=net.cfg.remat_policy,
          loss=float(loss), loss_cpu=float(loss_cpu), loss_rel_err=loss_err,
          grad_tol=TRAIN_GRAD_REL_TOL, max_grad_rel_err=rel[worst_key], worst_grad=worst_key,
          median_grad_rel_err=float(np.median(list(rel.values()))), grads_checked=len(rel),
          grads_under_milli_of_top=_small_grads(grads_cpu, rel, 1e-3),
          key_bias_grads_over_top=key_bias, key_bias_floor=KEY_BIAS_GRAD_FLOOR,
          control="TF32 on", control_max_grad_rel_err=rel_tf32[worst_tf32],
          control_worst_grad=worst_tf32,
          control_median_grad_rel_err=float(np.median(list(rel_tf32.values()))),
          cpu_seconds=round(cpu_s, 2),
          params_moved=moved, params=len(list(net.parameters())), finite=finite,
          launches=counts, launches_no_remat=counts_no_remat,
          microbatch_s=float(np.median(times)), microbatch_s_no_remat=no_remat_s,
          peak_memory_bytes=peak_remat, peak_memory_bytes_first=peak_first,
          peak_memory_bytes_no_remat=peak_no_remat)
    if not (torch.isfinite(loss) and loss_err <= 1e-4):
        raise AssertionError(f"train_step: loss {float(loss)} vs CPU {float(loss_cpu)}")
    if not rel[worst_key] <= TRAIN_GRAD_REL_TOL:
        raise AssertionError(f"train_step: gradient {worst_key} off by {rel[worst_key]} of its "
                             f"largest value (tol {TRAIN_GRAD_REL_TOL})")
    if not max(max(v) for v in key_bias.values()) <= KEY_BIAS_GRAD_FLOOR:
        raise AssertionError(f"train_step: attention key-bias gradients {key_bias}")
    if not rel_tf32[worst_tf32] > TRAIN_GRAD_REL_TOL:
        raise AssertionError(f"train_step: the TF32 control passes ({rel_tf32[worst_tf32]} <= "
                             f"{TRAIN_GRAD_REL_TOL})")
    if counts != TRAIN_LAUNCHES["remat"] or counts_no_remat != TRAIN_LAUNCHES["no_remat"]:
        raise AssertionError(f"train_step: launches {counts} / {counts_no_remat}, expected "
                             f"{TRAIN_LAUNCHES}")
    if not finite or moved < len(list(net.parameters())) - 1:  # all but the frozen W
        raise AssertionError(f"train_step: the optimizer step left {moved} parameters moved, "
                             f"finite {finite}")
    del gpu, net, grads_cpu
    torch.cuda.empty_cache()


def write_corpus(root, n, secs, sr=24000):
    """n synth_speech clips of `secs` seconds and their jsonl list; -> its path."""
    from use_tpu_torch.data.audio_io import write_wav
    from use_tpu_torch.data.synth_speech import synth_pair

    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "corpus.jsonl")
    with open(path, "w") as f:
        for i in range(n):
            clean, _ = synth_pair(int(secs * sr), i, snr_db=20.0, sr=sr)
            wav = os.path.join(root, f"clip{i}.wav")
            write_wav(wav, clean.astype(np.float32), sr)
            f.write(json.dumps({"file_path": wav, "duration": float(secs),
                                "sample_rate": sr}) + "\n")
    return path


@contextlib.contextmanager
def train_steps_timed(torch, dev, task="sgmse", profile_step=True):
    """Each optimizer step of the loop (engine.loop.<task>_train_step) timed
    to a synchronize, its microbatches counted and the loader's time before
    it, the second one profiled where profile_step (kernel time over its
    wall time: the busy share); the eval steps (validation, test-after-fit)
    counted and timed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from use_tpu_torch.engine import loop, train

    step_name, eval_name = f"{task}_train_step", f"{task}_eval_step"
    rec = {"step_s": [], "microbatches": [], "wait_s": [], "eval_steps": 0, "eval_s": [],
           "profiled": None}
    real_step, real_eval = getattr(loop, step_name), getattr(loop, eval_name)
    last = [time.perf_counter()]

    def step(model, state, micro, *args, **kw):
        torch.cuda.synchronize(dev)
        rec["wait_s"].append(time.perf_counter() - last[0])  # the loader's, since the last step
        prof = None
        if profile_step and len(rec["step_s"]) == 1 and rec["profiled"] is None:
            prof = profile(activities=[ProfilerActivity.CUDA])  # kernels only: a light trace
            prof.__enter__()
        t0 = time.perf_counter()
        out = real_step(model, state, micro, *args, **kw)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        if prof is not None:
            prof.__exit__(None, None, None)
            events = prof.key_averages()
            key = ("self_device_time_total" if hasattr(events[0], "self_device_time_total")
                   else "self_cuda_time_total")
            kernel_s = sum(getattr(e, key) for e in events
                           if e.device_type == DeviceType.CUDA) / 1e6
            rec["profiled"] = {"wall_s": wall, "kernel_s": kernel_s, "busy_share": kernel_s / wall}
        else:
            rec["step_s"].append(wall)
            rec["microbatches"].append(len(micro))
        last[0] = time.perf_counter()
        return out

    def eval_step(*args, **kw):
        rec["eval_steps"] += 1
        t0 = time.perf_counter()
        out = real_eval(*args, **kw)
        torch.cuda.synchronize(dev)
        rec["eval_s"].append(time.perf_counter() - t0)
        return out

    setattr(loop, step_name, step)
    setattr(loop, eval_name, eval_step)
    setattr(train, eval_name, eval_step)
    try:
        yield rec
    finally:
        setattr(loop, step_name, real_step)
        setattr(loop, eval_name, real_eval)
        setattr(train, eval_name, real_eval)


def train_phase(torch, dev):
    """`train experiment=SGMSE_Large` through the CLI, one epoch over
    TRAIN_CLIPS synth_speech clips of TRAIN_CLIP_S seconds (the recipe's
    data pipeline and workers, batch 2 x accumulation 4, fp32, remat): a
    finite loss, checkpoints and optimized_metric.json; every kernel
    launched exactly TRAIN_LAUNCHES["remat"] times a training microbatch
    plus PER_FORWARD["float32"] times an eval batch. Then `predict
    experiment=SGMSE_Large ckpt_path=<out_dir>/checkpoints infer.N=3` on
    one 3 s clip, with PER_FORWARD launches a forward. -> the train run's
    launches by kernel."""
    from use_tpu_torch import ops
    from use_tpu_torch.cli.main import main as cli_main
    from use_tpu_torch.config.config import load_config

    sr = 24000
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        t0 = time.perf_counter()
        jl = write_corpus(os.path.join(tmp, "corpus"), TRAIN_CLIPS, TRAIN_CLIP_S, sr)
        corpus_s = time.perf_counter() - t0
        out = os.path.join(tmp, "run")
        torch.cuda.synchronize(dev)
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with train_steps_timed(torch, dev) as rec:
            summary = cli_main(["train", f"experiment={TRAIN_EXPERIMENT}",
                                f"data.clean_json_path={jl}", f"data.noise_json_path={jl}",
                                "data.reverb_use_FRA=true", "train.max_epochs=1",
                                f"out_dir={out}", f"device={dev}"])
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        with open(os.path.join(out, "optimized_metric.json")) as f:
            record = json.load(f)
        steps = sorted(os.listdir(os.path.join(out, "checkpoints")))
        micro = summary["microbatches"]
        step_s = rec["step_s"] + ([rec["profiled"]["wall_s"]] if rec["profiled"] else [])
        want = {k: v * micro + PER_FORWARD["float32"][k] * rec["eval_steps"]
                for k, v in TRAIN_LAUNCHES["remat"].items()}
        timed_micro = sum(rec["microbatches"])
        phase("train", experiment=TRAIN_EXPERIMENT, clips=TRAIN_CLIPS, clip_s=TRAIN_CLIP_S,
              corpus_seconds=round(corpus_s, 2), tf32=bool(torch.backends.cudnn.allow_tf32),
              optimizer_steps=summary["optimizer_steps"], microbatches=micro,
              trained_clips=summary["clips"], eval_batches=rec["eval_steps"],
              history=summary["history"], optimized_metric=record, checkpoints=steps,
              fit_seconds=summary["fit_seconds"], wall_seconds=wall, step_seconds=step_s,
              loader_wait_seconds=rec["wait_s"],
              s_per_optimizer_step=float(np.mean(rec["step_s"])) if rec["step_s"] else None,
              s_per_microbatch=sum(rec["step_s"]) / timed_micro if timed_micro else None,
              trained_audio_s_per_s=(timed_micro * TRAIN_SHAPE[0] * CROP_S / sum(rec["step_s"])
                                     if rec["step_s"] else None),
              profiled_step=rec["profiled"], peak_memory_bytes=peak, launches=counts,
              expected_launches=want)
        losses = [h["train/loss_Score"] for h in summary["history"]]
        if not (losses and all(np.isfinite(losses)) and np.isfinite(record["value"])):
            raise AssertionError(f"train: losses {losses}, optimized metric {record}")
        tcfg = load_config(TRAIN_EXPERIMENT)
        per_step = tcfg["data"]["batch_size"] * tcfg["train"]["accumulate_grad_batches"]
        if summary["optimizer_steps"] != TRAIN_CLIPS // per_step or not steps:
            raise AssertionError(f"train: {summary['optimizer_steps']} steps, checkpoints {steps}")
        if counts != want:
            raise AssertionError(f"train: launches {counts}, expected {want}")

        src, dst = os.path.join(tmp, "in"), os.path.join(tmp, "out")
        lengths = write_clips(src, (3,), sr)
        ops.reset_launch_counts()
        summary = cli_main(["predict", f"experiment={TRAIN_EXPERIMENT}",
                            f"ckpt_path={os.path.join(out, 'checkpoints')}",
                            f"infer.N={TRAIN_PREDICT_N}", f"predict.data_folder={src}",
                            f"predict.target_folder={dst}", f"device={dev}"])
        torch.cuda.synchronize(dev)
        pcounts = ops.launch_counts()
        check_outputs(dst, lengths, sr, summary)
    pwant = {k: v * TRAIN_PREDICT_N for k, v in PER_FORWARD["float32"].items()}
    phase("predict", run="trained checkpoint", experiment=TRAIN_EXPERIMENT,
          N=TRAIN_PREDICT_N, files=summary["files"], audio_seconds=summary["audio_seconds"],
          sampling_seconds=summary["seconds"], launches=pcounts)
    if pcounts != pwant:
        raise AssertionError(f"predict of the trained checkpoint: launches {pcounts}, "
                             f"expected {pwant}")
    torch.cuda.empty_cache()
    return counts


def learn_phase(torch, dev):
    """use_tpu's learning gate on the card (tests/test_learning.py::
    test_sgmse_learns_to_enhance) as it runs it: one run at its seed 0
    (tools/learn_gate.py) with deterministic algorithms, as XLA's CPU run is
    one fixed trajectory; the loss must fall and the mean SI-SDR gain of two
    held-out probes over their noisy input must exceed learn_gate.GATE_DB."""
    from use_tpu_torch.tools import learn_gate

    learn_gate.deterministic(torch, True)
    try:
        run = learn_gate.learn_run(torch, dev)
    finally:
        learn_gate.deterministic(torch, False)
    phase("learn", **run, deterministic=True, gate_db=learn_gate.GATE_DB,
          use_tpu_cpu_gain_db=JAX_LEARN_GAIN_DB)
    if not run["loss_last_epoch"] < run["loss_first_epoch"]:
        raise AssertionError(f"learn: the loss did not fall: {run}")
    if not run["gain_db"] > learn_gate.GATE_DB:
        raise AssertionError(f"learn: gain {run['gain_db']} dB <= {learn_gate.GATE_DB} dB")


def profile_train_phase(torch, dev):
    """One profiled full-width training microbatch of the recipe (remat
    conv_outs): kernel time by name in the forward (train_loss) and in the
    backward (recomputation included), and the share of the backward that
    the GroupNorm (statistics and apply) and K2 backwards take, from
    profiler ranges around the Functions' backwards; then the unprofiled
    microbatch's seconds with TF32 off and on."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from use_tpu_torch.ops import fused_skip, gn_stats

    model, _ = _train_model(torch, dev)
    batch, draws = _train_batch(torch, model)
    _microbatch(torch, model, batch, draws)  # warm
    fns = {"gn_apply_backward": gn_stats._GNApply, "channel_sums_backward": gn_stats._ChannelSums,
           "fused_skip_add_backward": fused_skip._FusedSkipAdd}
    real = {k: f.backward for k, f in fns.items()}

    def ranged(name, fn):
        def backward(ctx, *grads):
            with record_function(name):
                return fn(ctx, *grads)
        return staticmethod(backward)

    for k, f in fns.items():
        f.backward = ranged(k, real[k])
    dv = torch.device(dev)
    try:
        model.score_net.zero_grad(set_to_none=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as pf:
            loss = model.train_loss({k: v.to(dv) for k, v in batch.items()},
                                    draws=(draws[0], draws[1].to(dv), draws[2].to(dv)))
            torch.cuda.synchronize(dv)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as pb:
            loss.backward()
            torch.cuda.synchronize(dv)
    finally:
        for k, f in fns.items():
            f.backward = staticmethod(real[k])
    out = {}
    for part, prof in (("forward", pf), ("backward", pb)):
        events = prof.key_averages()
        key = "device_time_total" if hasattr(events[0], "device_time_total") else "cuda_time_total"
        kernels = {e.key: getattr(e, "self_" + key) / 1e3 for e in events
                   if e.device_type == DeviceType.CUDA}
        total = sum(kernels.values())
        if not total > 0:
            raise AssertionError(f"profile_train: the profiler recorded no kernel in the {part}")
        ranges = {e.key: getattr(e, key) / 1e3 for e in events if e.key in fns}
        top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:15])
        out[part] = dict(kernel_ms=total, ranges_ms=ranges,
                         range_shares={k: v / total for k, v in ranges.items()}, top_kernels_ms=top)
        print(events.table(sort_by="self_" + key, row_limit=25))
    # TF32 for training, an open question: the same microbatch, unprofiled,
    # TF32 off (as the CLI sets it) and on, in turns (median of 3 each)
    times = {False: [], True: []}
    for tf32 in (False, True, True, False, False, True):
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
        times[tf32].append(_microbatch(torch, model, batch, draws)[1])
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    phase("profile_train", shape=list(TRAIN_SHAPE), dtype="float32", remat_policy="conv_outs",
          microbatch_s_tf32_off=float(np.median(times[False])),
          microbatch_s_tf32_on=float(np.median(times[True])), **out)


# -- LSGAN training and eval (phases 13-16) -----------------------------------

def gan_phases(torch, dev):
    """Phases 13-16; -> {run label: launches by kernel} of train_lsgan and
    the evals."""
    timed("gan_train_step", gan_train_step_phase, torch, dev)
    runs = timed("train_lsgan", train_lsgan_phase, torch, dev)
    runs[f"eval {EVAL_SGMSE}"] = timed(f"eval {EVAL_SGMSE}", eval_phase, torch, dev, EVAL_SGMSE,
                                       None, PER_FORWARD["float32"])
    timed("learn_lsgan", learn_lsgan_phase, torch, dev)
    return runs


def _gan_model(torch, device, remat=True):
    """The LSGAN recipe as the CLI builds it (the `ncsnpp` generator, fp32,
    remat conv_outs; the 24k_MVD bank; the shipped criterion) on `device`,
    the generator's weights seeded unit-scale random, D's seeded as Flax's."""
    from use_tpu_torch.cli.main import _build_model
    from use_tpu_torch.config.config import load_config

    cfg = load_config(GAN_EXPERIMENT)
    gan = _build_model(cfg, "cpu")
    net = gan.generator.net
    net.cfg = dataclasses.replace(net.cfg, remat=remat)
    _randomize(torch, net, seed=1)
    return _gan_to(torch, gan, device), cfg


def _gan_to(torch, gan, device):
    gan.generator.net.to(device)
    gan.generator.device = torch.device(device)
    gan.discriminator.to(device)
    return gan


def _gan_batch(torch, gan, seed=5):
    """One microbatch of two clips a little longer than the crop, and its
    crop start from a CPU generator."""
    length = gan.generator.target_len + 4000
    rng = np.random.default_rng(seed)
    clean = (0.3 * rng.standard_normal((GAN_TRAIN_SHAPE[0], length))).astype(np.float32)
    noisy = (clean + 0.1 * rng.standard_normal(clean.shape)).astype(np.float32)
    batch = {"clean": torch.from_numpy(clean), "perturbed": torch.from_numpy(noisy)}
    return batch, gan.generator.draw_start(length, torch.Generator().manual_seed(seed))


def _gan_microbatch(torch, gan, batch, start):
    """The D phase and the G phase of one microbatch, as gan_train_step runs
    them, but both against the same D (no optimizer step between: a first
    Adam step is lr sign(g), which would carry rounding-level gradients into
    the G phase as whole steps); -> (loss_D, logs of the G phase, seconds)
    after a synchronize, the gradients left in .grad."""
    dev = gan.device
    mb = {k: v.to(dev) for k, v in batch.items()}
    gan.discriminator.zero_grad(set_to_none=True)
    gan.generator.net.zero_grad(set_to_none=True)
    t0 = time.perf_counter()
    with torch.no_grad():
        fake = gan.g_forward(mb, start=start)
    loss_d = gan.d_loss(fake)
    loss_d.backward()
    d_params = list(gan.discriminator.parameters())
    for p in d_params:
        p.requires_grad_(False)
    try:
        loss_g, logs = gan.g_loss(gan.g_forward(mb, start=start))
        loss_g.backward()
    finally:
        for p in d_params:
            p.requires_grad_(True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return loss_d.detach(), {k: float(v.detach()) for k, v in logs.items()}, time.perf_counter() - t0


def _gan_grads(gan):
    return {**{f"D.{k}": p.grad for k, p in gan.discriminator.named_parameters()
               if p.grad is not None},
            **{f"G.{k}": p.grad for k, p in gan.generator.net.named_parameters()
               if p.grad is not None}}


@contextlib.contextmanager
def lrelu_branches(torch, replay=None):
    """Each leaky ReLU of the discriminator, in call order: record its branch
    (x > 0) as a CPU mask, or, given `replay`, take the recorded branch in
    place of its own (the CPU then computes the function on the card's
    side of every kink; its own branch is counted where it differs).
    -> {"masks", "flips", "elements"}."""
    from use_tpu_torch.models.gan import discriminators as disc

    real = disc._lrelu
    rec = {"masks": [], "flips": 0, "elements": 0}
    branches = None if replay is None else iter(replay)

    def lrelu(x):
        if branches is None:
            rec["masks"].append((x > 0).cpu())
            return real(x)
        mask = next(branches).to(x.device)
        rec["flips"] += int((mask != (x > 0)).sum())
        rec["elements"] += mask.numel()
        return torch.where(mask, x, x * disc.LRELU_SLOPE)

    disc._lrelu = lrelu
    try:
        yield rec
    finally:
        disc._lrelu = real


def _gan_grad_errors(got, want, key_biases):
    """As _grad_errors, over D's and G's gradients (names prefixed D. / G.)."""
    top = max(float(g.abs().max()) for g in want.values())
    if set(got) != set(want):
        raise AssertionError(f"gan_train_step: gradients on one device only: "
                             f"{sorted(set(got) ^ set(want))[:5]}")
    rel, key_bias = {}, {}
    for k, g in got.items():
        g = g.cpu()
        if k in key_biases:
            key_bias[k] = [float(g.abs().max()) / top, float(want[k].abs().max()) / top]
        else:
            rel[k] = float((g - want[k]).abs().max()) / float(want[k].abs().max())
    return rel, key_bias


def kernel_busy(prof, wall_s):
    """-> (kernel seconds summed, seconds the card ran any kernel, that
    union over `wall_s`): the union of the kernels' intervals, since
    kernels of other streams may overlap."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    total = union = 0.0
    lo = hi = None
    for a, b in spans:
        total += b - a
        if hi is None or a > hi:
            union += 0.0 if hi is None else hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    union += 0.0 if hi is None else hi - lo
    return total / 1e6, union / 1e6, union / 1e6 / wall_s


def _gan_step_launches(torch, gan, state, batch, start):
    """One gan_train_step over the one microbatch: -> (launches, seconds)."""
    from use_tpu_torch import ops
    from use_tpu_torch.engine.train import gan_train_step

    dev = gan.device
    micro = [{k: v.to(dev) for k, v in batch.items()}]
    torch.cuda.synchronize(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = gan_train_step(gan, state, micro, starts=[start])
    torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    if not all(math.isfinite(float(v)) for v in out.values()):
        raise AssertionError(f"gan_train_step: non-finite losses {out}")
    return ops.launch_counts(), seconds


def _cpu_grads(gan):
    return {k: g.detach().cpu().clone() for k, g in _gan_grads(gan).items()}


def gan_train_step_phase(torch, dev):
    """One full-width LSGAN microbatch (phase 13): the D phase and the G
    phase (against the same D) on the card (kernels) and on the CPU (plain
    versions), on the same weights, batch and crop start, the CPU on the
    card's branch of every leaky ReLU of D (lrelu_branches: a pre-activation
    within rounding of 0 takes either branch, and its gradient jumps by
    0.9 of its term; the flips are counted): loss_D and every loss_G*
    within 1e-4 relative (the log terms 1e-3, as tests/test_torch_gan_train.py
    argues), every D and G gradient within TRAIN_GRAD_REL_TOL of its own
    tensor's largest value (the attention's key biases below
    KEY_BIAS_GRAD_FLOOR of the largest of all), the same microbatch with
    TF32 on off by more; then gan_train_step (both Adam steps): finite,
    moved weights, launches exactly GAN_TRAIN_LAUNCHES with remat (median
    time of 3, and one profiled: the share of its wall time the card ran a
    kernel) and without, and peak device memory."""
    from use_tpu_torch.engine.loop import build_gan_train_state

    cpu, cfg = _gan_model(torch, "cpu")
    batch, start = _gan_batch(torch, cpu)
    gan = _gan_to(torch, copy.deepcopy(cpu), dev)
    key_biases = {f"G.{name}.NIN_1.b" for name, m in gan.generator.net.named_modules()
                  if type(m).__name__ == "AttnBlockpp"}
    torch.cuda.reset_peak_memory_stats(dev)
    with lrelu_branches(torch) as card:
        loss_d, logs, first_s = _gan_microbatch(torch, gan, batch, start)
    grads = _cpu_grads(gan)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with lrelu_branches(torch, card["masks"]):
            _gan_microbatch(torch, gan, batch, start)
    finally:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    grads_tf32 = _cpu_grads(gan)
    with lrelu_branches(torch, card["masks"]) as branches:
        loss_d_cpu, logs_cpu, cpu_s = _gan_microbatch(torch, cpu, batch, start)
    grads_cpu = _cpu_grads(cpu)
    del cpu, card
    rel, key_bias = _gan_grad_errors(grads, grads_cpu, key_biases)
    worst = max(rel, key=rel.get)
    worst_g = max((k for k in rel if k.startswith("G.")), key=rel.get)
    loss_errs = {"loss_D": abs(float(loss_d) - float(loss_d_cpu)) / abs(float(loss_d_cpu)),
                 **{k: abs(v - logs_cpu[k]) / max(abs(logs_cpu[k]), 1e-30)
                    for k, v in logs.items()}}
    rel_tf32, _ = _gan_grad_errors(grads_tf32, grads_cpu, key_biases)
    worst_tf32 = max(rel_tf32, key=rel_tf32.get)
    del grads, grads_tf32, grads_cpu

    t = cfg["train"]
    state = build_gan_train_state(gan, t["g_lr"], t["d_lr"], t["weight_decay"])
    before = {k: p.detach().clone() for k, p in gan.generator.net.named_parameters()}
    before_d = {k: p.detach().clone() for k, p in gan.discriminator.named_parameters()}
    torch.cuda.reset_peak_memory_stats(dev)
    counts, step_s = _gan_step_launches(torch, gan, state, batch, start)
    peak_remat = torch.cuda.max_memory_allocated(dev)
    moved = (sum(int(not torch.equal(before[k], p)) for k, p in gan.generator.net.named_parameters()),
             sum(int(not torch.equal(before_d[k], p))
                 for k, p in gan.discriminator.named_parameters()))
    finite = all(bool(torch.isfinite(p).all()) for p in list(gan.generator.net.parameters())
                 + list(gan.discriminator.parameters()))
    del before, before_d
    times = [step_s] + [_gan_step_launches(torch, gan, state, batch, start)[1] for _ in range(2)]
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall = _gan_step_launches(torch, gan, state, batch, start)[1]
    kernel_s, busy_s, busy = kernel_busy(prof, wall)
    profiled = {"wall_s": wall, "kernel_s": kernel_s, "kernel_union_s": busy_s, "busy_share": busy}
    net = gan.generator.net
    net.cfg = dataclasses.replace(net.cfg, remat=False)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    counts_no_remat, no_remat_s = _gan_step_launches(torch, gan, state, batch, start)
    peak_no_remat = torch.cuda.max_memory_allocated(dev)
    n_g, n_d = len(list(net.parameters())), len(list(gan.discriminator.parameters()))
    phase("gan_train_step", experiment=GAN_EXPERIMENT, shape=list(GAN_TRAIN_SHAPE),
          clip_samples=int(batch["clean"].shape[-1]), crop_start=start, dtype="float32",
          tf32=bool(torch.backends.cudnn.allow_tf32), remat_policy=net.cfg.remat_policy,
          loss_D=float(loss_d), loss_D_cpu=float(loss_d_cpu), logs=logs, logs_cpu=logs_cpu,
          loss_rel_errs=loss_errs, grad_tol=TRAIN_GRAD_REL_TOL, max_grad_rel_err=rel[worst],
          worst_grad=worst, median_grad_rel_err=float(np.median(list(rel.values()))),
          grads_checked=len(rel), worst_grads=dict(sorted(rel.items(), key=lambda kv: -kv[1])[:8]),
          worst_generator_grad=worst_g, max_generator_grad_rel_err=rel[worst_g],
          lrelu_flips=branches["flips"], lrelu_elements=branches["elements"],
          key_bias_grads_over_top=key_bias, key_bias_floor=KEY_BIAS_GRAD_FLOOR,
          control="TF32 on", control_max_grad_rel_err=rel_tf32[worst_tf32],
          control_worst_grad=worst_tf32,
          control_median_grad_rel_err=float(np.median(list(rel_tf32.values()))),
          cpu_seconds=round(cpu_s, 2), phases_first_s=first_s,
          params_moved={"G": moved[0], "D": moved[1]}, params={"G": n_g, "D": n_d},
          finite=finite, launches=counts, launches_no_remat=counts_no_remat,
          microbatch_s=float(np.median(times)), microbatch_s_all=times,
          microbatch_s_no_remat=no_remat_s, profiled_step=profiled, peak_memory_bytes=peak_remat,
          peak_memory_bytes_no_remat=peak_no_remat)
    failed = []
    for k, e in loss_errs.items():
        tol = 1e-3 if k in ("loss_G", "loss_G_mag_log", "loss_G_mel_log") else 1e-4
        if not e <= tol:
            failed.append(f"{k} card vs CPU off by {e} (tol {tol})")
    if not rel[worst] <= TRAIN_GRAD_REL_TOL:
        failed.append(f"gradient {worst} off by {rel[worst]} of its largest value (tol "
                      f"{TRAIN_GRAD_REL_TOL})")
    if key_bias and not max(max(v) for v in key_bias.values()) <= KEY_BIAS_GRAD_FLOOR:
        failed.append(f"attention key-bias gradients {key_bias}")
    if not rel_tf32[worst_tf32] > TRAIN_GRAD_REL_TOL:
        failed.append(f"the TF32 control passes ({rel_tf32[worst_tf32]} <= {TRAIN_GRAD_REL_TOL})")
    if counts != GAN_TRAIN_LAUNCHES["remat"] or counts_no_remat != GAN_TRAIN_LAUNCHES["no_remat"]:
        failed.append(f"launches {counts} / {counts_no_remat}, expected {GAN_TRAIN_LAUNCHES}")
    if not finite or moved[0] < n_g or moved[1] < n_d:
        failed.append(f"the optimizer steps moved {moved} of {(n_g, n_d)} parameters, "
                      f"finite {finite}")
    if failed:
        raise AssertionError("gan_train_step: " + "; ".join(failed))
    del gan, net, state
    torch.cuda.empty_cache()


@contextlib.contextmanager
def forward_counts():
    """The backbone forwards (NCSNpp.forward calls) of a run."""
    from use_tpu_torch.models.ncsnpp.ncsnpp import NCSNpp

    n = [0]
    real = NCSNpp.forward

    def forward(self, *args, **kw):
        n[0] += 1
        return real(self, *args, **kw)

    NCSNpp.forward = forward
    try:
        yield n
    finally:
        NCSNpp.forward = real


def eval_phase(torch, dev, experiment, ckpt, per_forward, jl=None):
    """The CLI's `eval experiment=<experiment>` (phase 15) on EVAL_CLIPS
    synth_speech clips (test losses of every test batch, then the rich
    harness over EVAL_FILES utterances, SGMSE at N=EVAL_N): finite test
    losses, the rich metrics RICH_KEYS (and pesq_wb where the package
    imports), whether figures were drawn, and each kernel's launches
    exactly per_forward times the backbone forwards, which are the test
    batches plus the harness's (EVAL_N a file for SGMSE, one for LSGAN)."""
    from use_tpu_torch import ops
    from use_tpu_torch.cli.main import main as cli_main

    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as tmp:
        jl = jl or write_corpus(os.path.join(tmp, "corpus"), EVAL_CLIPS, TRAIN_CLIP_S)
        argv = ["eval", f"experiment={experiment}", f"data.clean_json_path={jl}",
                f"data.noise_json_path={jl}", "data.reverb_use_FRA=true",
                f"eval.max_files={EVAL_FILES}", f"infer.N={EVAL_N}",
                f"out_dir={os.path.join(tmp, 'eval')}", f"device={dev}"]
        if ckpt:
            argv.append(f"ckpt_path={ckpt}")
        torch.cuda.synchronize(dev)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with train_steps_timed(torch, dev, "sgmse" if experiment.startswith("SGMSE") else "gan"
                               ) as rec, forward_counts() as forwards:
            summary = cli_main(argv)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
    harness = summary.get("files", 0) * (EVAL_N if experiment.startswith("SGMSE") else 1)
    want_forwards = rec["eval_steps"] + harness
    want = {k: v * forwards[0] for k, v in per_forward.items()}
    try:
        import pesq  # noqa: F401
        keys = RICH_KEYS | {"pesq_wb"}
    except ImportError:
        keys = RICH_KEYS
    phase("eval", experiment=experiment, ckpt=bool(ckpt), test=summary["test"],
          rich=summary["rich"], files=summary.get("files"), figures=summary["figures"],
          figures_drawn=summary["figures"] > 0, test_batches=rec["eval_steps"],
          forwards=forwards[0], expected_forwards=want_forwards, launches=counts,
          test_step_seconds=rec["eval_s"], wall_seconds=wall)
    if not (summary["test"] and all(math.isfinite(v) for v in summary["test"].values())):
        raise AssertionError(f"eval {experiment}: test losses {summary['test']}")
    if set(summary["rich"] or {}) != keys or not all(math.isfinite(v)
                                                      for v in summary["rich"].values()):
        raise AssertionError(f"eval {experiment}: rich metrics {summary['rich']}, want {keys}")
    if forwards[0] != want_forwards or counts != want:
        raise AssertionError(f"eval {experiment}: {forwards[0]} forwards (want {want_forwards}), "
                             f"launches {counts}, expected {want}")
    torch.cuda.empty_cache()
    return counts


def train_lsgan_phase(torch, dev):
    """`train experiment=LSGAN` through the CLI (phase 14), as shipped: micro
    2 x accumulation 16, Adam 5e-4 / 2e-4, fp32, remat, 4 loader workers,
    one epoch over GAN_TRAIN_CLIPS synth_speech clips of TRAIN_CLIP_S
    seconds (two optimizer steps), items spliced to GAN_SPLICE_S; finite losses, a checkpoint holding G
    and D, optimized_metric.json, every kernel launched exactly
    GAN_TRAIN_LAUNCHES["remat"] times a microbatch plus
    PER_GENERATOR_FORWARD times an eval batch. Then `predict
    experiment=LSGAN ckpt_path=<out_dir>/checkpoints` on one 3 s clip
    (PER_GENERATOR_FORWARD launches), and `eval experiment=LSGAN` of that
    checkpoint (eval_phase). -> launches of the train run and the eval."""
    from use_tpu_torch import ops
    from use_tpu_torch.cli.main import main as cli_main
    from use_tpu_torch.config.config import load_config
    from use_tpu_torch.engine.checkpoint import CheckpointManager

    sr = 24000
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gan_") as tmp:
        t0 = time.perf_counter()
        jl = write_corpus(os.path.join(tmp, "corpus"), GAN_TRAIN_CLIPS, TRAIN_CLIP_S, sr)
        corpus_s = time.perf_counter() - t0
        out = os.path.join(tmp, "run")
        torch.cuda.synchronize(dev)
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        # no profiled step: the trace of 16 microbatches takes the profiler
        # minutes to read back; gan_train_step's phase profiles one
        with train_steps_timed(torch, dev, "gan", profile_step=False) as rec:
            summary = cli_main(["train", f"experiment={GAN_EXPERIMENT}",
                                f"data.clean_json_path={jl}", f"data.noise_json_path={jl}",
                                "data.reverb_use_FRA=true", "train.max_epochs=1",
                                f"data.speech_splice_seconds={GAN_SPLICE_S}",
                                f"out_dir={out}", f"device={dev}"])
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        with open(os.path.join(out, "optimized_metric.json")) as f:
            record = json.load(f)
        ckpts = os.path.join(out, "checkpoints")
        steps = sorted(os.listdir(ckpts))
        state = CheckpointManager(ckpts).restore()
        held = {k: sorted(state[k]) for k in state}
        del state
        micro = summary["microbatches"]
        step_s = rec["step_s"] + ([rec["profiled"]["wall_s"]] if rec["profiled"] else [])
        want = {k: v * micro + PER_GENERATOR_FORWARD[k] * rec["eval_steps"]
                for k, v in GAN_TRAIN_LAUNCHES["remat"].items()}
        phase("train_lsgan", experiment=GAN_EXPERIMENT, clips=GAN_TRAIN_CLIPS,
              clip_s=TRAIN_CLIP_S, splice_s=GAN_SPLICE_S, corpus_seconds=round(corpus_s, 2),
              tf32=bool(torch.backends.cudnn.allow_tf32),
              optimizer_steps=summary["optimizer_steps"], microbatches=micro,
              trained_clips=summary["clips"], eval_batches=rec["eval_steps"],
              history=summary["history"], optimized_metric=record, checkpoints=steps,
              checkpoint_holds=held, fit_seconds=summary["fit_seconds"], wall_seconds=wall,
              step_seconds=step_s, loader_wait_seconds=rec["wait_s"],
              eval_step_seconds=rec["eval_s"],
              s_per_optimizer_step=float(np.mean(step_s)) if step_s else None,
              s_per_microbatch=sum(step_s) / micro if step_s else None,
              trained_audio_s_per_s=(micro * GAN_TRAIN_SHAPE[0] * GAN_CROP_S / sum(step_s)
                                     if step_s else None),
              peak_memory_bytes=peak, launches=counts,
              expected_launches=want)
        hist = summary["history"]
        losses = [h[k] for h in hist for k in ("train/loss_G", "train/loss_D")]
        if not (losses and all(np.isfinite(losses)) and np.isfinite(record["value"])):
            raise AssertionError(f"train_lsgan: losses {losses}, optimized metric {record}")
        gcfg = load_config(GAN_EXPERIMENT)
        from use_tpu_torch.cli.main import resolve_auto_batch

        resolve_auto_batch(gcfg)
        per_step = gcfg["data"]["batch_size"] * gcfg["train"]["accumulate_grad_batches"]
        if summary["optimizer_steps"] != GAN_TRAIN_CLIPS // per_step or not steps:
            raise AssertionError(f"train_lsgan: {summary['optimizer_steps']} steps, "
                                 f"checkpoints {steps}")
        if set(held) != {"g", "d"}:
            raise AssertionError(f"train_lsgan: the checkpoint holds {sorted(held)}")
        if counts != want:
            raise AssertionError(f"train_lsgan: launches {counts}, expected {want}")

        src, dst = os.path.join(tmp, "in"), os.path.join(tmp, "out")
        lengths = write_clips(src, (3,), sr)
        ops.reset_launch_counts()
        psum = cli_main(["predict", f"experiment={GAN_EXPERIMENT}", f"ckpt_path={ckpts}",
                         f"predict.data_folder={src}", f"predict.target_folder={dst}",
                         f"device={dev}"])
        torch.cuda.synchronize(dev)
        pcounts = ops.launch_counts()
        check_outputs(dst, lengths, sr, psum)
        phase("predict", run="trained LSGAN checkpoint", experiment=GAN_EXPERIMENT,
              files=psum["files"], audio_seconds=psum["audio_seconds"],
              seconds=psum["seconds"], launches=pcounts)
        if pcounts != PER_GENERATOR_FORWARD:
            raise AssertionError(f"predict of the trained LSGAN: launches {pcounts}, "
                                 f"expected {PER_GENERATOR_FORWARD}")
        eval_counts = timed("eval LSGAN", eval_phase, torch, dev, GAN_EXPERIMENT, ckpts,
                            PER_GENERATOR_FORWARD)
    torch.cuda.empty_cache()
    return {"train_lsgan": counts, "eval LSGAN": eval_counts}


def _gan_learn_worker(det, device):
    """One run of the LSGAN gate in a spawned process, deterministic
    algorithms or not; TF32 off as in the parent."""
    import torch

    import use_tpu_torch.models  # noqa: F401 (registries)
    from use_tpu_torch.tools import learn_gate

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    learn_gate.deterministic(torch, det)
    return {**learn_gate.gan_learn_run(torch, device), "deterministic": det}


def learn_lsgan_phase(torch, dev):
    """use_tpu's LSGAN learning gate on the card (phase 16; tests/
    test_learning.py::test_lsgan_generator_learns_to_enhance), as it runs
    it: seed 0, its probe sizes and rates (tools/learn_gate.py
    gan_learn_run), the LEARN_LSGAN_RUNS runs at once in spawned processes
    on the one card (each is a small net; deterministic algorithms give one
    result whatever runs beside them). Each run's G loss must fall, and the
    median of the mean SI-SDR gains of the held-out probes over their noisy
    input, over the runs without deterministic algorithms, must exceed
    learn_gate.GAN_GATE_DB. One trajectory is one sample: this adversarial
    probe's runs part within three steps between any two of the card's
    algorithm choices and the CPU, and end 6 dB apart (PERF.md)."""
    import multiprocessing

    from use_tpu_torch.tools import learn_gate

    with multiprocessing.get_context("spawn").Pool(len(LEARN_LSGAN_RUNS)) as pool:
        runs = pool.starmap(_gan_learn_worker, [(det, str(dev)) for det in LEARN_LSGAN_RUNS])
    gains = [r["gain_db"] for r in runs]
    median = float(np.median([r["gain_db"] for r in runs if not r["deterministic"]]))
    phase("learn_lsgan", runs=runs, gains_db=gains, median_gain_db=median,
          deterministic_gain_db=[r["gain_db"] for r in runs if r["deterministic"]],
          gate_db=learn_gate.GAN_GATE_DB, use_tpu_cpu_gain_db=JAX_GAN_LEARN_GAIN_DB)
    fell = [r["loss_G_last_epoch"] < r["loss_G_first_epoch"] for r in runs]
    if not all(fell):
        raise AssertionError(f"learn_lsgan: the G loss did not fall: {runs}")
    if not median > learn_gate.GAN_GATE_DB:
        raise AssertionError(f"learn_lsgan: median gain {median} dB <= "
                             f"{learn_gate.GAN_GATE_DB} dB ({gains})")


if __name__ == "__main__":
    sys.exit(main())
