#!/usr/bin/env python3
"""Chip smoke test of use_tpu_torch, the PyTorch / CUDA port, on one GPU.

    python3 chip_smoke.py              # the full check, one card
    python3 chip_smoke.py --kernels    # build + per-kernel phases (and gradients) only
    python3 chip_smoke.py --profile    # also profile one full-width forward and
                                       # one training microbatch
    python3 chip_smoke.py --gan        # build, kernels, then only the LSGAN
                                       # training and eval phases (13-16)
    python3 chip_smoke.py --csmgan     # build, kernels, then only the CSMGAN
                                       # phases (17-21)
    python3 chip_smoke.py --int8conv   # build, kernels, then only phases 22-25
    python3 chip_smoke.py --zoo        # build, kernels, then only the GAN zoo's
                                       # phases (26-28)
    python3 chip_smoke.py --models     # build, kernels, then only the alternative
                                       # backbones' and the legacy family's
                                       # phases (29-31)
    python3 chip_smoke.py --dist       # build, kernels, then only bf16 and
                                       # data-parallel training (phases 32-34)
    python3 chip_smoke.py --tp         # build, kernels, then only tensor-parallel
                                       # training (phase 35)

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
     (`gn_fold`; its library call is torch.var_mean over each group, the
     statistics the fold starts from), and K2 at a ragged shape. K3 (the int8 conv) is timed on
     weights prepared once (`prep_ms` times the preparation), in each of its
     tiles, also checked at a ragged shape, and a control broken on
     purpose (no edge mask) must fail its tolerance; the branch-free
     reciprocal of its SiLU is checked against IEEE 1/d at every float of
     [1, 2^126), the range it is used on. The int8conv path's two kernels,
     K1's apply with its int8 epilogue writing the conv's C32 operand
     (GN_INT8_SHAPES) and the s8 conv (qconv3x3_s8, a TMA + wgmma conv over
     C32, at K3's shapes, each tile, and with a per-sample post-scale), must
     be bit-equal (atol 0) to their plain versions; the apply's division-free
     SiLU is checked against v / (1 + exp(-v)) at every float, and its
     quantize against the IEEE division at every bf16 y for every scale u
     of the int8 nets' GroupNorms (INT8_SEEDS) and at every float y with
     |y| <= 128 u for DIV_CHECK_U32 of them; the convs' rows carry cuDNN's
     device time beside their own (`library_device_ms`);
  4. forward: full-width ncsnpplarge with seeded random weights on
     [8, 512, 192, 4] (the predict path's 8 chunk lanes, one t each), the
     card (kernels) against the CPU (plain versions) on FORWARD_CHECK_LANES,
     TF32 off; and its bf16
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
     [1, 512, 1536, 2] with its exact launches a forward
     (`PER_GENERATOR_FORWARD`) and K2's calls by level, and the card against
     the CPU on its first GAN_CHECK_FRAMES frames;
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
     synth_speech clips (2 optimizer steps of batch 2 x accumulation 4, the
     loader in the main process),
     with seconds per optimizer step and per microbatch, trained audio-s/s,
     peak memory, the losses, one profiled step's device busy share and the
     run's exact launches; then `predict ckpt_path=<out_dir>/checkpoints
     infer.N=3` on one clip serves what was trained;
 12. learn: use_tpu's learning gate (tests/test_learning.py::
     test_sgmse_learns_to_enhance) on the card at its seed 0, one run with
     deterministic algorithms: a tiny score net overfit for 600 steps must
     enhance held-out speech probes by more than 2 dB SI-SDR (run in a
     spawned process beside phase 16's runs, and printed with them);
 13. gan_train_step: one full-width microbatch of the LSGAN recipe (the
     `ncsnpp` generator, fp32, remat conv_outs, net input [2, 512, 480, 2];
     the 24k_MVD bank on 76 640-sample clips): its D phase and G phase on
     the card against the CPU on the same weights, batch and crop start,
     the crop cut to GAN_STEP_CHECK_FRAMES (the losses, and every D and G
     gradient within TRAIN_GRAD_REL_TOL of its own tensor's largest value;
     the same microbatch with TF32 on is a control that must exceed it),
     then gan_train_step with both Adam steps: its exact launches
     (GAN_TRAIN_LAUNCHES, with remat and without), seconds per microbatch
     and peak device memory;
 14. train_lsgan: the CLI's `train experiment=LSGAN` (micro 2, the
     accumulation cut to 4: GAN_TRAIN_ARGS) on GAN_TRAIN_CLIPS synth_speech
     clips, one optimizer step: finite losses, a checkpoint of G and D, optimized_metric.json,
     the run's exact launches (training microbatches, validation and test
     forwards), seconds per optimizer step, trained audio-s/s, the
     loader's wait and peak memory; then `predict experiment=LSGAN
     ckpt_path=<out_dir>/checkpoints` on one clip, and `eval
     experiment=LSGAN` of that checkpoint (phase 15's checks);
 15. eval: `eval experiment=SGMSE_Large infer.N=3 eval.max_files=2` with
     seeded weights on EVAL_CLIPS clips (every eval run's loader in the main
     process): finite test losses, the rich
     metrics (si_sdr, si_sir, si_sar, lsd, estoi; pesq_wb where the `pesq`
     package imports), whether figures were drawn, and exact launches (per
     backbone forward, the forwards being the test batches and the
     sampler's steps);
 16. learn_lsgan: use_tpu's LSGAN learning gate (tests/test_learning.py::
     test_lsgan_generator_learns_to_enhance) at its seed 0, probe sizes and
     rates, six runs at once (one with deterministic algorithms, reported):
     each G loss falls, and the median gain of the enhanced SI-SDR of
     held-out probes over the noisy one, over the five runs without
     deterministic algorithms, must exceed 1 dB;
 17. csmgan_forward: the CSMGAN generator (`experiment=CSMGAN`, full width,
     weights from train.seed) offline on a 6 s clip at batch 1 and 8, the
     card against the CPU within 1e-3 x max|ref| (fp32, TF32 off): ms a
     forward, audio-s/s, peak memory, the CUDA kernels one forward launches
     (profiler) and its arithmetic (flop counter);
 18. csmgan_stream: CSMGANStream on the card at chunk_frames 2, 4 and 8,
     batch 1: per-chunk wall latency p50 / p99 over STREAM_CHUNKS chunks
     after STREAM_WARMUP, the real-time factor, the algorithmic latency
     (chunk + one hop), one profiled chunk (kernels, their time against the
     chunk's wall time); the stream against the card's offline pass of its
     clip and, over its first chunks, the CPU's stream (STREAM_REL_TOL);
 19. predict csmgan: the CLI's `predict experiment=CSMGAN` on the 3 s and 6 s
     clips streaming (chunk_frames 2) and offline: mirrored, length-matched,
     finite outputs; K1, K2 and K3 launched 0 times;
 20. csmgan_train_step: one microbatch of the CSMGAN recipe (4 whole clips
     of 6 s, fp32; the 24k_MVD bank) through the D and G phases on the card
     against the CPU on CHECK_CLIPS of the clips, on the card's leaky-ReLU
     branches (losses, every D and G gradient within TRAIN_GRAD_REL_TOL of
     its tensor's largest; TF32 on is the control that must fail), then
     gan_train_step with both Adam
     steps: seconds a microbatch, peak memory, a profiled step's busy share;
 21. train_csmgan: the CLI's `train experiment=CSMGAN` (micro 4, the
     accumulation cut to 2: CSMGAN_TRAIN_ARGS) for one optimizer step over
     CSMGAN_TRAIN_CLIPS synth_speech clips (6 s
     items), with its validation and test: finite losses, a checkpoint of G
     and D, seconds a step, trained audio-s/s, the loader's wait; then
     `predict ... ckpt_path=<out_dir>/checkpoints predict.streaming=true` on
     one clip and `eval experiment=CSMGAN` of that checkpoint (phase 15's
     checks). CSMGAN serving and training launch none of K1, K2, K3;
 22. int8conv_forward: the int8 network of quant='int8' (full-width
     ncsnpplarge at [8, 512, 192, 4], fp32 and bf16): K1's int8 apply and
     the s8 conv on the card against their plain versions on the card,
     within INT8_REL_TOL of max|plain|, a control with the producer's scale
     u left out of the weights that must exceed it, and each forward's
     launches exactly PER_FORWARD["int8conv_bfloat16"] (K3 none); the
     profiled device ms of the s8 conv's and the int8 apply's kernels a
     forward beside the forward's;
 23. ddpm_forward: ncsnpplarge with DDPM blocks and residual pyramids
     (DDPM_KWARGS), FIR on and off, at DDPM_SHAPE: the card against the
     CPU within 1e-3 x max|ref|, launches exactly PER_DDPM_FORWARD;
 24. predict int8conv_bfloat16: `predict experiment=SGMSE_Large
     model.backbone_kwargs.quant=int8 model.backbone_kwargs.dtype=bfloat16`
     as phase 5 runs it (audio-s/s, peak memory, exact launches);
 25. npz_predict: `predict ckpt_path=<x>.npz` (use_tpu's flat naming of
     scripts/export_use_tpu_params.py, written here by ``flax_flat``, since
     the card's machine has no JAX) against the same weights as a
     state_dict, SGMSE_Large and LSGAN: the same wavs, bit for bit;
 26. gan24k_train_step: phase 13's microbatch (its shapes, weights, batch
     and crop) against the 24k bank (GAN24K_DISCRIMINATOR: MPD, the DWT
     multi-scale bank, the mel bank): the D and G phases on the card
     against the CPU (losses, every D and G gradient within
     TRAIN_GRAD_REL_TOL of its tensor's largest, the leaky ReLUs of the
     period and scale banks replayed; TF32 on the control that must
     fail), then gan_train_step with both Adam steps: launches exactly
     GAN_TRAIN_LAUNCHES["remat"], seconds a microbatch, peak memory;
 27. train_lsgan_24k: the CLI's `train experiment=LSGAN
     model.discriminator=hifigan_vocoder_discriminator_24k` for one
     optimizer step, depth cut to GAN24K_OVERRIDES (micro 2 x
     accumulation 2 on GAN24K_TRAIN_CLIPS clips, loader in the main
     process): phase 14's checks (finite losses, a checkpoint of G and D,
     exact launches), a predict of it and `eval experiment=LSGAN` of it
     with the same bank;
 28. zoo_forward: the zoo's library modules at their default widths, the
     card against the CPU in fp32 (TF32 off) within ZOO_REL_TOL x max|ref|
     of every output, logit and feature map: HifiganGenerator on 80-bin
     mel frames for 6 s of 24 kHz audio with NSF off and on (the CPU on
     the card's draws), BandwidthExtender on a 6 s 8 kHz clip, the
     multi-scale and multi-spec discriminators and the 24k bank on
     ZOO_D_SHAPE, and content_criteria, lsgan_g_loss and lsgan_d_loss on
     the bank's outputs; ms a call, peak memory, K1 / K2 / K3 launches
     (none);
 29. alt_backbones_forward: GaGNet (U^2 encoder, causal, default widths)
     on GAGNET_SHAPE spectra (6 s at n_fft 1022, hop 160) and ConvTasNet
     (default widths, gLN and causal) on TASNET_SHAPE waveforms at 24 kHz,
     the card against the CPU on ALT_CHECK_LANES lanes within ZOO_REL_TOL
     x max|ref| (fp32, TF32 off): ms a call, peak memory, parameters, no
     K1 / K2 / K3 launch;
 30. legacy_models: StochasticRegenerationModel (the LSGAN generator of
     experiment=LSGAN, SGMSE_Large's score model with condition='both',
     sde_input='denoised') on a LEGACY_CLIP_S s clip at N=CHAIN_N, equal to
     the gan+sgmse chain's computation on the same weights and noise
     (LEGACY_CHAIN_TOL), its launches exactly LEGACY_REGEN_LAUNCHES,
     audio-s/s and peak memory; LegacyScoreModel.enhance(timeit=True) (nfe,
     rtf, its x_hat ScoreModel.sample's); DiscriminativeModel (enhance
     NCSNPPWrapper's; train_loss and backward on a crop, the loss against
     the CPU's within LEGACY_LOSS_REL_TOL); one EMA update;
 31. legacy_layers_forward: RefineBlock (two inputs, conditional and not),
     a 'down' ResidualBlock with ConditionalInstanceNorm2dPlus and each norm
     of the zoo at LEGACY_LAYER_SHAPE, the card against the CPU within
     ZOO_REL_TOL x max|ref|;
 32. train_bf16_step: one SGMSE_Large microbatch (TRAIN_SHAPE, remat) and
     one LSGAN microbatch (both phases) with the backbone computing in bf16
     (model.backbone_kwargs.dtype=bfloat16; the weights float32) against
     fp32 on the same weights and draws, for BF16_SEEDS: the loss and every
     gradient's error, the L2 error of all of them within BF16_GRAD_L2_TOL,
     which a control (K2's bf16 backward without its scale) must exceed;
     launches exactly TRAIN_LAUNCHES / GAN_TRAIN_LAUNCHES["remat"]; seconds
     and peak memory of a bf16 microbatch beside fp32's;
 33. train_ddp: `python -m torch.distributed.run --standalone
     --nproc_per_node=<the cards> -m use_tpu_torch.cli.main train
     experiment=SGMSE_Large` (DDP_TRAIN_ARGS, train.async_ckpt=true): exit
     0, the world size and NCCL printed, exact launches, its weights within
     the spread of two runs without torchrun (DDP_WEIGHTS_FLOOR where they
     agree bit for bit); `train experiment=LSGAN` under torchrun with the
     generator in bf16 (DDP_LSGAN_ARGS, train.mesh_idle=warn): exit 0,
     finite losses, exact launches; an asynchronous checkpoint read back
     equals a synchronous one of the same state bit for bit, though the
     state changed right after the save returned;
 34. ddp_two_ranks: two ranks share the card through gloo (NCCL refuses
     two ranks on one GPU), each one sgmse_train_step of SGMSE_Large at
     batch 1 through the engine: the ranks bit-identical, the gradient they
     apply the one-process step's over the 2-clip batch with the same
     global draws (TRAIN_GRAD_REL_TOL), the weights after Adam its; the
     step's and a gloo all-reduce's seconds;
 35. tp_ranks: four ranks share the card through gloo as make_mesh(data=2,
     model=2) (parallel/sharding.py: every kernel weight of use_tpu's rule
     held as its output slice by each model rank, DDP over the data group),
     one sgmse_train_step of SGMSE_Large (full width, remat, fp32, grad_clip
     TP_GRAD_CLIP) on one clip a data rank, the crop cut to TP_FRAMES
     frames, against the one-process unsharded step on the card over both
     clips with the same draws: the loss and every gathered gradient within
     TRAIN_GRAD_REL_TOL of its largest (the attention's key biases below
     KEY_BIAS_GRAD_FLOOR), the gathered weights after Adam as phase 34's;
     replicated parameters bit-identical within each model group, each
     slice across its data group; launches exactly TRAIN_LAUNCHES["remat"]
     on every rank; the same step with a gather whose backward sums over
     the model ranks (torch.distributed.nn's all_gather) must exceed the
     gradient gate. The step's seconds beside the one-process step's, the
     bytes each rank gathered and all-reduced over its model group, each
     rank's peak memory and K2's shapes. Then the same ranks take one
     gan_train_step of the LSGAN recipe (full width, fp32, remat; the 24k_MVD
     bank; the crop cut to TP_GAN_FRAMES) and one of CSMGAN (TP_CSMGAN_S
     clips, the same bank), G and D cut, each after its summing control,
     against the one-process unsharded step on the card over both clips
     with the same starts (`tp_ranks_gan`, one line a task): the one
     process takes the ranks' branch at each leaky ReLU and PReLU and their
     mel spectrograms, and runs its G phase against the D the ranks stepped;
     the losses within 1e-4 (the log terms 1e-3), every gathered G and D
     gradient within TRAIN_GRAD_REL_TOL of its largest (CSMGAN:
     TP_CSMGAN_GRAD_REL_TOL), the weights after both Adam steps as phase
     34's (gradients above ADAM_SURE_FLOOR), replicas and slices
     bit-identical (digests), launches exactly GAN_TRAIN_LAUNCHES["remat"]
     (CSMGAN none) on every rank and in the one process, the control over
     the gate. Then the same ranks serve int8 cut over the model axis
     (`tp_ranks_int8`): the full-width bf16 ncsnpplarge under
     quant='int8_pallas' (K3) and quant='int8' (the s8 conv), each rank's
     int8 convs run on its output channels with its slice of the bias in
     the kernel's epilogue, on one lane of TP_INT8_SHAPE a data rank: each
     cut int8 conv's gathered output bit-equal to the uncut conv's on the
     same arguments, and the control (the bias added after the gather in
     bf16) not, on K3's convs (the s8 conv's epilogue adds the bias in bf16
     after its rounding, so there the two agree); the forward within
     BF16_REL_TOL of the uncut forward's largest |value|; the launches of
     the cut and the uncut forward PER_FORWARD's int8 ones on every rank;
     HiFi-GAN's generator (fp32, its transposed convs cut on their output
     axis) within ZOO_REL_TOL of its uncut forward. The kernel phases time
     K3 and the s8 conv at a rank's shapes (TP_QCONV_SHAPES, rows tagged
     tp-int8).
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
    # tensor-parallel training (phase 35), one clip a rank at TP_FRAMES: the
    # up block into level 1 (256 -> 256, Conv_2 sharded), this rank's output
    # channels at model 2 (Co 128) and at model 4 (Co 64: half a channel tile)
    (1, 256, 128, 256, 64),
    (1, 256, 64, 256, 64),
    # the LSGAN generator in phase 35 at TP_GAN_FRAMES, one clip a rank
    # (Conv_2 256 -> 256 and 512 -> 256 sharded): Co 128 at model 2, and the
    # up path at model 4 (Co 64)
    (1, 256, 128, 512, 128),  # full resolution
    (1, 512, 128, 256, 64),  # up path, level 1
    (1, 512, 64, 256, 64),
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
# int8 serving cut over the model axis (phase 35), one lane a rank at
# TP_INT8_FRAMES: a rank's output channels at model 2, O 64 of 128 at full
# resolution and O 128 of 256 at 128 x 16 (rows tagged tp-int8)
TP_QCONV_SHAPES = [(1, 128, 64, 512, 64), (1, 256, 128, 128, 16)]
FORWARD_BACKBONE, FORWARD_SHAPE = "ncsnpplarge", (8, 512, 192, 4)  # the 8 lanes of a 6 s clip
# the lanes of that forward the CPU computes too, the first and the last t
# (the net takes each lane alone; the CPU's forward of all 8 was most of
# that phase's time)
FORWARD_CHECK_LANES = (0, 7)
BF16_SEEDS = (1, 2, 3)
# bf16 forward against fp32, relative to max|fp32|: between the readings on
# BF16_SEEDS (<= 0.013) and the broken control's (0.023) on the H100 (PERF.md)
BF16_REL_TOL = 0.017
INT8_SEEDS = (1, 2)
KERNEL_REPS = 50  # single-call timings a median of K1's and K2's times takes
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
# the frames of the generator's input that the card and the CPU both compute
# (a 5 s clip: the CPU's forward of the 10 s clip was most of that phase's time)
GAN_CHECK_FRAMES = 768
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
# clips of the microbatch that the card and the CPU both compute (phases 10,
# 13, 20 and 26: the CPU's is most of those phases' time); the timings run
# the recipe's TRAIN_SHAPE[0] / GAN_TRAIN_SHAPE[0] / CSMGAN's batch
CHECK_CLIPS = 1
# the crop of phase 10's card-vs-CPU microbatch (the recipe's 512 frames stay
# for the timings): the CPU's full-width step sets that phase's time
TRAIN_CHECK_FRAMES = 256
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
TRAIN_CLIPS, TRAIN_CLIP_S = 16, 4  # 16 clips: 2 optimizer steps of 2 x 4 an epoch
# the loader of the SGMSE train run and of every eval run, in the main
# process: on their few clips, spawning the recipes' 4 workers a pass took
# most of those phases' time (PERF.md); train_lsgan and
# train_csmgan keep the recipes' spawned workers
IN_PROCESS_LOADER = "data.num_workers=0"
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
# one optimizer step of the recipe's micro 2, its accumulation cut from 16
# to 4 (the default run outgrew 1,200 s on a slow host)
# the card-vs-CPU microbatch of phases 13 and 26 crops the generator's
# input to this many frames (the recipe's 480 stay for the timings): the
# CPU's full-width step sets those phases' time
GAN_STEP_CHECK_FRAMES = 128
GAN_TRAIN_CLIPS = 8
GAN_TRAIN_ARGS = ("train.accumulate_grad_batches=4",)
# the items of train_lsgan spliced to 3.5 s (the recipe's 6 s): still longer
# than the 3.19 s crop, and the loaders' synthesis of the 32 training, 32
# validation and 32 test items, most of that phase's time, shrinks with them
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
# CSMGAN (phases 17-21)
CSMGAN_EXPERIMENT = "CSMGAN"
CSMGAN_CLIP_S = 6  # the forward's clip and the training clips: the recipe's 6 s items
CSMGAN_BATCHES = (1, 8)
# card against the CPU (and the stream against the offline pass), relative
# to max|ref|: the forwards' limit. The cumulative norms divide by
# sqrt(var + eps) with eps 1e-6 (2-D) and 1e-8 (1-D), so at a frame of
# almost no variance a difference of summation order grows by up to 1e3 /
# 1e4; the network's biases and the cumulative sums over earlier frames
# keep its inputs' variance far from 0 (PERF.md: readings)
CSMGAN_REL_TOL = 1e-3
STREAM_CHUNK_FRAMES = (2, 4, 8)
STREAM_REL_TOL = 1e-3
STREAM_WARMUP, STREAM_CHUNKS = 5, 100  # chunks before the latency count, and counted
STREAM_CPU_CHUNKS = 20  # the first chunks of a stream the CPU streams too
# one optimizer step of the recipe's micro 4, its accumulation cut from 8 to 2
CSMGAN_TRAIN_CLIPS = 8
CSMGAN_TRAIN_ARGS = ("train.accumulate_grad_batches=2", IN_PROCESS_LOADER)
NO_LAUNCHES = {"channel_sums": 0, "gn_apply": 0, "fused_skip_add": 0, "qconv3x3_fused": 0}
# every kernel wrapper (use_tpu_torch.ops.KERNEL_WRAPPERS); a launch table
# leaves out the kernels a path launches no time (``launches`` fills them in)
KERNELS = ("channel_sums", "gn_apply", "fused_skip_add", "qconv3x3_fused", "gn_apply_int8",
           "qconv3x3_s8")

# kernel launches per ncsnpplarge forward on each predict run; int8conv
# (quant='int8'): the 86 GroupNorms before a quantized conv take the
# statistics with the fold (a channel_sums launch) and the int8 apply, the
# 12 before a resampling block's quantized Conv_0 and the 8 others the
# plain apply; 98 s8 convs (every residual block's two), K3 none.
# Counted on the CPU by tests/test_torch_int8conv.py::
# test_int8conv_launch_constants_of_chip_smoke
PER_FORWARD = {
    "float32": {"channel_sums": 106, "gn_apply": 106, "fused_skip_add": 34, "qconv3x3_fused": 0},
    "int8_bfloat16": {"channel_sums": 106, "gn_apply": 20, "fused_skip_add": 34,
                      "qconv3x3_fused": 86},
    "int8conv_bfloat16": {"channel_sums": 106, "gn_apply": 20, "fused_skip_add": 34,
                          "qconv3x3_fused": 0, "gn_apply_int8": 86, "qconv3x3_s8": 98},
}
INT8CONV_PREDICT_ARGS = ("model.backbone_kwargs.quant=int8",
                         "model.backbone_kwargs.dtype=bfloat16")
# the int8 apply's shapes on the int8conv forward at 8 lanes: full
# resolution (128 channels, and 256 after the up path's skip concat), a low
# level and the lowest (B, C, H, W)
GN_INT8_SHAPES = [(8, 128, 512, 192), (8, 256, 512, 192), (8, 256, 32, 12), (8, 256, 8, 3)]
# scales u of the int8 apply's quantize checked at every float y with |y| <=
# 128 u (every bf16 y is checked for all of the nets' u): this many of the
# int8 nets' scales, evenly spaced in rank, and powers of two and their
# float predecessors around them (DIV_CHECK_EDGES)
DIV_CHECK_U32 = 16
DIV_CHECK_EDGES = (2.0 ** -5, 2.0 ** -4, 2.0 ** -3)
# the DDPM / residual-pyramid ncsnpplarge (resblock_type='ddpm',
# progressive='residual', progressive_input='residual'): card against CPU at
# batch 1; its 77 GroupNorms a forward, no shortcut kernel (the DDPM blocks'
# shortcuts are NINs), counted by tests/test_torch_ncsnpp_variants.py
DDPM_KWARGS = {"resblock_type": "ddpm", "progressive": "residual",
               "progressive_input": "residual"}
DDPM_SHAPE = (1, 512, 192, 4)
PER_DDPM_FORWARD = {"channel_sums": 77, "gn_apply": 77}
# predict ckpt_path=<x>.npz against the same weights as a state_dict
NPZ_EXPERIMENTS = ("SGMSE_Large", "LSGAN")
NPZ_N, NPZ_CLIPS_S = 2, (3,)
# the GAN zoo (phases 26-28): the LSGAN recipe with the MPD + MSD + MMD
# bank (gan24k_train_step on phase 13's shapes; train_lsgan_24k one
# optimizer step, depth cut to micro 2 x accumulation 2 on 4 clips, the
# loader in the main process), then the zoo's modules card against CPU
GAN24K_DISCRIMINATOR = "hifigan_vocoder_discriminator_24k"
GAN24K_TRAIN_CLIPS = 4
GAN24K_OVERRIDES = (f"model.discriminator={GAN24K_DISCRIMINATOR}", "data.batch_size=2",
                    "train.accumulate_grad_batches=2", IN_PROCESS_LOADER)
ZOO_CLIP_S = 6  # the generators' output: 6 s at 24 kHz
ZOO_MELS, ZOO_HOP = 80, 256  # HifiganGenerator's input frames: 80 bins, x256 upsampling
ZOO_NSF = {"nb_harmonics": 8, "sampling_rate": 24000}
ZOO_BWE_RATE = 8000
ZOO_D_SHAPE = (2, 76640)  # the discriminators' input: batch 2 of a generator training crop
ZOO_REL_TOL = 1e-3  # card against CPU, fp32, relative to max|ref| (CSMGAN's limit)
# the alternative backbones and the legacy family (phases 29-31)
GAGNET_SHAPE = (4, 512, 601, 2)  # 6 s at the repo's STFT (n_fft 1022, hop 160): 601 frames
TASNET_FS, TASNET_SHAPE = 24000, (4, 144000)  # 6 s at 24 kHz
ALT_CHECK_LANES = 1  # the lanes of the batch the CPU computes too
LEGACY_CLIP_S = 3
LEGACY_SCORE_EXPERIMENT = "SGMSE_Large"
# the regeneration's launches: one LSGAN generator forward and CHAIN_N
# score forwards (ncsnpplarge, 6 input channels); counted on the CPU by
# tests/test_torch_legacy.py::test_regeneration_launch_constants_of_chip_smoke
LEGACY_REGEN_LAUNCHES = {k: PER_GENERATOR_FORWARD[k] + CHAIN_N * PER_FORWARD["float32"][k]
                         for k in PER_GENERATOR_FORWARD}
# regeneration against the gan+sgmse chain, both on the card: the same
# computation, so equal up to this share of max|ref| (or bit for bit)
LEGACY_CHAIN_TOL = 1e-6
LEGACY_LOSS_REL_TOL = 1e-4  # DiscriminativeModel.train_loss, card against CPU
LEGACY_LAYER_SHAPE = (8, 128, 64, 64)
# bf16 and data-parallel training (phases 32-34): the bf16 microbatches'
# seeds (weights and batch) and the limit on the L2 error of all of a bf16
# microbatch's gradients against fp32's on the same weights and draws
# (PERF.md: the seeds' readings and the control's)
BF16_SEEDS = (1, 2, 3)
BF16_GRAD_L2_TOL = 0.1
# the torchrun runs: 2 optimizer steps of 2 microbatches of 2 clips over
# DDP_CLIPS clips (the overfit subset, the loader in the main process), one
# epoch; validation and test of the DDP_CLIPS clips in batches of 2
# (DDP_EVAL_BATCHES forwards); LSGAN one step of one microbatch, its
# generator in bf16. The overfit subset seeds numpy a item; the
# perturbations that draw from Python's random module are off, so that
# every run trains on the same items
DDP_CLIPS = 8
DDP_EVAL_BATCHES = DDP_CLIPS // 2 + -(-DDP_CLIPS // 2)
DDP_SAME_ITEMS = ("data.eq_perturb_prob=0", "data.eq_much_gain_prob=0",
                  "data.spectral_leakage_prob=0", "data.colored_noise_prob=0",
                  "data.colored_noise_post_prob=0")
DDP_TRAIN_ARGS = (IN_PROCESS_LOADER, f"data.overfit_items={DDP_CLIPS}", "data.batch_size=2",
                  "train.accumulate_grad_batches=2", "train.max_epochs=1", *DDP_SAME_ITEMS)
DDP_LSGAN_ARGS = (IN_PROCESS_LOADER, "data.overfit_items=2", "data.batch_size=2",
                  "train.accumulate_grad_batches=1", "train.max_epochs=1",
                  f"data.speech_splice_seconds={GAN_SPLICE_S}",
                  "model.generator.backbone_kwargs.dtype=bfloat16")
# the torchrun run's last weights against a plain run's, the L2 of their
# difference over that of the plain run's update: within twice the plain
# runs' own, or this where those agree bit for bit (a run on another
# number of CPU threads reads 2.1e-5 on the CPU; a gradient not averaged
# or not applied moves the weights by a whole update)
DDP_WEIGHTS_FLOOR = 1e-3
DDP_BACKEND = "nccl"  # torchrun's ranks on CUDA
# tensor-parallel training (phase 35): four gloo ranks on the card as
# make_mesh(data=2, model=2), one SGMSE_Large step (full width, remat, fp32)
# of one clip a data rank, the crop cut to TP_FRAMES frames; the recipe's
# grad_clip. K2's shapes there: Co 128 of a sharded Co 256 (and Co 64 at
# model 4), in SKIP_SHAPES
TP_LAYOUT = (2, 2)
TP_FRAMES = 128
TP_GRAD_CLIP = 100.0
# after the SGMSE step, the same ranks take one gan_train_step of the LSGAN
# recipe (full width, fp32, remat; the 24k_MVD bank; one clip a data rank)
# with the generator's crop cut from GAN_TRAIN_SHAPE's 480 frames to
# TP_GAN_FRAMES, then one of CSMGAN (one whole clip of TP_CSMGAN_S a data
# rank, the same bank from its initial weights), both nets cut
TP_GAN_FRAMES = 128
TP_CSMGAN_S = 1.0
# a first Adam step is lr g / (|g| + eps), eps 1e-8: above 100 eps it is
# lr sign(g) to within 1 %, so there a weight after the step follows the
# gradient's sign only; below, its value, which the gradient gate holds
# to TRAIN_GRAD_REL_TOL of its tensor's largest only
ADAM_SURE_FLOOR = 1e-6
# CSMGAN's sharded gradients against the one-process step's: its
# cumulative 1-D norms (eps 1e-8) multiply rounding by up to 1e4 at frames
# of almost no variance (tests/test_torch_csmgan.py), and the cut sums each
# conv's products in another order; its first card reading was 2.18e-4
# (a TCN PReLU slope, one scalar over 3M products). The summing control
# must still exceed it
TP_CSMGAN_GRAD_REL_TOL = 1e-3
# int8 serving cut over the model axis (phase 35, after the GAN steps): the
# same four ranks run the full-width ncsnpplarge forward in bf16 under
# quant='int8_pallas' (K3) and quant='int8' (the s8 conv), cut by the
# rule's default min_size, on one lane a data rank of TP_INT8_SHAPE (both
# lanes: [2, 512, TP_INT8_FRAMES, 4]); each cut int8 conv's gathered output
# must be bit-equal to the uncut conv's on the same arguments, the forward
# within BF16_REL_TOL of the uncut forward's largest |value|, the launches
# the one-process forward's (PER_FORWARD); then HiFi-GAN's generator (full
# width, fp32, transposed convs cut) on TP_HIFIGAN_FRAMES mel frames,
# against its uncut forward within ZOO_REL_TOL
TP_INT8_FRAMES = 64
TP_INT8_SHAPE = (2, 512, TP_INT8_FRAMES, 4)
TP_INT8_SEED = 3
TP_INT8_RUNS = {"int8_pallas": "int8_bfloat16", "int8": "int8conv_bfloat16"}
TP_HIFIGAN_FRAMES = 100


def phase(phase_name, **fields):
    print(json.dumps({"phase": phase_name, **fields}), flush=True)


def all_kernels(table):
    """A launch table with every kernel: 0 where it leaves one out."""
    return {k: table.get(k, 0) for k in KERNELS}


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
    ap.add_argument("--csmgan", action="store_true",
                    help="build, kernels, then only the CSMGAN phases")
    ap.add_argument("--int8conv", action="store_true",
                    help="build, kernels, then only the int8conv, DDPM and .npz phases (22-25)")
    ap.add_argument("--zoo", action="store_true",
                    help="build, kernels, then only the GAN zoo's phases (26-28)")
    ap.add_argument("--models", action="store_true",
                    help="build, kernels, then only the alternative backbones' and the "
                         "legacy family's phases (29-31)")
    ap.add_argument("--dist", action="store_true",
                    help="build, kernels, then only bf16 and data-parallel training "
                         "(phases 32-34)")
    ap.add_argument("--tp", action="store_true",
                    help="build, kernels, then only tensor parallelism (phase 35: training, "
                         "int8 serving)")
    ap.add_argument("--ddp-rank-worker", nargs=2, metavar=("DIR", "DEVICE"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--tp-rank-worker", nargs=2, metavar=("DIR", "DEVICE"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.ddp_rank_worker:  # one rank of phase 34, started by it
        ddp_rank_worker(*args.ddp_rank_worker)
        return 0
    if args.tp_rank_worker:  # one rank of phase 35, started by it
        tp_rank_worker(*args.tp_rank_worker)
        return 0
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
    elif args.csmgan:
        runs.update(csmgan_phases(torch, dev))
    elif args.int8conv:
        runs.update(int8conv_phases(torch, dev))
    elif args.zoo:
        runs.update(zoo_phases(torch, dev))
    elif args.models:
        runs.update(models_phases(torch, dev))
    elif args.dist:
        runs.update(dist_phases(torch, dev))
    elif args.tp:
        runs.update(timed("tp_ranks", tp_ranks_phase, torch, dev))
    elif not args.kernels:
        timed("forward", forward_phase, torch, dev)
        timed("int8_forward", int8_forward_phase, torch, dev)
        runs = {"float32": timed("predict float32", predict_phase, torch, dev, "float32", ()),
                "int8_bfloat16": timed("predict int8_bfloat16", predict_phase, torch, dev,
                                       "int8_bfloat16", INT8_PREDICT_ARGS)}
        runs.update(int8conv_phases(torch, dev))
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
        runs.update(gan_phases(torch, dev))
        runs.update(csmgan_phases(torch, dev))
        runs.update(zoo_phases(torch, dev))
        runs.update(models_phases(torch, dev))
        runs.update(dist_phases(torch, dev))
        runs.update(timed("tp_ranks", tp_ranks_phase, torch, dev))
        if args.profile:
            timed("profile", profile_phase, torch, dev)
            timed("profile_train", profile_train_phase, torch, dev)

    line = []
    for name, cases in results.items():
        main_case = cases[0]
        entry = {k: main_case[k] for k in (
            "name", "route", "source", "replaces", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "library_device_ms", "shape", "dtype",
            "device_ms") if k in main_case}
        # the count of the run whose path the kernel is on: K3 int8_pallas
        # serving, the int8 apply and the s8 conv int8 serving, K1 and K2
        # the LSGAN training (both phases, validation, test)
        path = {"qconv3x3_fused": "int8_bfloat16", "gn_apply_int8": "int8conv_bfloat16",
                "qconv3x3_s8": "int8conv_bfloat16"}.get(name, "train_lsgan")
        entry["launches"] = runs[path][name]
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


def kernel_ms_by_name(torch, fn, names, reps=2):
    """{label: device ms a fn() call of the kernels whose names contain
    names[label]}, from the profiler's kernel records over `reps` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    key = "self_device_time_total" if events and hasattr(events[0], "self_device_time_total") \
        else "self_cuda_time_total"
    return {label: sum(getattr(e, key) for e in events if part in e.key) / reps / 1e3
            for label, part in names.items()}


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
            # the library call: the group statistics the fold starts from
            # (torch.var_mean over each group's S x C/G elements); the
            # fold's own arithmetic is not in it
            x_groups = x3.reshape(b, groups, -1)
            ms, lib_ms = time_pair_ms(torch, lambda: g.gn_fold(x3, weight, bias, groups, 1e-6),
                                      lambda: torch.var_mean(x_groups, dim=2), KERNEL_REPS)
            results["channel_sums"].append(dict(
                name="channel_sums", variant="gn_fold", **common_gn, shape=list(shape),
                dtype=dtype_name, max_abs_err=err, tol=tol, ms=ms,
                device_ms=dev_ms, kernels_per_call=graph_kernels,
                profiler_kernels_per_call=per_call, profiler_exact=exact,
                plain_ms=time_ms(torch, lambda: g.gn_fold_plain(x3, weight, bias, groups, 1e-6),
                                 reps=KERNEL_REPS),
                library_ms=lib_ms,
                library_device_ms=device_ms(torch, lambda: torch.var_mean(x_groups, dim=2))[0],
                bound_ms=bms, bound_by=by))
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
    results["gn_apply_int8"] = gn_int8_phase(torch, dev, gen)
    results["qconv3x3_s8"] = s8_phase(torch, dev, gen)
    return results


def qconv_phase(torch, dev, gen):
    """K3 against its plain version at the int8 predict path's shapes (and
    a rank's shapes of phase 35's cut forward, TP_QCONV_SHAPES), fp32
    and bf16 input (output in the same dtype), with GroupNorm affine, SiLU
    and bias, in each of the kernel's tiles; and a control broken on
    purpose (x zero-padded before the affine, so act(off) leaks into the
    edges) that the same check must reject. fp32 tolerance: max |err| <= 4
    quanta of the largest output channel (4 * 127 * max sw) with at most
    1e-3 of the outputs off by more than 1e-6 * max|ref| (a quantum flipped
    by a last-bit difference of the sigmoid); bf16: one bf16 ulp of max|ref|.
    The kernel's time is on prepared weights (`ms`, with the tile the
    wrapper picks, single calls in turns with the library call, bf16 /
    fp32 F.conv2d on the unquantized activation, as `s8_phase` times them;
    `tile_ms` with each of the kernel's tiles), and `prep_ms` is the weight
    preparation alone. QCONV_RAGGED is checked, not timed."""
    import torch.nn.functional as F

    from use_tpu_torch.ops import fused_qconv as fq

    def judge(out, ref, tol):
        diff = (out.float() - ref.float()).abs()
        top = float(ref.float().abs().max())
        flips = int((diff > 1e-6 * top).sum())
        err = float(diff.max())
        return err, flips, flips / diff.numel(), (err <= tol and flips / diff.numel() <= 1e-3)

    mismatches = fq.rcp_mismatches(dev)
    phase("kernel_check", name="rcp_newton", floats="[1, inf] and NaN", mismatches=mismatches)
    if mismatches:
        raise AssertionError(f"K3's reciprocal differs from IEEE 1/d at {mismatches} floats")
    cases = []
    for dtype_name in ("float32", "bfloat16"):
        dt = getattr(torch, dtype_name)
        for shape in (*QCONV_SHAPES, *TP_QCONV_SHAPES, QCONV_RAGGED):
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
            tile = fq.pick_tile(hh, ww, o, b)
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
            if shape in TP_QCONV_SHAPES:
                checked["variant"] = "tp-int8"
            if shape == QCONV_RAGGED:
                phase("kernel_check", name="qconv3x3_fused", **checked)
                del x, out, out_tiles, out_public, ref, ctrl
                continue
            esz = x.element_size()
            nbytes = (x.numel() + out.numel()) * esz + prepared.qw.numel() + (2 * b * c + c + 2 * o) * 4
            bms, by = bound(nbytes, 2 * 9 * b * hh * ww * c * o, "int8")
            act_x = F.silu(x.float() * a[:, :, None, None] + off[:, :, None, None]).to(dt)
            bias_dt = bias.to(dt)
            library = lambda: F.conv2d(act_x, w, bias_dt, padding=1)  # noqa: E731
            ms, lib_ms = time_pair_ms(torch, lambda: fq.qconv3x3_fused_prepared(*run_args),
                                      library, 20)
            cases.append(dict(
                name="qconv3x3_fused", route="cuda", source="use_tpu_torch/csrc/fused_qconv.cu",
                replaces="use_tpu/ops/pallas_qconv.py:186", **checked,
                ms=ms, device_ms=device_ms(torch, lambda: fq.qconv3x3_fused_prepared(*run_args))[0],
                tile_ms={t: time_ms(torch, lambda: fq.qconv3x3_fused_prepared(*run_args, tile=t))
                         for t in fq.TILES},
                prep_ms=time_ms(torch, lambda: fq.prepare_qconv_weight(w, u)),
                plain_ms=time_ms(torch, lambda: fq.qconv3x3_fused_plain(*args), reps=3, warmup=1),
                library_ms=lib_ms, library_device_ms=device_ms(torch, library)[0],
                bound_ms=bms, bound_by=by))
            phase("kernel", **{k: v for k, v in cases[-1].items()
                               if k not in ("route", "source", "replaces")})
            del x, out, out_tiles, out_public, ref, ctrl, act_x
    torch.cuda.empty_cache()
    return cases


def _int8_operand(torch, gen, dev, b, c, hh, ww, dt):
    """An int8 activation as the int8conv path makes one (K1's fold, then
    its apply with the int8 epilogue, SiLU), its k-sigma scales u and the
    tensors it came from."""
    from use_tpu_torch.ops import gn_stats as g

    x = (torch.randn((b, c, hh, ww), generator=gen, device=dev) + 0.5).to(dt)
    weight = 1.0 + 0.1 * torch.randn((c,), generator=gen, device=dev)
    bias = 0.1 * torch.randn((c,), generator=gen, device=dev)
    u = (bias.abs() + 6.0 * weight.abs()) / 127.0 + 1e-12
    a, off = g.gn_fold(x.reshape(b, c, -1), weight, bias, g.num_groups(c), 1e-6)
    return x, a, off, u


def int8_net_scales(torch):
    """Every scale u of the int8 ncsnpplarge's GroupNorms before a quantized
    conv (quant='out'), with the weights of INT8_SEEDS (``_randomize``), as
    the int8conv forward serves them: the distinct values, fp32."""
    from use_tpu_torch.models import BackboneRegistry

    net = BackboneRegistry.get_by_name(FORWARD_BACKBONE)(input_channels=4, quant="int8")
    norms = [m for m in net.modules() if getattr(m, "quant", None) == "out"]
    scales = []
    for seed in INT8_SEEDS:
        _randomize(torch, net, seed=seed)
        scales += [m._act_scale().clone() for m in norms]
    return torch.unique(torch.cat(scales))


def division_checks(torch, dev):
    """The int8 apply's two divisions, held on the card against the plain
    version's: SiLU's at every float, the quantize's at every bf16 y for
    every scale of the int8 nets and at every float y with |y| <= 128 u for
    DIV_CHECK_U32 of them (evenly spaced in rank) and DIV_CHECK_EDGES with
    their float predecessors. Fails on any mismatch."""
    from use_tpu_torch.ops import gn_stats as g

    u = int8_net_scales(torch).to(dev)
    picks = u[torch.linspace(0, u.numel() - 1, DIV_CHECK_U32).round().long()]
    edges = torch.tensor(DIV_CHECK_EDGES, dtype=torch.float32)
    edges = torch.cat([edges, torch.nextafter(edges, torch.zeros_like(edges))]).to(dev)
    u32 = torch.cat([picks, edges])
    t0 = time.perf_counter()
    found = dict(silu=g.silu_mismatches(dev), quantize_bf16=g.quantize_mismatches(u, True),
                 quantize_fp32=g.quantize_mismatches(u32, False))
    phase("kernel_check", name="gn_apply_int8 divisions", scales=u.numel(),
          fp32_scales=[float(v) for v in u32], mismatches=found,
          seconds=round(time.perf_counter() - t0, 2))
    if any(found.values()):
        raise AssertionError(f"the int8 apply's divisions differ from IEEE's: {found}")


def gn_int8_phase(torch, dev, gen):
    """K1's apply with its int8 epilogue against its plain version (the
    apply in torch ops, then the quantize) on the same fold, at
    GN_INT8_SHAPES, fp32 and bf16 serving dtypes: bit-equal (atol 0), in the
    conv's C32 layout (what the int8 path asks for, and what is timed) and
    unpacked to [B, C, S]. No single library call computes it (library_ms
    null). Then its divisions (``division_checks``)."""
    from use_tpu_torch.ops import gn_stats as g

    cases = []
    for dtype_name in ("float32", "bfloat16"):
        dt = getattr(torch, dtype_name)
        for shape in GN_INT8_SHAPES:
            b, c, hh, ww = shape
            x, a, off, u = _int8_operand(torch, gen, dev, b, c, hh, ww, dt)
            x3 = x.reshape(b, c, -1)
            args = (x3, a, off, u, "swish", dt)
            q = g.gn_apply_int8(*args, c32=True)
            ref = g.gn_apply_int8_plain(*args, c32=True)
            q_nchw = g.gn_apply_int8(*args)
            ref_nchw = g.gn_apply_int8_plain(*args)
            torch.cuda.synchronize()
            err = max(int((q.int() - ref.int()).abs().max()),
                      int((q_nchw.int() - ref_nchw.int()).abs().max()))
            check("gn_apply_int8", shape, dtype_name, err, 0)
            nbytes = x.numel() * (x.element_size() + 1) + 2 * b * c * 4 + c * 4
            bms, by = bound(nbytes, 8 * x.numel(), dtype_name)
            run = lambda: g.gn_apply_int8(*args, c32=True)  # noqa: E731
            cases.append(dict(
                name="gn_apply_int8", route="cuda", source="use_tpu_torch/csrc/gn_stats.cu",
                replaces="use_tpu/models/ncsnpp/layers.py:257", shape=list(shape),
                dtype=dtype_name, max_abs_err=float(err), tol=0.0,
                clipped_share=float((ref_nchw.abs() == 127).float().mean()),
                ms=time_ms(torch, run, reps=KERNEL_REPS), device_ms=device_ms(torch, run)[0],
                plain_ms=time_ms(torch, lambda: g.gn_apply_int8_plain(*args, c32=True),
                                 reps=KERNEL_REPS),
                library_ms=None, bound_ms=bms, bound_by=by))
            phase("kernel", **{k: v for k, v in cases[-1].items()
                               if k not in ("route", "source", "replaces")})
            del x, x3, q, ref, q_nchw, ref_nchw
    division_checks(torch, dev)
    torch.cuda.empty_cache()
    return cases


def s8_phase(torch, dev, gen):
    """The s8 conv (qconv3x3_s8) against its plain version (the int8
    values convolved in float64, exact) at the int8 path's shapes
    (QCONV_SHAPES, a rank's of phase 35, TP_QCONV_SHAPES, and QCONV_RAGGED
    checked, not timed), fp32 and bf16
    output, on C32 operands that K1's int8 apply made, with the producer's
    u folded into the weight: bit-equal (atol 0) in each of the kernel's
    tiles, and with a per-sample post-scale (the dynamic path's). Its
    library call is bf16 / fp32 F.conv2d on the unquantized activation, as
    K3's rows time it, with its profiled device time beside the kernel's;
    `prep_ms` times the weight preparation."""
    import torch.nn.functional as F

    from use_tpu_torch.ops import gn_stats as g
    from use_tpu_torch.ops import qconv as q

    cases = []
    for dtype_name in ("float32", "bfloat16"):
        dt = getattr(torch, dtype_name)
        for shape in (*QCONV_SHAPES, *TP_QCONV_SHAPES, QCONV_RAGGED):
            b, c, o, hh, ww = shape
            x, a, off, u = _int8_operand(torch, gen, dev, b, c, hh, ww, dt)
            qx = g.gn_apply_int8(x.reshape(b, c, -1), a, off, u, "swish", dt, c32=True)
            qx = qx.reshape(*qx.shape[:3], hh, ww, qx.shape[-1])
            w = (torch.randn((o, c, 3, 3), generator=gen, device=dev) / math.sqrt(9 * c)).to(dt)
            bias = 0.05 * torch.randn((o,), generator=gen, device=dev)
            prepared = q.prepare_s8_weight(w, u)
            ref = q.s8_conv_plain(qx, prepared.qw, prepared.sw, bias, dt)
            tile = q.pick_tile(ww)
            outs = {t: q.qconv3x3_s8(qx, prepared, None, bias, dt, tile=t) for t in q.TILES}
            post = 0.5 + torch.rand((b,), generator=gen, device=dev)
            unfolded = q.prepare_s8_weight(w)
            out_post = q.qconv3x3_s8(qx, unfolded, post, bias, dt)
            ref_post = q.s8_conv_plain(qx, unfolded.qw, q._scale(unfolded.sw, post), bias, dt)
            torch.cuda.synchronize()
            errs = {t: float((v.float() - ref.float()).abs().max()) for t, v in outs.items()}
            post_err = float((out_post.float() - ref_post.float()).abs().max())
            err = max(*errs.values(), post_err)
            if not (err == 0.0 and torch.isfinite(ref).all()):
                raise AssertionError(f"qconv3x3_s8 {shape} {dtype_name}: max_abs_err by tile "
                                     f"{errs}, with a post-scale {post_err}; bit-equal expected")
            checked = dict(shape=list(shape), dtype=dtype_name, tile=tile, max_abs_err=err,
                           tol=0.0, tile_max_abs_err=errs, post_scale_max_abs_err=post_err)
            if shape in TP_QCONV_SHAPES:
                checked["variant"] = "tp-int8"
            if shape == QCONV_RAGGED:
                phase("kernel_check", name="qconv3x3_s8", **checked)
                continue
            esz = torch.empty((), dtype=dt).element_size()
            nbytes = b * c * hh * ww + b * o * hh * ww * esz + o * c * 9 + 2 * o * 4
            bms, by = bound(nbytes, 2 * 9 * b * hh * ww * c * o, "int8")
            act_x = F.silu(x.float() * a[:, :, None, None] + off[:, :, None, None]).to(dt)
            bias_dt = bias.to(dt)
            run = (qx, prepared, None, bias, dt)
            library = lambda: F.conv2d(act_x, w, bias_dt, padding=1)  # noqa: E731
            ms, lib_ms = time_pair_ms(torch, lambda: q.qconv3x3_s8(*run), library, 20)
            cases.append(dict(
                name="qconv3x3_s8", route="cuda", source="use_tpu_torch/csrc/qconv_s8.cu",
                replaces="use_tpu/ops/qconv.py:79", **checked,
                ms=ms, device_ms=device_ms(torch, lambda: q.qconv3x3_s8(*run))[0],
                tile_ms={t: time_ms(torch, lambda: q.qconv3x3_s8(*run, tile=t)) for t in q.TILES},
                prep_ms=time_ms(torch, lambda: q.prepare_s8_weight(w, u)),
                plain_ms=time_ms(torch, lambda: q.s8_conv_plain(qx, prepared.qw, prepared.sw,
                                                                bias, dt), reps=3, warmup=1),
                library_ms=lib_ms, library_device_ms=device_ms(torch, library)[0],
                bound_ms=bms, bound_by=by))
            phase("kernel", **{k: v for k, v in cases[-1].items()
                               if k not in ("route", "source", "replaces")})
            del x, qx, outs, ref, out_post, ref_post, act_x
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
    lane: the card (kernels) against the CPU (plain versions) in fp32 on
    FORWARD_CHECK_LANES of the card's lanes; then
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
    lanes = list(FORWARD_CHECK_LANES)
    with torch.inference_mode():
        t0 = time.perf_counter()
        ref = net(x[lanes], t[lanes])
        cpu_s = time.perf_counter() - t0
        gnet = copy.deepcopy(net).to(dev)
        xd, td = x.to(dev), t.to(dev)
        out = gnet(xd, td)
        torch.cuda.synchronize()
        err = float((out[lanes].cpu() - ref).abs().max())
        top = float(ref.abs().max())
        tol = 1e-3 * top  # fp32 on both sides, ~100 layers summed in other orders
        if not (torch.isfinite(out).all() and err <= tol):
            raise AssertionError(f"forward: card vs CPU max_abs_err {err} > tol {tol}")
        phase("forward", backbone=FORWARD_BACKBONE, shape=list(FORWARD_SHAPE), dtype="float32",
              tf32=False, t=[round(float(v), 4) for v in t], cpu_lanes=lanes,
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
def count_calls(owner, attr, out_channels, in_channels=None):
    """Counts the calls of owner.<attr>(x, second, ...) by "HxW CtoO" (O =
    out_channels(second); C from x, or in_channels(second); H and W x's last
    two, before a C32 operand's channel axis) while it is in effect."""
    real = getattr(owner, attr)
    counts = {}

    def counting(x, second, *args, **kw):
        hh, ww = x.shape[-3:-1] if x.dim() == 6 else x.shape[2:4]
        c = x.shape[1] if in_channels is None else in_channels(second)
        key = f"{hh}x{ww} {c}to{out_channels(second)}"
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


@contextlib.contextmanager
def plain_int8conv():
    """The int8conv path's two kernels (K1's int8 apply and the s8 conv)
    swapped for their plain versions; K1's statistics and K2 stay kernels."""
    from use_tpu_torch.models.ncsnpp import layers
    from use_tpu_torch.ops import gn_stats, qconv

    real = qconv.qconv3x3_s8, layers.gn_apply_int8

    def s8_plain(qx, prepared, post=None, bias=None, out_dtype=None):
        return qconv.s8_conv_plain(qx, prepared.qw, qconv._scale(prepared.sw, post), bias,
                                   out_dtype)

    qconv.qconv3x3_s8, layers.gn_apply_int8 = s8_plain, gn_stats.gn_apply_int8_plain
    try:
        yield
    finally:
        qconv.qconv3x3_s8, layers.gn_apply_int8 = real


@contextlib.contextmanager
def unfolded_weights(net):
    """A control broken on purpose: every quantized conv's weight quantized
    without the producer's per-channel scale u folded in (w instead of
    w * u[c]); the kept weights are dropped before and after."""
    from use_tpu_torch.models.ncsnpp import layers
    from use_tpu_torch.ops import qconv

    convs = [m for m in net.modules() if isinstance(m, layers.QConv)]
    real = qconv.prepare_s8_weight
    for m in convs:
        m._prepared = None
    qconv.prepare_s8_weight = lambda weight, u=None: real(weight)
    try:
        yield
    finally:
        qconv.prepare_s8_weight = real
        for m in convs:
            m._prepared = None


def int8conv_forward_phase(torch, dev):
    """Full-width int8 ncsnpplarge (quant='int8') at the chunked predict
    shape, fp32 and bf16 compute, for INT8_SEEDS: the card with the int8
    apply and the s8 conv against the card with their plain versions,
    within INT8_REL_TOL of max|plain| (the sums are exact integers on both
    sides), and the control with u left out of the weights, which must
    exceed it; each forward's launches exactly PER_FORWARD["int8conv_
    bfloat16"] (K3 none); as readings, two runs with the kernels against
    each other, the relative L2 distance to the fp32 network without
    quantization, the forward's time, its kernels' time and count a forward
    (profiler) and peak memory, and the s8 conv's calls by image size and
    channels."""
    from use_tpu_torch import ops
    from use_tpu_torch.models import BackboneRegistry
    from use_tpu_torch.models.ncsnpp.ncsnpp import cast_backbone_for_inference
    from use_tpu_torch.ops import qconv

    want = all_kernels(PER_FORWARD["int8conv_bfloat16"])
    gen = torch.Generator().manual_seed(0)
    x = (0.5 * torch.randn(FORWARD_SHAPE, generator=gen)).to(dev)
    t = torch.linspace(0.1, 0.9, FORWARD_SHAPE[0]).to(dev)
    fnet = BackboneRegistry.get_by_name(FORWARD_BACKBONE)(input_channels=4).to(dev)
    for dtype in ("float32", "bfloat16"):
        # built outside inference mode, as the CLI builds it, so that the
        # prepared int8 weights are kept from forward to forward
        qnet = BackboneRegistry.get_by_name(FORWARD_BACKBONE)(
            input_channels=4, dtype=dtype, quant="int8").to(dev)
        cast_backbone_for_inference(qnet)
        with torch.inference_mode():
            readings, control = [], None
            for seed in INT8_SEEDS:
                _randomize(torch, fnet, seed=seed)
                qnet.load_state_dict(fnet.state_dict())
                ref32 = fnet(x, t)
                ops.reset_launch_counts()
                with count_calls(qconv, "qconv3x3_s8", lambda p: p.qw.shape[0],
                                 lambda p: p.qw.shape[1]) as calls:
                    out = qnet(x, t)
                torch.cuda.synchronize()
                counts = ops.launch_counts()
                if counts != want:
                    raise AssertionError(f"int8conv forward {dtype}: launches {counts}, "
                                         f"expected {want}")
                again = qnet(x, t)
                with plain_int8conv():
                    plain = qnet(x, t)
                torch.cuda.synchronize()
                if not torch.isfinite(out).all():
                    raise AssertionError(f"int8conv forward {dtype} seed {seed}: non-finite")
                top = float(plain.abs().max())
                readings.append(dict(
                    seed=seed, max_rel_err=float((out - plain).abs().max()) / top,
                    repeat_max_rel_err=float((again - out).abs().max()) / top,
                    rel_l2_vs_fp32=float((out - ref32).norm() / ref32.norm())))
                if control is None:
                    with unfolded_weights(qnet):
                        control = float((qnet(x, t) - plain).abs().max()) / top
            torch.cuda.reset_peak_memory_stats(dev)
            ms = time_ms(torch, lambda: qnet(x, t), reps=3, warmup=1)
            peak = torch.cuda.max_memory_allocated(dev)
            kernel_ms, kernels, _ = device_ms(torch, lambda: qnet(x, t), reps=2)
            split = kernel_ms_by_name(torch, lambda: qnet(x, t), {
                "qconv3x3_s8": "qconv_s8_kernel", "gn_apply_int8": "apply_q8_kernel"}, reps=2)
            phase("int8conv_forward", backbone=FORWARD_BACKBONE, shape=list(FORWARD_SHAPE),
                  dtype=dtype, quant="int8", against="the plain int8 apply and s8 conv on the card",
                  tol=INT8_REL_TOL, readings=readings, control="u not folded into the weights",
                  control_max_rel_err=control, ms=ms, device_ms=kernel_ms,
                  kernels_per_forward=kernels, kernel_device_ms=split, peak_bytes=peak,
                  launches=counts, s8_calls=by_level(calls))
            worst = max(r["max_rel_err"] for r in readings)
            if not worst <= INT8_REL_TOL:
                raise AssertionError(f"int8conv forward {dtype}: max_rel_err {worst} > "
                                     f"tol {INT8_REL_TOL}")
            if not control > INT8_REL_TOL:
                raise AssertionError(f"int8conv forward {dtype}: control {control} passes "
                                     f"tol {INT8_REL_TOL}")
        del qnet
    del fnet
    torch.cuda.empty_cache()


def ddpm_forward_phase(torch, dev):
    """The full-width ncsnpplarge with DDPM blocks and residual pyramids
    (DDPM_KWARGS), FIR resampling on and off, seeded random weights, fp32
    at DDPM_SHAPE: the card against the CPU within 1e-3 x max|ref|, its
    launches a forward exactly PER_DDPM_FORWARD, and its time."""
    from use_tpu_torch import ops
    from use_tpu_torch.models import BackboneRegistry

    want = all_kernels(PER_DDPM_FORWARD)
    x = 0.5 * torch.randn(DDPM_SHAPE, generator=torch.Generator().manual_seed(0))
    t = torch.full((DDPM_SHAPE[0],), 0.5)
    for fir in (True, False):
        net = BackboneRegistry.get_by_name(FORWARD_BACKBONE)(input_channels=4, fir=fir,
                                                            **DDPM_KWARGS, seed=0)
        _randomize(torch, net, seed=1)
        with torch.inference_mode():
            t0 = time.perf_counter()
            ref = net(x, t)
            cpu_s = time.perf_counter() - t0
            gnet = copy.deepcopy(net).to(dev)
            xd, td = x.to(dev), t.to(dev)
            ops.reset_launch_counts()
            out = gnet(xd, td)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            err = float((out.cpu() - ref).abs().max())
            top = float(ref.abs().max())
            tol = 1e-3 * top
            ms = time_ms(torch, lambda: gnet(xd, td), reps=5, warmup=1)
        phase("ddpm_forward", backbone=FORWARD_BACKBONE, **DDPM_KWARGS, fir=fir,
              shape=list(DDPM_SHAPE), dtype="float32", tf32=False, max_abs_err=err, tol=tol,
              max_abs_ref=top, cpu_seconds=round(cpu_s, 2), ms=ms, launches=counts)
        if not (torch.isfinite(out).all() and err <= tol):
            raise AssertionError(f"ddpm forward fir={fir}: card vs CPU max_abs_err {err} > "
                                 f"tol {tol}")
        if counts != want:
            raise AssertionError(f"ddpm forward fir={fir}: launches {counts}, expected {want}")
        del net, gnet, ref, out
    torch.cuda.empty_cache()


def flax_flat(state_dict):
    """The port's NCSN++ state_dict in use_tpu's flat naming, as
    scripts/export_use_tpu_params.py writes it where JAX is installed: the
    inverse of engine/convert_jax.py::ncsnpp_params_to_state_dict
    (all_modules.{i} -> m{i}, OIHW -> HWIO, [O, I] -> [I, O], a 1-D weight
    -> scale, Conv2d_0.weight / .bias -> Conv2d_0_weight / _bias)."""
    out = {}
    for key, value in state_dict.items():
        arr = value.detach().float().cpu().numpy()
        parts = key.split(".")
        if parts[0] == "all_modules":
            parts = [f"m{parts[1]}"] + parts[2:]
        *scope, leaf = parts
        if leaf == "weight":
            if arr.ndim == 4:
                arr, leaf = arr.transpose(2, 3, 1, 0), "kernel"
            elif arr.ndim == 2:
                arr, leaf = arr.T, "kernel"
            else:
                leaf = "scale"
        if scope and scope[-1] == "Conv2d_0":
            scope, leaf = scope[:-1], "Conv2d_0_" + ("weight" if leaf == "kernel" else leaf)
        out["/".join(scope + [leaf])] = np.ascontiguousarray(arr)
    return out


def npz_predict_phase(torch, dev):
    """`predict ckpt_path=<x>.npz` (use_tpu's flat naming, ``flax_flat``)
    against `predict ckpt_path=<x>.pt` of the same seeded random weights as
    a state_dict, for each of NPZ_EXPERIMENTS on the card: the same wavs,
    bit for bit (one set of weights, the same sampler draws)."""
    from use_tpu_torch.cli.main import _backbone, _build_model, main as cli_main
    from use_tpu_torch.config.config import load_config
    from use_tpu_torch.data.audio_io import read_wav

    sr = 24000
    for experiment in NPZ_EXPERIMENTS:
        cfg = load_config(experiment, [])
        net = _backbone(_build_model(cfg, "cpu"))
        _randomize(torch, net, seed=4)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            src = os.path.join(tmp, "in")
            lengths = write_clips(src, NPZ_CLIPS_S, sr)
            pt, npz = os.path.join(tmp, "w.pt"), os.path.join(tmp, "w.npz")
            torch.save(net.state_dict(), pt)
            generator = None if cfg["task"] == "sgmse" else dict(cfg["model"]["generator"]).get(
                "name", "ncsnpp_wrapper")
            meta = {"experiment": experiment, "task": cfg["task"], "generator": generator,
                    "ema": False, "discriminator": False}
            np.savez(npz, __meta__=np.asarray(json.dumps(meta)), **flax_flat(net.state_dict()))
            outs, seconds = {}, {}
            for name, ckpt in (("pt", pt), ("npz", npz)):
                t0 = time.perf_counter()
                summary = cli_main(["predict", f"experiment={experiment}", f"ckpt_path={ckpt}",
                                    f"predict.data_folder={src}", f"infer.N={NPZ_N}",
                                    f"predict.target_folder={os.path.join(tmp, name)}",
                                    f"device={dev}"])
                seconds[name] = round(time.perf_counter() - t0, 2)
                check_outputs(os.path.join(tmp, name), lengths, sr, summary)
                outs[name] = {rel: read_wav(os.path.join(tmp, name, rel))[0] for rel in lengths}
        equal = all(np.array_equal(outs["npz"][rel], outs["pt"][rel]) for rel in lengths)
        phase("npz_predict", experiment=experiment, N=NPZ_N, clips_s=list(NPZ_CLIPS_S),
              arrays=len(flax_flat(net.state_dict())), equal=equal, seconds=seconds)
        if not equal:
            raise AssertionError(f"npz predict {experiment}: the .npz route differs from the "
                                 "state_dict route")


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
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        summary = cli_main(["predict", f"experiment={PREDICT_EXPERIMENT}",
                            f"predict.data_folder={src}", f"predict.target_folder={dst}",
                            f"infer.N={PREDICT_N}", f"device={dev}", *extra_args])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        check_outputs(dst, lengths, sr, summary)
    forwards = len(lengths) * PREDICT_N
    want = {k: v * forwards for k, v in all_kernels(PER_FORWARD[label]).items()}
    if counts != want:
        raise AssertionError(f"predict {label}: kernel launches {counts}, expected {want} "
                             f"({PER_FORWARD[label]} x {forwards} forwards)")
    phase("predict", run=label, experiment=PREDICT_EXPERIMENT, args=list(extra_args), N=PREDICT_N,
          clips_s=list(PREDICT_CLIPS_S), tf32=bool(torch.backends.cudnn.allow_tf32),
          files=summary["files"], audio_seconds=summary["audio_seconds"],
          sampling_seconds=summary["seconds"], wall_seconds=wall,
          audio_s_per_s=summary["audio_seconds"] / summary["seconds"],
          peak_bytes=torch.cuda.max_memory_allocated(dev), launches=counts)
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
    full width) with seeded random weights: the card (kernels) against the
    CPU (plain versions) within 1e-3 x max|ref| on the first
    GAN_CHECK_FRAMES frames, as forward_phase; at GAN_FORWARD_SHAPE the
    launches of one forward on the card must equal PER_GENERATOR_FORWARD;
    K2's calls by level; the forward's time."""
    from use_tpu_torch import ops
    from use_tpu_torch.models import BackboneRegistry
    from use_tpu_torch.models.ncsnpp import layers

    net = BackboneRegistry.get_by_name("ncsnpp")(discriminative=True, seed=0)
    _randomize(torch, net, seed=1)
    x = 0.5 * torch.randn(GAN_FORWARD_SHAPE, generator=torch.Generator().manual_seed(0))
    check = x[:, :, :GAN_CHECK_FRAMES].contiguous()
    with torch.inference_mode():
        t0 = time.perf_counter()
        ref = net(check, None)
        cpu_s = time.perf_counter() - t0
        gnet = copy.deepcopy(net).to(dev)
        xd = x.to(dev)
        ops.reset_launch_counts()
        with count_calls(layers, "fused_skip_add", lambda h: h.shape[1]) as skip_calls:
            out = gnet(xd, None)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        out_check = gnet(check.to(dev), None)
        err = float((out_check.cpu() - ref).abs().max())
        top = float(ref.abs().max())
        tol = 1e-3 * top
        ms = time_ms(torch, lambda: gnet(xd, None), reps=5, warmup=1)
    phase("lsgan_forward", backbone="ncsnpp", discriminative=True, shape=list(GAN_FORWARD_SHAPE),
          check_frames=GAN_CHECK_FRAMES, dtype="float32", tf32=False, max_abs_err=err, tol=tol,
          max_abs_ref=top,
          cpu_seconds=round(cpu_s, 2), ms=ms, launches=counts, skip_calls=by_level(skip_calls))
    if not (torch.isfinite(out).all() and torch.isfinite(out_check).all() and err <= tol):
        raise AssertionError(f"lsgan forward: card vs CPU max_abs_err {err} > tol {tol}")
    if counts != all_kernels(PER_GENERATOR_FORWARD):
        raise AssertionError(f"lsgan forward: launches {counts}, expected {PER_GENERATOR_FORWARD}")
    del net, gnet, ref, out, out_check
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
        want = {k: v * st["forwards"] for k, v in all_kernels(per_stage[name]).items()}
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


def _train_model(torch, device, remat=True, num_frames=None):
    """The recipe's score model (SGMSE_Large: ncsnpplarge, fp32, remat
    conv_outs) on `device`, seeded random unit-scale weights; its crop cut
    to `num_frames` where given."""
    from use_tpu_torch.config.config import load_config
    from use_tpu_torch.models.sgmse.score_model import ScoreModel

    cfg = load_config(TRAIN_EXPERIMENT)
    mcfg = dict(cfg["model"])
    if num_frames is not None:
        mcfg["num_frames"] = num_frames
    mcfg["backbone_kwargs"] = {**mcfg["backbone_kwargs"], "remat": remat}
    model = ScoreModel(**mcfg, device="cpu", seed=0)
    _randomize(torch, model.score_net, seed=1)
    model.score_net.to(device)
    model.device = torch.device(device)
    return model, cfg


def _train_batch(torch, model, clips, seed=5):
    """One microbatch of `clips` clips a little longer than the crop, and
    the loss's draws (crop start, t, z) from a CPU generator."""
    length = model.target_len + 4000
    rng = np.random.default_rng(seed)
    clean = (0.3 * rng.standard_normal((clips, length))).astype(np.float32)
    noisy = (clean + 0.1 * rng.standard_normal(clean.shape)).astype(np.float32)
    batch = {"clean": torch.from_numpy(clean), "perturbed": torch.from_numpy(noisy)}
    return batch, model.draw_train(clips, length, torch.Generator().manual_seed(seed))


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
    """One full-width microbatch (CHECK_CLIPS clips, the crop cut to
    TRAIN_CHECK_FRAMES) through train_loss and backward on the CPU (plain
    versions) and on the
    card (kernels), on the same weights, batch and draws: the loss within 1e-4 relative, every
    gradient within TRAIN_GRAD_REL_TOL of its own tensor's largest value
    (the attention's key biases, zero in exact arithmetic, below
    KEY_BIAS_GRAD_FLOOR of the largest of all on both devices), the same
    microbatch with TF32 on off by more than that; each kernel launched exactly
    TRAIN_LAUNCHES["remat"] times; then one optimizer step (clip, L2, Adam)
    leaves finite, changed weights. Then the recipe's microbatch
    (TRAIN_SHAPE) time and peak device memory with remat (median of 3) and
    without, whose launches must be TRAIN_LAUNCHES["no_remat"]."""
    from use_tpu_torch import ops
    from use_tpu_torch.engine.loop import build_train_state

    cpu, cfg = _train_model(torch, "cpu", num_frames=TRAIN_CHECK_FRAMES)
    batch, draws = _train_batch(torch, cpu, CHECK_CLIPS)
    loss_cpu, cpu_s = _microbatch(torch, cpu, batch, draws)
    grads_cpu = {k: p.grad for k, p in cpu.score_net.named_parameters() if p.grad is not None}
    gpu, _ = _train_model(torch, dev)
    recipe_frames, gpu.num_frames = gpu.num_frames, TRAIN_CHECK_FRAMES
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
    gpu.num_frames = recipe_frames
    batch, draws = _train_batch(torch, gpu, TRAIN_SHAPE[0])
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
    phase("train_step", experiment=TRAIN_EXPERIMENT, shape=list(TRAIN_SHAPE),
          check_clips=CHECK_CLIPS, check_frames=TRAIN_CHECK_FRAMES, dtype="float32",
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
    if (counts != all_kernels(TRAIN_LAUNCHES["remat"])
            or counts_no_remat != all_kernels(TRAIN_LAUNCHES["no_remat"])):
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
    data pipeline in the main process, IN_PROCESS_LOADER, batch 2 x
    accumulation 4, fp32, remat): a
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
                                IN_PROCESS_LOADER, f"out_dir={out}", f"device={dev}"])
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        with open(os.path.join(out, "optimized_metric.json")) as f:
            record = json.load(f)
        steps = sorted(os.listdir(os.path.join(out, "checkpoints")))
        micro = summary["microbatches"]
        step_s = rec["step_s"] + ([rec["profiled"]["wall_s"]] if rec["profiled"] else [])
        want = {k: v * micro + all_kernels(PER_FORWARD["float32"])[k] * rec["eval_steps"]
                for k, v in all_kernels(TRAIN_LAUNCHES["remat"]).items()}
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
    pwant = {k: v * TRAIN_PREDICT_N for k, v in all_kernels(PER_FORWARD["float32"]).items()}
    phase("predict", run="trained checkpoint", experiment=TRAIN_EXPERIMENT,
          N=TRAIN_PREDICT_N, files=summary["files"], audio_seconds=summary["audio_seconds"],
          sampling_seconds=summary["seconds"], launches=pcounts)
    if pcounts != pwant:
        raise AssertionError(f"predict of the trained checkpoint: launches {pcounts}, "
                             f"expected {pwant}")
    torch.cuda.empty_cache()
    return counts


def _learn_worker(device):
    """The SGMSE learning gate's run (phase 12) in a spawned process:
    deterministic algorithms, TF32 off as in the parent."""
    import torch

    import use_tpu_torch.models  # noqa: F401 (registries)
    from use_tpu_torch.tools import learn_gate

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    learn_gate.deterministic(torch, True)
    return learn_gate.learn_run(torch, device)


def learn_check(run):
    """use_tpu's learning gate on the card (tests/test_learning.py::
    test_sgmse_learns_to_enhance) as it runs it: one run at its seed 0
    (tools/learn_gate.py, `_learn_worker`) with deterministic algorithms, as
    XLA's CPU run is one fixed trajectory; the loss must fall and the mean
    SI-SDR gain of two held-out probes over their noisy input must exceed
    learn_gate.GATE_DB."""
    from use_tpu_torch.tools import learn_gate

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
    batch, draws = _train_batch(torch, model, TRAIN_SHAPE[0])
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
    runs = timed("train_lsgan", train_gan_phase, torch, dev, GAN_EXPERIMENT, GAN_TRAIN_CLIPS,
                 GAN_SPLICE_S, GAN_CROP_S, GAN_TRAIN_LAUNCHES["remat"], PER_GENERATOR_FORWARD,
                 (), None, GAN_TRAIN_ARGS)
    runs[f"eval {EVAL_SGMSE}"] = timed(f"eval {EVAL_SGMSE}", eval_phase, torch, dev, EVAL_SGMSE,
                                       None, PER_FORWARD["float32"])
    timed("learn_lsgan", learn_lsgan_phase, torch, dev)
    return runs


def _gan_model(torch, device, remat=True, discriminator=None):
    """The LSGAN recipe as the CLI builds it (the `ncsnpp` generator, fp32,
    remat conv_outs; the 24k_MVD bank, or the `discriminator` of
    model.discriminator=; the shipped criterion) on `device`, the
    generator's weights seeded unit-scale random, D's seeded as Flax's."""
    from use_tpu_torch.cli.main import _build_model
    from use_tpu_torch.config.config import load_config

    cfg = load_config(GAN_EXPERIMENT, [f"model.discriminator={discriminator}"]
                      if discriminator else None)
    gan = _build_model(cfg, "cpu")
    net = gan.generator.net
    net.cfg = dataclasses.replace(net.cfg, remat=remat)
    _randomize(torch, net, seed=1)
    return _gan_to(torch, gan, device), cfg


def _crop(generator, frames):
    """The NCSN++ generator's training crop set to `frames` STFT frames."""
    generator.num_frames, generator.target_len = frames, (frames - 1) * generator.hop_length


def _gan_to(torch, gan, device):
    gan.generator.net.to(device)
    gan.generator.device = torch.device(device)
    gan.discriminator.to(device)
    return gan


def _gan_batch(torch, gan, clips, seed=5):
    """One microbatch of `clips` clips a little longer than the crop, and
    its crop start from a CPU generator."""
    length = gan.generator.target_len + 4000
    rng = np.random.default_rng(seed)
    clean = (0.3 * rng.standard_normal((clips, length))).astype(np.float32)
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


def gan_train_step_phase(torch, dev, discriminator=None):
    """One full-width LSGAN microbatch (phase 13; CHECK_CLIPS clips, the crop
    cut to GAN_STEP_CHECK_FRAMES): the D
    phase and the G phase (against the same D) on the card (kernels) and on
    the CPU (plain versions), on the same weights, batch and crop start, the CPU on the
    card's branch of every leaky ReLU of D (lrelu_branches: a pre-activation
    within rounding of 0 takes either branch, and its gradient jumps by
    0.9 of its term; the flips are counted): loss_D and every loss_G*
    within 1e-4 relative (the log terms 1e-3, as tests/test_torch_gan_train.py
    argues), every D and G gradient within TRAIN_GRAD_REL_TOL of its own
    tensor's largest value (the attention's key biases below
    KEY_BIAS_GRAD_FLOOR of the largest of all), the same microbatch with
    TF32 on off by more; then gan_train_step (both Adam steps) on the
    recipe's microbatch (GAN_TRAIN_SHAPE): finite, moved weights, launches
    exactly GAN_TRAIN_LAUNCHES with remat (median time of 3, and one profiled: the share of its wall time the card ran a
    kernel) and without, and peak device memory. With `discriminator`
    (phase 26, gan24k_train_step: GAN24K_DISCRIMINATOR) the same microbatch
    against that bank, the leaky ReLUs of its multi-scale bank replayed
    too; its gan_train_step is timed with remat only (median of 3, no
    profile)."""
    from use_tpu_torch.engine.loop import build_gan_train_state

    label = "gan_train_step" if discriminator is None else "gan24k_train_step"
    cpu, cfg = _gan_model(torch, "cpu", discriminator=discriminator)
    recipe_frames = cpu.generator.num_frames
    _crop(cpu.generator, GAN_STEP_CHECK_FRAMES)
    batch, start = _gan_batch(torch, cpu, CHECK_CLIPS)
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
    check_samples = int(batch["clean"].shape[-1])
    _crop(gan.generator, recipe_frames)
    batch, start = _gan_batch(torch, gan, GAN_TRAIN_SHAPE[0])
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
    net = gan.generator.net
    profiled = counts_no_remat = no_remat_s = peak_no_remat = None
    if discriminator is None:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            wall = _gan_step_launches(torch, gan, state, batch, start)[1]
        kernel_s, busy_s, busy = kernel_busy(prof, wall)
        profiled = {"wall_s": wall, "kernel_s": kernel_s, "kernel_union_s": busy_s,
                    "busy_share": busy}
        net.cfg = dataclasses.replace(net.cfg, remat=False)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        counts_no_remat, no_remat_s = _gan_step_launches(torch, gan, state, batch, start)
        peak_no_remat = torch.cuda.max_memory_allocated(dev)
    n_g, n_d = len(list(net.parameters())), len(list(gan.discriminator.parameters()))
    phase(label, experiment=GAN_EXPERIMENT, shape=list(GAN_TRAIN_SHAPE),
          discriminator=cfg["model"]["discriminator"],
          check_clips=CHECK_CLIPS, check_frames=GAN_STEP_CHECK_FRAMES,
          clip_samples=check_samples, crop_start=start,
          dtype="float32",
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
    if (counts != all_kernels(GAN_TRAIN_LAUNCHES["remat"])
            or (discriminator is None
                and counts_no_remat != all_kernels(GAN_TRAIN_LAUNCHES["no_remat"]))):
        failed.append(f"launches {counts} / {counts_no_remat}, expected {GAN_TRAIN_LAUNCHES}")
    if not finite or moved[0] < n_g or moved[1] < n_d:
        failed.append(f"the optimizer steps moved {moved} of {(n_g, n_d)} parameters, "
                      f"finite {finite}")
    if failed:
        raise AssertionError(f"{label}: " + "; ".join(failed))
    del gan, net, state
    torch.cuda.empty_cache()


@contextlib.contextmanager
def forward_counts(net_cls=None):
    """The network forwards (net_cls.forward calls; NCSNpp's by default) of a run."""
    if net_cls is None:
        from use_tpu_torch.models.ncsnpp.ncsnpp import NCSNpp as net_cls

    n = [0]
    real = net_cls.forward

    def forward(self, *args, **kw):
        n[0] += 1
        return real(self, *args, **kw)

    net_cls.forward = forward
    try:
        yield n
    finally:
        net_cls.forward = real


def eval_phase(torch, dev, experiment, ckpt, per_forward, jl=None, net_cls=None, overrides=()):
    """The CLI's `eval experiment=<experiment>` (phase 15) on EVAL_CLIPS
    synth_speech clips (test losses of every test batch, then the rich
    harness over EVAL_FILES utterances, SGMSE at N=EVAL_N): finite test
    losses, the rich metrics RICH_KEYS (and pesq_wb where the package
    imports), whether figures were drawn, and each kernel's launches
    exactly per_forward times the backbone forwards, which are the test
    batches plus the harness's (EVAL_N a file for SGMSE, one for LSGAN and
    CSMGAN), the forwards of `net_cls` (NCSNpp by default). The loader runs
    in the main process (IN_PROCESS_LOADER); `overrides` go to the CLI as
    they are."""
    from use_tpu_torch import ops
    from use_tpu_torch.cli.main import main as cli_main

    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as tmp:
        jl = jl or write_corpus(os.path.join(tmp, "corpus"), EVAL_CLIPS, TRAIN_CLIP_S)
        argv = ["eval", f"experiment={experiment}", f"data.clean_json_path={jl}",
                f"data.noise_json_path={jl}", "data.reverb_use_FRA=true",
                f"eval.max_files={EVAL_FILES}", f"infer.N={EVAL_N}", IN_PROCESS_LOADER,
                f"out_dir={os.path.join(tmp, 'eval')}", f"device={dev}", *overrides]
        if ckpt:
            argv.append(f"ckpt_path={ckpt}")
        torch.cuda.synchronize(dev)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with train_steps_timed(torch, dev, "sgmse" if experiment.startswith("SGMSE") else "gan"
                               ) as rec, forward_counts(net_cls) as forwards:
            summary = cli_main(argv)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
    harness = summary.get("files", 0) * (EVAL_N if experiment.startswith("SGMSE") else 1)
    want_forwards = rec["eval_steps"] + harness
    want = {k: v * forwards[0] for k, v in all_kernels(per_forward).items()}
    try:
        import pesq  # noqa: F401
        keys = RICH_KEYS | {"pesq_wb"}
    except ImportError:
        keys = RICH_KEYS
    phase("eval", experiment=experiment,
          overrides=list(dict.fromkeys([IN_PROCESS_LOADER, *overrides])), ckpt=bool(ckpt),
          test=summary["test"],
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


def train_gan_phase(torch, dev, experiment, clips, splice_s, crop_s, per_micro, per_forward,
                    predict_args=(), net_cls=None, overrides=(), label=None):
    """`train experiment=<experiment>` (task=lsgan) through the CLI as
    shipped (phase 14 LSGAN: micro 2 x accumulation 16, remat; phase 21
    CSMGAN: micro 4 x accumulation 8), Adam 5e-4 / 2e-4, fp32, 4 loader
    workers, one epoch over `clips` synth_speech clips of TRAIN_CLIP_S
    seconds, items spliced to `splice_s` (a microbatch trains on `crop_s`
    seconds a clip); finite losses, one optimizer step a batch x
    accumulation of clips, a checkpoint holding G and D,
    optimized_metric.json, every kernel launched exactly `per_micro` times
    a microbatch plus `per_forward` times an eval batch; seconds a step and
    a microbatch, trained audio-s/s, the loader's wait, peak memory. Then
    `predict ... ckpt_path=<out_dir>/checkpoints *predict_args` on one 3 s
    clip (`per_forward` launches), and `eval` of that checkpoint
    (eval_phase, counting `net_cls` forwards). `overrides` (phase 27,
    train_lsgan_24k: the discriminator and the depth cut) go to the config
    and to every CLI call, and the run is labelled `label`. -> launches of
    the train run and the eval."""
    from use_tpu_torch import ops
    from use_tpu_torch.cli.main import main as cli_main
    from use_tpu_torch.cli.main import resolve_auto_batch
    from use_tpu_torch.config.config import load_config
    from use_tpu_torch.engine.checkpoint import CheckpointManager

    sr = 24000
    eval_label = f"eval {experiment}" if label is None else f"eval {label}"
    label = label or f"train_{experiment.lower()}"
    cfg = load_config(experiment, overrides)
    resolve_auto_batch(cfg, 1)
    batch = cfg["data"]["batch_size"]
    per_step = batch * cfg["train"]["accumulate_grad_batches"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gan_") as tmp:
        t0 = time.perf_counter()
        jl = write_corpus(os.path.join(tmp, "corpus"), clips, TRAIN_CLIP_S, sr)
        corpus_s = time.perf_counter() - t0
        out = os.path.join(tmp, "run")
        torch.cuda.synchronize(dev)
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        # no profiled step: the trace of a whole step takes the profiler
        # minutes to read back; the microbatch phases profile one
        with train_steps_timed(torch, dev, "gan", profile_step=False) as rec:
            summary = cli_main(["train", f"experiment={experiment}",
                                f"data.clean_json_path={jl}", f"data.noise_json_path={jl}",
                                "data.reverb_use_FRA=true", "train.max_epochs=1",
                                f"data.speech_splice_seconds={splice_s}",
                                f"out_dir={out}", f"device={dev}", *overrides])
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
        step_s = rec["step_s"]
        want = {k: v * micro + all_kernels(per_forward)[k] * rec["eval_steps"]
                for k, v in all_kernels(per_micro).items()}
        phase(label, experiment=experiment, overrides=list(overrides), clips=clips,
              clip_s=TRAIN_CLIP_S, splice_s=splice_s,
              corpus_seconds=round(corpus_s, 2), tf32=bool(torch.backends.cudnn.allow_tf32),
              optimizer_steps=summary["optimizer_steps"], microbatches=micro,
              trained_clips=summary["clips"], eval_batches=rec["eval_steps"],
              history=summary["history"], optimized_metric=record, checkpoints=steps,
              checkpoint_holds=held, fit_seconds=summary["fit_seconds"], wall_seconds=wall,
              step_seconds=step_s, loader_wait_seconds=rec["wait_s"],
              eval_step_seconds=rec["eval_s"],
              s_per_optimizer_step=float(np.mean(step_s)) if step_s else None,
              s_per_microbatch=sum(step_s) / micro if step_s else None,
              trained_audio_s_per_s=(micro * batch * crop_s / sum(step_s) if step_s else None),
              peak_memory_bytes=peak, launches=counts, expected_launches=want)
        losses = [h[k] for h in summary["history"] for k in ("train/loss_G", "train/loss_D")]
        if not (losses and all(np.isfinite(losses)) and np.isfinite(record["value"])):
            raise AssertionError(f"{label}: losses {losses}, optimized metric {record}")
        if summary["optimizer_steps"] != clips // per_step or not steps:
            raise AssertionError(f"{label}: {summary['optimizer_steps']} steps, "
                                 f"checkpoints {steps}")
        if set(held) != {"g", "d"}:
            raise AssertionError(f"{label}: the checkpoint holds {sorted(held)}")
        if counts != want:
            raise AssertionError(f"{label}: launches {counts}, expected {want}")

        src, dst = os.path.join(tmp, "in"), os.path.join(tmp, "out")
        lengths = write_clips(src, (3,), sr)
        ops.reset_launch_counts()
        psum = cli_main(["predict", f"experiment={experiment}", f"ckpt_path={ckpts}",
                         f"predict.data_folder={src}", f"predict.target_folder={dst}",
                         f"device={dev}", *predict_args, *overrides])
        torch.cuda.synchronize(dev)
        pcounts = ops.launch_counts()
        check_outputs(dst, lengths, sr, psum)
        phase("predict", run=f"trained {experiment} checkpoint", experiment=experiment,
              args=list(predict_args), files=psum["files"], audio_seconds=psum["audio_seconds"],
              seconds=psum["seconds"], launches=pcounts)
        if pcounts != all_kernels(per_forward):
            raise AssertionError(f"predict of the trained {experiment}: launches {pcounts}, "
                                 f"expected {per_forward}")
        eval_counts = timed(eval_label, eval_phase, torch, dev, experiment, ckpts,
                            per_forward, None, net_cls, overrides)
    torch.cuda.empty_cache()
    return {label: counts, eval_label: eval_counts}


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
    algorithm choices and the CPU, and end 6 dB apart (PERF.md). The SGMSE
    gate's run (phase 12, `learn_check`) runs beside them in the same pool."""
    import multiprocessing

    from use_tpu_torch.tools import learn_gate

    with multiprocessing.get_context("spawn").Pool(len(LEARN_LSGAN_RUNS) + 1) as pool:
        sgmse = pool.apply_async(_learn_worker, (str(dev),))
        runs = pool.starmap(_gan_learn_worker, [(det, str(dev)) for det in LEARN_LSGAN_RUNS])
        learn_check(sgmse.get())
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


def int8conv_phases(torch, dev):
    """Phases 22-25; -> {"int8conv_bfloat16": launches by kernel} of the
    int8conv predict run."""
    timed("int8conv_forward", int8conv_forward_phase, torch, dev)
    timed("ddpm_forward", ddpm_forward_phase, torch, dev)
    runs = {"int8conv_bfloat16": timed("predict int8conv_bfloat16", predict_phase, torch, dev,
                                       "int8conv_bfloat16", INT8CONV_PREDICT_ARGS)}
    timed("npz_predict", npz_predict_phase, torch, dev)
    return runs


def csmgan_phases(torch, dev):
    """Phases 17-21; -> {run label: launches by kernel} of their CLI runs."""
    timed("csmgan_forward", csmgan_forward_phase, torch, dev)
    timed("csmgan_stream", csmgan_stream_phase, torch, dev)
    runs = timed("predict csmgan", csmgan_predict_phase, torch, dev)
    timed("csmgan_train_step", csmgan_train_step_phase, torch, dev)
    from use_tpu_torch.models.gan.csmgan import CSMGAN

    # CSMGAN trains crop-free: a microbatch trains on the whole 6 s items
    runs.update(timed("train_csmgan", train_gan_phase, torch, dev, CSMGAN_EXPERIMENT,
                      CSMGAN_TRAIN_CLIPS, CSMGAN_CLIP_S, CSMGAN_CLIP_S, NO_LAUNCHES,
                      NO_LAUNCHES, ("predict.streaming=true",), CSMGAN, CSMGAN_TRAIN_ARGS))
    return runs


def _csmgan(torch, device):
    """The CSMGAN generator as `experiment=CSMGAN` builds it (full width,
    weights from train.seed), on the CPU and on `device`, the same weights."""
    from use_tpu_torch.config.config import load_config
    from use_tpu_torch.models.gan.csmgan import CSMGANWrapper

    cfg = load_config(CSMGAN_EXPERIMENT)
    gcfg = {k: v for k, v in cfg["model"]["generator"].items() if k != "name"}
    seed = int(cfg["train"]["seed"])
    cpu = CSMGANWrapper(**gcfg, device="cpu", seed=seed)
    card = CSMGANWrapper(**gcfg, device=device, seed=seed)
    card.net.load_state_dict(cpu.net.state_dict())
    return cpu, card


def _csmgan_pairs(batch, secs=None, sr=24000):
    """`batch` synth_speech clips of `secs` seconds (CSMGAN_CLIP_S) and
    their noisy versions (5 dB SNR): -> (clean, noisy), each [B, L] float32."""
    from use_tpu_torch.data.synth_speech import synth_pair

    n = int((secs or CSMGAN_CLIP_S) * sr)
    pairs = [synth_pair(n, 40 + i, snr_db=5.0, sr=sr) for i in range(batch)]
    return tuple(np.stack([p[j] for p in pairs]).astype(np.float32) for j in (0, 1))


def _csmgan_clips(batch, secs=None, sr=24000):
    """`batch` noisy synth_speech clips of `secs` seconds, [B, L]."""
    return _csmgan_pairs(batch, secs, sr)[1]


def _kernel_events(torch, prof):
    """The profiler's CUDA kernels (no memcpy / memset): -> (count, ms)."""
    from torch.autograd import DeviceType

    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
          and not e.name.startswith(("Memcpy", "Memset"))]
    return len(ev), sum(e.time_range.end - e.time_range.start for e in ev) / 1e3


def _rel(a, b):
    """max|a - b| / max|b|, both moved to the CPU."""
    a, b = a.float().cpu(), b.float().cpu()
    return float((a - b).abs().max()) / float(b.abs().max())


def csmgan_forward_phase(torch, dev):
    """Phase 17: the offline forward (STFT, net, iSTFT) of the shipped
    CSMGAN on CSMGAN_BATCHES x a 6 s clip, the card against the CPU on the
    same weights within CSMGAN_REL_TOL x max|ref|; ms a forward (median of
    10, CUDA events), audio-s/s, peak memory; one profiled forward's CUDA
    kernels and their time; the arithmetic of a forward (convolutions and
    matmuls, torch.utils.flop_counter; the FFTs are not counted); K1, K2
    and K3 not launched."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    from use_tpu_torch import ops

    cpu, card = _csmgan(torch, dev)
    params = sum(p.numel() for p in card.net.parameters())
    failed = []
    for batch in CSMGAN_BATCHES:
        wav = torch.from_numpy(_csmgan_clips(batch))
        t0 = time.perf_counter()
        ref = cpu.forward_infer({"perturbed": wav})["fake"]
        cpu_s = time.perf_counter() - t0
        x = {"perturbed": wav.to(dev)}
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        out = card.forward_infer(x)["fake"]
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        counts = ops.launch_counts()
        err = float((out.cpu() - ref).abs().max())
        top = float(ref.abs().max())
        ms = time_ms(torch, lambda: card.forward_infer(x), reps=10, warmup=2)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            card.forward_infer(x)
            torch.cuda.synchronize(dev)
        kernels, kernel_ms = _kernel_events(torch, prof)
        with FlopCounterMode(display=False) as counter:
            card.forward_infer(x)
        gflop = counter.get_total_flops() / 1e9
        phase("csmgan_forward", experiment=CSMGAN_EXPERIMENT, params=params, batch=batch,
              clip_s=CSMGAN_CLIP_S, frames=int(ref.shape[-1]) // card.feature.hop_length + 1,
              dtype="float32", tf32=bool(torch.backends.cudnn.allow_tf32), max_abs_err=err,
              max_abs_ref=top, tol=CSMGAN_REL_TOL * top, ms=ms,
              audio_s_per_s=batch * CSMGAN_CLIP_S / (ms / 1e3), peak_memory_bytes=peak,
              kernels_per_forward=kernels, kernel_ms=kernel_ms, gflop=gflop,
              gflop_per_audio_s=gflop / (batch * CSMGAN_CLIP_S), cpu_seconds=round(cpu_s, 2),
              launches=counts)
        if not (torch.isfinite(out).all() and err <= CSMGAN_REL_TOL * top):
            failed.append(f"batch {batch}: card vs CPU max_abs_err {err} > "
                          f"{CSMGAN_REL_TOL} x {top}")
        if counts != all_kernels(NO_LAUNCHES):
            failed.append(f"batch {batch}: launches {counts}")
    if failed:
        raise AssertionError("csmgan_forward: " + "; ".join(failed))
    del cpu, card
    torch.cuda.empty_cache()


def csmgan_stream_phase(torch, dev):
    """Phase 18: CSMGANStream of the shipped CSMGAN at STREAM_CHUNK_FRAMES,
    batch 1. A session on the card streams STREAM_WARMUP + STREAM_CHUNKS
    chunks of a clip, each step timed to a synchronize, then one profiled
    step (its CUDA kernels and their time), then the flush: the whole output
    against the card's offline pass of the clip, and its first
    STREAM_CPU_CHUNKS chunks against the CPU's stream of them (the stream is
    causal), within STREAM_REL_TOL of max|ref|. Latency p50 / p99 over the
    STREAM_CHUNKS steps after STREAM_WARMUP; the real-time factor (p50 chunk
    seconds over the chunk's audio seconds); the algorithmic latency (chunk
    + one hop)."""
    from torch.profiler import ProfilerActivity, profile

    from use_tpu_torch import ops
    from use_tpu_torch.models.gan.csmgan import CSMGANStream

    sr = 24000
    cpu, card = _csmgan(torch, dev)
    hop = card.feature.hop_length
    n = STREAM_WARMUP + STREAM_CHUNKS + 1  # the last step profiled
    long_wav = torch.from_numpy(_csmgan_clips(1, secs=n * max(STREAM_CHUNK_FRAMES) * hop / sr))
    failed = []
    for k in STREAM_CHUNK_FRAMES:
        cs = k * hop
        clip = long_wav[:, : n * cs]
        chunks = clip.to(dev).split(cs, dim=1)
        sess = CSMGANStream(card, batch_size=1, chunk_frames=k)
        times, parts = [], []
        ops.reset_launch_counts()
        with torch.inference_mode():
            for chunk in chunks[:-1]:
                t0 = time.perf_counter()
                parts.append(sess.step(chunk))
                torch.cuda.synchronize(dev)
                times.append(time.perf_counter() - t0)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                parts.append(sess.step(chunks[-1]))
                torch.cuda.synchronize(dev)
                profiled_s = time.perf_counter() - t0
            parts.append(sess.flush())
        torch.cuda.synchronize(dev)
        counts = ops.launch_counts()
        stream = torch.cat(parts, dim=1)
        offline = card.forward_infer({"perturbed": clip.to(dev)})["fake"]
        cpu_sess = CSMGANStream(cpu, batch_size=1, chunk_frames=k)
        t0 = time.perf_counter()
        cpu_parts = [cpu_sess.step(c) for c in clip.split(cs, dim=1)[:STREAM_CPU_CHUNKS]]
        cpu_s = time.perf_counter() - t0
        head = torch.cat(cpu_parts, dim=1)
        err_offline = _rel(stream, offline)
        err_cpu = _rel(stream[:, : head.shape[1]], head)
        kernels, kernel_ms = _kernel_events(torch, prof)
        top = sorted(((e.key, e.count, getattr(e, "self_device_time_total",
                                                 getattr(e, "self_cuda_time_total", 0)) / 1e3)
                      for e in prof.key_averages()), key=lambda r: -r[2])[:6]
        lat = np.array(times[STREAM_WARMUP:]) * 1e3
        p50, p99 = float(np.percentile(lat, 50)), float(np.percentile(lat, 99))
        chunk_ms = cs / sr * 1e3
        phase("csmgan_stream", chunk_frames=k, chunk_ms=chunk_ms,
              algorithmic_latency_ms=(k + 1) * hop / sr * 1e3, clip_s=clip.shape[1] / sr,
              rel_err_vs_offline=err_offline, rel_err_vs_cpu=err_cpu, tol=STREAM_REL_TOL,
              cpu_chunks=len(cpu_parts), cpu_seconds=round(cpu_s, 2), latency_chunks=len(lat),
              p50_ms=p50, p99_ms=p99, mean_ms=float(lat.mean()), max_ms=float(lat.max()),
              rtf=p50 / chunk_ms, profiled_wall_ms=profiled_s * 1e3, kernels_per_chunk=kernels,
              kernel_ms_per_chunk=kernel_ms, top_device_ops_ms=top, launches=counts)
        if not (stream.shape == offline.shape and torch.isfinite(stream).all()
                and err_offline <= STREAM_REL_TOL and err_cpu <= STREAM_REL_TOL):
            failed.append(f"chunk_frames {k}: stream vs offline {err_offline}, vs CPU {err_cpu} "
                          f"(tol {STREAM_REL_TOL})")
        if counts != all_kernels(NO_LAUNCHES):
            failed.append(f"chunk_frames {k}: launches {counts}")
    if failed:
        raise AssertionError("csmgan_stream: " + "; ".join(failed))
    del cpu, card
    torch.cuda.empty_cache()


def csmgan_predict_phase(torch, dev):
    """Phase 19: `predict experiment=CSMGAN` on the 3 s and 6 s clips,
    streaming at chunk_frames 2 and offline: outputs checked, K1, K2 and K3
    launched 0 times, audio-s/s and peak memory. -> launches by run."""
    from use_tpu_torch import ops
    from use_tpu_torch.cli.main import main as cli_main

    sr = 24000
    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_csmgan_") as tmp:
        src = os.path.join(tmp, "in")
        lengths = write_clips(src, PREDICT_CLIPS_S, sr)
        for label, extra in (("predict csmgan", ("predict.streaming=true",
                                                 "predict.chunk_frames=2")),
                             ("predict csmgan offline", ())):
            dst = os.path.join(tmp, label.replace(" ", "_"))
            ops.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            summary = cli_main(["predict", f"experiment={CSMGAN_EXPERIMENT}",
                                f"predict.data_folder={src}", f"predict.target_folder={dst}",
                                f"device={dev}", *extra])
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
            counts = ops.launch_counts()
            check_outputs(dst, lengths, sr, summary)
            phase("predict", run=label, experiment=CSMGAN_EXPERIMENT, args=list(extra),
                  clips_s=list(PREDICT_CLIPS_S), files=summary["files"],
                  audio_seconds=summary["audio_seconds"], sampling_seconds=summary["seconds"],
                  wall_seconds=wall, audio_s_per_s=summary["audio_seconds"] / summary["seconds"],
                  peak_memory_bytes=torch.cuda.max_memory_allocated(dev), launches=counts)
            if counts != all_kernels(NO_LAUNCHES):
                raise AssertionError(f"{label}: launches {counts}")
            runs[label] = counts
    return runs


def _csmgan_gan(torch, device):
    """The CSMGAN recipe as the CLI builds it (the csmgan generator, the
    24k_MVD bank, the shipped criterion), weights from train.seed."""
    from use_tpu_torch.cli.main import _build_model
    from use_tpu_torch.config.config import load_config

    cfg = load_config(CSMGAN_EXPERIMENT)
    return _gan_to(torch, _build_model(cfg, "cpu"), device), cfg


@contextlib.contextmanager
def prelu_branches(torch, replay=None):
    """Each PReLU (F.prelu: the generator's TCN), in call order, as
    lrelu_branches: record its branch (x > 0, torch's own for the
    gradient) as a CPU mask, or, given `replay`, take the recorded branch.
    -> {"masks", "flips", "elements"}."""
    import torch.nn.functional as F

    real = F.prelu
    rec = {"masks": [], "flips": 0, "elements": 0}
    branches = None if replay is None else iter(replay)

    def prelu(x, weight):
        if branches is None:
            rec["masks"].append((x > 0).cpu())
            return real(x, weight)
        mask = next(branches).to(x.device)
        rec["flips"] += int((mask != (x > 0)).sum())
        rec["elements"] += mask.numel()
        return torch.where(mask, x, weight * x)

    F.prelu = prelu
    try:
        yield rec
    finally:
        F.prelu = real


@contextlib.contextmanager
def mel_inputs(torch, replay=None):
    """Each mel spectrogram the discriminator's mel bank takes, in call
    order: record it (a CPU copy), or, given `replay`, take the recorded
    values with this device's gradient (m + (recorded - m), the difference
    detached). A near-null mel bin holds the DFT's rounding, whose value
    log(mel + 1e-5) reads. -> {"mels"}."""
    from use_tpu_torch.models.gan import discriminators as disc

    real = disc.melspectrogram
    rec = {"mels": []}
    recorded = None if replay is None else iter(replay)

    def melspectrogram(x, cfg):
        m = real(x, cfg)
        if recorded is None:
            rec["mels"].append(m.detach().cpu())
            return m
        return m + (next(recorded).to(m.device) - m).detach()

    disc.melspectrogram = melspectrogram
    try:
        yield rec
    finally:
        disc.melspectrogram = real


def _csmgan_microbatch(torch, gan, batch, d_fake=None, prelu_replay=None):
    """The D phase (on `d_fake` where given, else on G's fake made without
    autograd) and the G phase (against the same D; its PReLUs inside
    prelu_branches with `prelu_replay`), as _gan_microbatch; -> (loss_D,
    logs of the G phase, seconds, the D phase's fake, the G phase's fake,
    the G phase's PReLU record) after a synchronize, the gradients left in
    .grad."""
    dev = gan.device
    mb = {k: v.to(dev) for k, v in batch.items()}
    gan.discriminator.zero_grad(set_to_none=True)
    gan.generator.net.zero_grad(set_to_none=True)
    t0 = time.perf_counter()
    with torch.no_grad():
        fake = gan.g_forward(mb) if d_fake is None else {**mb, "fake": d_fake.to(dev)}
    loss_d = gan.d_loss(fake)
    loss_d.backward()
    d_params = list(gan.discriminator.parameters())
    for p in d_params:
        p.requires_grad_(False)
    try:
        with prelu_branches(torch, prelu_replay) as prelus:
            out = gan.g_forward(mb)
        loss_g, logs = gan.g_loss(out)
        loss_g.backward()
    finally:
        for p in d_params:
            p.requires_grad_(True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return (loss_d.detach(), {k: float(v.detach()) for k, v in logs.items()},
            time.perf_counter() - t0, fake["fake"].detach(), out["fake"].detach(), prelus)


def csmgan_train_step_phase(torch, dev):
    """Phase 20: one microbatch of the CSMGAN recipe (the data's batch of
    whole 6 s clips: CSMGAN trains crop-free), its D phase and its G phase
    (against the same D) on the card and on the CPU on the same weights and
    CHECK_CLIPS of the batch's clips (the timings run the whole batch). The
    CPU computes the function the card computed wherever the
    card's rounding picks one: each leaky ReLU of D and PReLU of G takes the
    card's branch (lrelu_branches, prelu_branches: a flipped input's term
    jumps by 0.9 / 0.99), D's phase runs on the card's fake, and D's mel
    bank reads the card's mel spectrograms (mel_inputs). CSMGAN leaves its
    top (Nyquist) bin empty, so its fakes have almost no energy near 12
    kHz, where a bin holds the DFT's rounding: log(mel + 1e-5) in D, and
    the criterion's two log terms (log(32768 |X| + 1e-6), the log mel),
    read it (PERF.md: D's mel convs 2.4e-3 of their largest between card
    and CPU, the log terms' gradient 0.52). So the gradients compared are
    those of the criterion without the two log terms: every D and G
    gradient within TRAIN_GRAD_REL_TOL of its tensor's largest, and the
    same microbatch with TF32 on off by more; the losses within 1e-4, the
    log terms' values on each device's G-phase fake within 1e-3. Then gan_train_step with the shipped criterion and both Adam
    steps: finite, moved weights, no K1/K2/K3 launch, seconds a microbatch
    (median of 3), one profiled step's busy share, peak device memory."""
    from torch.profiler import ProfilerActivity, profile

    from use_tpu_torch.engine.loop import build_gan_train_state
    from use_tpu_torch.models.gan import losses

    cpu, cfg = _csmgan_gan(torch, "cpu")
    shipped = cpu.g_loss_cfg
    clips = int(cfg["data"]["batch_size"])
    clean, noisy = _csmgan_pairs(clips)
    batch = {"clean": torch.from_numpy(clean), "perturbed": torch.from_numpy(noisy)}
    check = {k: v[:CHECK_CLIPS] for k, v in batch.items()}
    gan = _gan_to(torch, copy.deepcopy(cpu), dev)
    cpu.g_loss_cfg = gan.g_loss_cfg = dataclasses.replace(shipped, alpha_mag_log=0.0,
                                                          alpha_mel_log=0.0)
    torch.cuda.reset_peak_memory_stats(dev)
    with lrelu_branches(torch) as card, mel_inputs(torch) as mels:
        loss_d, logs, first_s, d_fake, g_fake, prelus = _csmgan_microbatch(torch, gan, check)
    grads = _cpu_grads(gan)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with lrelu_branches(torch, card["masks"]), mel_inputs(torch, mels["mels"]):
            _csmgan_microbatch(torch, gan, check, d_fake, prelus["masks"])
    finally:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    grads_tf32 = _cpu_grads(gan)
    with lrelu_branches(torch, card["masks"]) as branches, mel_inputs(torch, mels["mels"]):
        loss_d_cpu, logs_cpu, cpu_s, _, g_fake_cpu, prelus_cpu = _csmgan_microbatch(
            torch, cpu, check, d_fake.cpu(), prelus["masks"])
    grads_cpu = _cpu_grads(cpu)
    del cpu, card, mels
    rel, _ = _gan_grad_errors(grads, grads_cpu, set())
    worst = max(rel, key=rel.get)
    worst_g = max((k for k in rel if k.startswith("G.")), key=rel.get)
    worst_d = max((k for k in rel if k.startswith("D.")), key=rel.get)
    loss_errs = {"loss_D": abs(float(loss_d) - float(loss_d_cpu)) / abs(float(loss_d_cpu)),
                 **{k: abs(v - logs_cpu[k]) / max(abs(logs_cpu[k]), 1e-30)
                    for k, v in logs.items() if logs_cpu[k] != 0.0}}
    log_terms = {}
    for name, fake, cl in (("card", g_fake, check["clean"].to(dev)),
                           ("cpu", g_fake_cpu, check["clean"])):
        with torch.no_grad():
            terms = losses.wav_spec_convergence(cl, fake, shipped)
        log_terms[name] = {k: float(terms[k]) for k in ("mag_log", "mel_log")}
    log_errs = {k: abs(log_terms["card"][k] - log_terms["cpu"][k]) / abs(log_terms["cpu"][k])
                for k in ("mag_log", "mel_log")}
    rel_tf32, _ = _gan_grad_errors(grads_tf32, grads_cpu, set())
    worst_tf32 = max(rel_tf32, key=rel_tf32.get)
    del grads, grads_tf32, grads_cpu

    gan.g_loss_cfg = shipped
    t = cfg["train"]
    state = build_gan_train_state(gan, t["g_lr"], t["d_lr"], t["weight_decay"])
    before = {k: p.detach().clone() for k, p in gan.generator.net.named_parameters()}
    torch.cuda.reset_peak_memory_stats(dev)
    counts, step_s = _gan_step_launches(torch, gan, state, batch, 0)
    peak = torch.cuda.max_memory_allocated(dev)
    moved = sum(int(not torch.equal(before[k], p)) for k, p in gan.generator.net.named_parameters())
    finite = all(bool(torch.isfinite(p).all()) for p in list(gan.generator.net.parameters())
                 + list(gan.discriminator.parameters()))
    del before
    times = [step_s] + [_gan_step_launches(torch, gan, state, batch, 0)[1] for _ in range(2)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall = _gan_step_launches(torch, gan, state, batch, 0)[1]
    kernel_s, busy_s, busy = kernel_busy(prof, wall)
    n_g = len(list(gan.generator.net.parameters()))
    phase("csmgan_train_step", experiment=CSMGAN_EXPERIMENT, clips=clips,
          check_clips=CHECK_CLIPS,
          clip_samples=int(clean.shape[-1]), dtype="float32",
          tf32=bool(torch.backends.cudnn.allow_tf32), criterion="shipped without mag_log, mel_log",
          loss_D=float(loss_d), loss_D_cpu=float(loss_d_cpu), logs=logs, logs_cpu=logs_cpu,
          loss_rel_errs=loss_errs, log_terms=log_terms, log_term_rel_errs=log_errs,
          grad_tol=TRAIN_GRAD_REL_TOL, max_grad_rel_err=rel[worst], worst_grad=worst,
          median_grad_rel_err=float(np.median(list(rel.values()))), grads_checked=len(rel),
          worst_grads=dict(sorted(rel.items(), key=lambda kv: -kv[1])[:8]),
          worst_generator_grad=worst_g, max_generator_grad_rel_err=rel[worst_g],
          worst_discriminator_grad=worst_d, max_discriminator_grad_rel_err=rel[worst_d],
          lrelu_flips=branches["flips"], lrelu_elements=branches["elements"],
          prelu_flips=prelus_cpu["flips"], prelu_elements=prelus_cpu["elements"],
          control="TF32 on", control_max_grad_rel_err=rel_tf32[worst_tf32],
          control_worst_grad=worst_tf32,
          control_median_grad_rel_err=float(np.median(list(rel_tf32.values()))),
          cpu_seconds=round(cpu_s, 2), phases_first_s=first_s, params_moved_G=moved,
          params_G=n_g, finite=finite, launches=counts, microbatch_s=float(np.median(times)),
          microbatch_s_all=times, trained_audio_s_per_s=clips * CSMGAN_CLIP_S / np.median(times),
          profiled_step={"wall_s": wall, "kernel_s": kernel_s, "kernel_union_s": busy_s,
                         "busy_share": busy},
          peak_memory_bytes=peak)
    failed = []
    for k, e in loss_errs.items():
        if not e <= 1e-4:
            failed.append(f"{k} card vs CPU off by {e} (tol 1e-4)")
    for k, e in log_errs.items():
        if not e <= 1e-3:
            failed.append(f"{k} card vs CPU off by {e} (tol 1e-3)")
    if not rel[worst] <= TRAIN_GRAD_REL_TOL:
        failed.append(f"gradient {worst} off by {rel[worst]} of its largest value (tol "
                      f"{TRAIN_GRAD_REL_TOL})")
    if not rel_tf32[worst_tf32] > TRAIN_GRAD_REL_TOL:
        failed.append(f"the TF32 control passes ({rel_tf32[worst_tf32]} <= {TRAIN_GRAD_REL_TOL})")
    if counts != all_kernels(NO_LAUNCHES):
        failed.append(f"launches {counts}")
    # the last TCN block's res_out reaches no output: no gradient, not moved
    if not finite or moved < n_g - 2:
        failed.append(f"the optimizer step moved {moved} of {n_g} G parameters, finite {finite}")
    if failed:
        raise AssertionError("csmgan_train_step: " + "; ".join(failed))
    del gan, state
    torch.cuda.empty_cache()


def zoo_phases(torch, dev):
    """Phases 26-28; -> {run label: launches by kernel} of train_lsgan_24k
    and its eval."""
    timed("gan24k_train_step", gan_train_step_phase, torch, dev, GAN24K_DISCRIMINATOR)
    runs = timed("train_lsgan_24k", train_gan_phase, torch, dev, GAN_EXPERIMENT,
                 GAN24K_TRAIN_CLIPS, GAN_SPLICE_S, GAN_CROP_S, GAN_TRAIN_LAUNCHES["remat"],
                 PER_GENERATOR_FORWARD, (), None, GAN24K_OVERRIDES, "train_lsgan_24k")
    timed("zoo_forward", zoo_forward_phase, torch, dev)
    return runs


def _flat(torch, out):
    """The tensors of a nested output (tensors, lists, tuples), in order."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _flat(torch, o)]


def _zoo_case(torch, dev, name, cpu_fn, card_fn, lanes=None):
    """card_fn(), then cpu_fn(), without autograd: every tensor of the
    card's output against the CPU's (on the first `lanes` of the card's
    batch, where the CPU computes those only), each relative to its own
    max|ref|; ms a card call (median of 5), peak memory, launches. ->
    (record, card output, CPU output)."""
    from use_tpu_torch import ops

    with torch.no_grad():
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        out = card_fn()
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        counts = ops.launch_counts()
        t0 = time.perf_counter()
        ref = cpu_fn()
        cpu_s = time.perf_counter() - t0
        ms = time_ms(torch, card_fn, reps=5, warmup=1)
    got, want = _flat(torch, out), _flat(torch, ref)
    if lanes is not None:
        got = [g[:lanes] for g in got]
    errs = [_rel(g, w) for g, w in zip(got, want)]
    rec = {"case": name, "tensors": len(want), "max_rel_err": max(errs),
           "worst_tensor": int(np.argmax(errs)),
           "shapes_equal": len(got) == len(want) and all(
               tuple(g.shape) == tuple(w.shape) for g, w in zip(got, want)),
           "finite": all(bool(torch.isfinite(g).all()) for g in got),
           "ms": ms, "cpu_seconds": round(cpu_s, 2), "peak_memory_bytes": peak,
           "launches": counts}
    return rec, out, ref


def zoo_forward_phase(torch, dev):
    """Phase 28: the GAN zoo's modules at their default widths, fp32, TF32
    off, seeded weights, the card against the CPU on the same weights and
    inputs: HifiganGenerator (512 channels, x8 x8 x2 x2) on ZOO_MELS-bin
    frames for ZOO_CLIP_S s of 24 kHz audio, NSF off and on (ZOO_NSF; the
    card draws the source, the CPU takes the card's draws);
    BandwidthExtender on a ZOO_CLIP_S s clip at ZOO_BWE_RATE;
    MultiScaleDiscriminator, MultiSpecDiscriminator and the 24k bank on
    ZOO_D_SHAPE synth_speech crops (the bank on the noisy and the clean
    crop, the CPU on the card's mel inputs); then lsgan_g_loss,
    lsgan_d_loss and content_criteria on the
    bank's logits and the crops, each device on its own. Every output,
    logit, feature map and loss within ZOO_REL_TOL x its max|ref|; ms a
    call, peak memory; K1, K2 and K3 launched no time."""
    from use_tpu_torch.data.synth_speech import synth_pair
    from use_tpu_torch.models.gan import losses
    from use_tpu_torch.models.gan.discriminators import reset_parameters
    from use_tpu_torch.models.gan.hifigan_bwe import BandwidthExtender
    from use_tpu_torch.models.gan.hifigan_vocoder import HifiganGenerator
    from use_tpu_torch.models.gan.msd import MultiScaleDiscriminator
    from use_tpu_torch.models.gan.spec_discriminator import MultiSpecDiscriminator
    from use_tpu_torch.models.registry import DiscriminatorRegistry

    rng = np.random.default_rng(0)
    frames = -(-ZOO_CLIP_S * 24000 // ZOO_HOP)
    mel = rng.standard_normal((1, ZOO_MELS, frames)).astype(np.float32)
    f0 = rng.uniform(80.0, 300.0, (1, 1, frames)).astype(np.float32)
    voiced = (rng.uniform(size=(1, 1, frames)) > 0.3).astype(np.float32)
    records = []

    def case(name, module, fn, *inputs):
        """`module` seeded on the CPU and copied to the card; fn(module, *inputs)."""
        card = copy.deepcopy(module).to(dev)
        on_card = [x.to(dev) if isinstance(x, torch.Tensor) else x for x in inputs]
        rec, out, ref = _zoo_case(torch, dev, name, lambda: fn(module, *inputs),
                                  lambda: fn(card, *on_card))
        records.append(rec)
        del card
        return out, ref

    for nsf in (None, ZOO_NSF):
        gen = HifiganGenerator(nsf_params=nsf, seed=1)
        x = torch.from_numpy(mel if nsf is None else np.concatenate([mel, f0, voiced], 1))
        if nsf is None:
            case("hifigan_generator", gen, lambda m, x: m(x), x)
        else:
            draws = gen.source_module.draw(1, frames * ZOO_HOP, dev,
                                           torch.Generator(device=dev).manual_seed(2))
            cpu_draws = tuple(d.cpu() for d in draws)
            card = copy.deepcopy(gen).to(dev)
            rec, _, _ = _zoo_case(torch, dev, "hifigan_generator nsf",
                                  lambda: gen(x, source_draws=cpu_draws),
                                  lambda: card(x.to(dev), source_draws=draws))
            records.append(rec)
            del card
        del gen
    n = ZOO_CLIP_S * ZOO_BWE_RATE
    low = torch.from_numpy(synth_pair(n, 50, snr_db=20.0, sr=ZOO_BWE_RATE)[1][None])
    case("hifigan_bwe", BandwidthExtender(seed=3), lambda m, x: m(x, ZOO_BWE_RATE), low)
    pairs = [synth_pair(ZOO_D_SHAPE[1], 60 + i, snr_db=5.0) for i in range(ZOO_D_SHAPE[0])]
    clean, fake = (torch.from_numpy(np.stack([p[j] for p in pairs])) for j in (0, 1))
    for name, module in (("multi_scale_discriminator", MultiScaleDiscriminator()),
                         ("multi_spec_discriminator", MultiSpecDiscriminator())):
        reset_parameters(module, torch.Generator().manual_seed(4))
        case(name, module, lambda m, x: m(x), fake)
    # the bank on the noisy and on the clean crop, whose digital silence
    # gives mel bins of the DFTs' rounding, which log(mel + 1e-5) reads: the
    # CPU takes the card's mel inputs (mel_inputs, as phase 20)
    bank = DiscriminatorRegistry.get_by_name(GAN24K_DISCRIMINATOR)(seed=5)
    card_bank = copy.deepcopy(bank).to(dev)
    mels = []

    def on_card():
        if mels:
            return card_bank(fake.to(dev)), card_bank(clean.to(dev))
        with mel_inputs(torch) as rec:
            out = card_bank(fake.to(dev)), card_bank(clean.to(dev))
        mels.extend(rec["mels"])
        return out

    def on_cpu():
        with mel_inputs(torch, mels):
            return bank(fake), bank(clean)

    rec, out, ref = _zoo_case(torch, dev, GAN24K_DISCRIMINATOR, on_cpu, on_card)
    records.append(rec)
    del bank, card_bank

    def criteria(bank_out, f, c):
        (lg_f, _), (lg_r, _) = bank_out
        batch = {"predicted_fake_logits": lg_f, "predicted_clean_logits": lg_r}
        return (losses.lsgan_g_loss(batch)["loss_G"], losses.lsgan_d_loss(batch)["loss_D"],
                *losses.content_criteria(f, c, 24000))

    with torch.no_grad():
        got = criteria(out, fake.to(dev), clean.to(dev))
        want = criteria(ref, fake, clean)
    names = ("lsgan_g_loss", "lsgan_d_loss", "content_wav", "content_stft", "content_mel")
    loss_errs = {k: _rel(g.reshape(1), w.reshape(1)) for k, g, w in zip(names, got, want)}
    loss_values = {k: float(w) for k, w in zip(names, want)}
    phase("zoo_forward", dtype="float32", tf32=bool(torch.backends.cudnn.allow_tf32),
          tol=ZOO_REL_TOL, clip_s=ZOO_CLIP_S, mel_frames=frames, bwe_rate=ZOO_BWE_RATE,
          d_shape=list(ZOO_D_SHAPE), cases=records, loss_rel_errs=loss_errs,
          losses=loss_values)
    failed = [f"{r['case']}: {r}" for r in records
              if not (r["shapes_equal"] and r["finite"] and r["max_rel_err"] <= ZOO_REL_TOL
                      and r["launches"] == all_kernels(NO_LAUNCHES))]
    failed += [f"{k} off by {e}" for k, e in loss_errs.items() if not e <= ZOO_REL_TOL]
    if failed:
        raise AssertionError("zoo_forward: " + "; ".join(failed))
    torch.cuda.empty_cache()



def models_phases(torch, dev):
    """Phases 29-31; -> {"legacy_regen": the regeneration's launches by kernel}."""
    timed("alt_backbones_forward", alt_backbones_forward_phase, torch, dev)
    runs = {"legacy_regen": timed("legacy_models", legacy_models_phase, torch, dev)}
    timed("legacy_layers_forward", legacy_layers_forward_phase, torch, dev)
    return runs


def alt_backbones_forward_phase(torch, dev):
    """Phase 29: GaGNet (the U^2 encoder, causal, default widths) on
    GAGNET_SHAPE spectra and ConvTasNet (default widths, gLN and causal) on
    TASNET_SHAPE waveforms at TASNET_FS, seeded weights, fp32, TF32 off:
    the card against the CPU on ALT_CHECK_LANES of the lanes within
    ZOO_REL_TOL x max|ref|; ms a call (median of 5), peak memory,
    parameters; K1, K2 and K3 launched no time."""
    from use_tpu_torch.models import BackboneRegistry

    x = torch.from_numpy(
        (0.5 * np.random.default_rng(0).standard_normal(GAGNET_SHAPE)).astype(np.float32))
    wav = torch.from_numpy(
        (0.3 * np.random.default_rng(1).standard_normal(TASNET_SHAPE)).astype(np.float32))
    gagnet = BackboneRegistry.get_by_name("gagnet")(seed=1)
    gagnet.materialize(GAGNET_SHAPE[1] + 1)  # 512 bins, padded to 513
    cases = [("gagnet", gagnet, x),
             ("convtasnet", BackboneRegistry.get_by_name("convtasnet")(fs=TASNET_FS, seed=2), wav),
             ("convtasnet causal",
              BackboneRegistry.get_by_name("convtasnet")(fs=TASNET_FS, causal=True, seed=3), wav)]
    records = []
    for name, net, inp in cases:
        card, on_card = copy.deepcopy(net).to(dev), inp.to(dev)
        check = inp[:ALT_CHECK_LANES].contiguous()
        rec, _, _ = _zoo_case(torch, dev, name, lambda: net(check), lambda: card(on_card),
                              lanes=ALT_CHECK_LANES)
        rec["parameters"] = sum(p.numel() for p in net.parameters())
        rec["shape"] = list(inp.shape)
        records.append(rec)
        del card, on_card
    phase("alt_backbones_forward", dtype="float32", tf32=bool(torch.backends.cudnn.allow_tf32),
          tol=ZOO_REL_TOL, check_lanes=ALT_CHECK_LANES, cases=records)
    failed = [f"{r['case']}: {r}" for r in records
              if not (r["shapes_equal"] and r["finite"] and r["max_rel_err"] <= ZOO_REL_TOL
                      and r["launches"] == all_kernels(NO_LAUNCHES))]
    if failed:
        raise AssertionError("alt_backbones_forward: " + "; ".join(failed))
    torch.cuda.empty_cache()


def _legacy_clip(torch, dev, secs, seed=0):
    from use_tpu_torch.data.synth_speech import synth_pair

    return torch.from_numpy(synth_pair(secs * 24000, seed, snr_db=5.0)[1][None]).to(dev)


def legacy_models_phase(torch, dev):
    """Phase 30: the legacy family at the shipped widths on the card, fp32.
    StochasticRegenerationModel with the LSGAN generator as experiment=LSGAN
    builds it and SGMSE_Large's score model with condition='both',
    sde_input='denoised' (both seeded unit-scale random): enhance of a
    LEGACY_CLIP_S s clip at N=CHAIN_N against the gan+sgmse chain's
    computation (LSGAN.enhance, then ScoreModel.sample of its 'fake') on the
    same weights and the same generator seed, within LEGACY_CHAIN_TOL x
    max|ref|; its launches exactly LEGACY_REGEN_LAUNCHES, its audio-s/s
    (the enhance call, after one untimed) and peak memory.
    LegacyScoreModel.enhance(timeit=True) at SGMSE_Large, N=CHAIN_N: nfe N,
    rtf > 0, x_hat that of ScoreModel.sample with the same generator.
    DiscriminativeModel at the LSGAN widths: enhance that of an
    NCSNPPWrapper of the same seed; train_loss on a batch-1 crop and its
    backward on the card, the loss against the CPU's within
    LEGACY_LOSS_REL_TOL; one EMA update on the card against the formula
    on the CPU. -> the regeneration's launches by kernel."""
    from use_tpu_torch import ops
    from use_tpu_torch.cli.main import _build_model
    from use_tpu_torch.config.config import load_config
    from use_tpu_torch.models.gan.generator import NCSNPPWrapper
    from use_tpu_torch.models.sgmse import legacy

    gan = _build_model(load_config(GAN_EXPERIMENT, []), str(dev))
    score = _build_model(load_config(LEGACY_SCORE_EXPERIMENT, ["model.condition=both",
                                                               "model.sde_input=denoised"]),
                         str(dev))
    _randomize(torch, gan.generator.net, seed=1)
    _randomize(torch, score.score_net, seed=2)
    regen = legacy.StochasticRegenerationModel(denoiser=gan.generator, score=score)
    y = _legacy_clip(torch, dev, LEGACY_CLIP_S)

    def seeded():
        return torch.Generator(device=dev).manual_seed(7)

    regen.enhance(y, seeded(), N=CHAIN_N)  # untimed: cuDNN's first calls
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = regen.enhance(y, seeded(), N=CHAIN_N)
    torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    fake = gan.enhance({"perturbed": y})["fake"]
    chain = score.sample({"perturbed": y, "fake": fake}, seeded(), N=CHAIN_N)["fake_sde_enhanced"]
    chain_err = _rel(out, chain)
    regen_rec = {"clip_s": LEGACY_CLIP_S, "N": CHAIN_N, "seconds": seconds,
                 "audio_s_per_s": LEGACY_CLIP_S / seconds, "peak_memory_bytes": peak,
                 "launches": counts, "chain_rel_err": chain_err,
                 "chain_equal": bool(torch.equal(out, chain)),
                 "finite": bool(torch.isfinite(out).all())}
    del regen, gan, fake, chain
    score_cfg = dict(load_config(LEGACY_SCORE_EXPERIMENT, [])["model"])
    lsm = legacy.LegacyScoreModel(**score_cfg, device=dev, seed=3)
    _randomize(torch, lsm.score_net, seed=3)
    x_hat, nfe, rtf = lsm.enhance(y[0], seeded(), N=CHAIN_N, timeit=True)
    sampled = lsm.sample({"perturbed": y}, seeded(), N=CHAIN_N)["enhanced"][0]
    lsm_rec = {"nfe": nfe, "rtf": rtf, "rel_err": _rel(x_hat, sampled),
               "finite": bool(torch.isfinite(x_hat).all())}
    del lsm, x_hat, sampled
    gcfg = dict(load_config(GAN_EXPERIMENT, [])["model"]["generator"])
    gcfg.pop("name", None)
    gen_kw = {k: gcfg[k] for k in ("n_fft", "hop_length", "num_frames", "backbone",
                                   "backbone_kwargs") if k in gcfg}
    dm = legacy.DiscriminativeModel(**gen_kw, device=dev, seed=4)
    ref_wrapper = NCSNPPWrapper(**gen_kw, device=dev, seed=4)
    _randomize(torch, dm.wrapper.net, seed=4)
    _randomize(torch, ref_wrapper.net, seed=4)
    dm_enhanced = dm.enhance(y)
    wrapper_enhanced = ref_wrapper.forward_infer({"perturbed": y})["fake"]
    del ref_wrapper
    crop = {k: _legacy_clip(torch, dev, 4, seed=5 + i) for i, k in enumerate(("clean",
                                                                              "perturbed"))}
    start = dm.wrapper.draw_start(crop["clean"].shape[-1], torch.Generator().manual_seed(6))
    loss = dm.train_loss(crop, start=start)
    loss.backward()
    grads_finite = all(bool(torch.isfinite(p.grad).all())
                       for p in dm.wrapper.net.parameters() if p.grad is not None)
    cpu_dm = legacy.DiscriminativeModel(**gen_kw, device="cpu", seed=4)
    cpu_dm.wrapper.net.load_state_dict(dm.wrapper.net.state_dict())
    with torch.no_grad():
        cpu_loss = cpu_dm.train_loss({k: v.cpu() for k, v in crop.items()}, start=start)
    loss = float(loss.detach())
    loss_err = abs(loss - float(cpu_loss)) / abs(float(cpu_loss))
    ema = legacy.EMA(0.999)
    state = {k: v.detach() for k, v in dm.wrapper.net.state_dict().items()
             if v.is_floating_point()}
    shadow = ema.init(state)
    moved = {k: v + 0.01 for k, v in state.items()}
    updated = ema.update(shadow, moved)
    ema_err = max(_rel(updated[k], 0.999 * shadow[k].cpu() + (1 - 0.999) * moved[k].cpu())
                  for k in state)
    dm_rec = {"enhance_rel_err": _rel(dm_enhanced, wrapper_enhanced), "loss": loss,
              "cpu_loss": float(cpu_loss), "loss_rel_err": loss_err, "start": start,
              "grads_finite": grads_finite, "ema_rel_err": ema_err}
    del dm, cpu_dm
    phase("legacy_models", dtype="float32", tf32=bool(torch.backends.cudnn.allow_tf32),
          regeneration=regen_rec, expected_launches=all_kernels(LEGACY_REGEN_LAUNCHES),
          legacy_score=lsm_rec, discriminative=dm_rec, chain_tol=LEGACY_CHAIN_TOL,
          loss_tol=LEGACY_LOSS_REL_TOL)
    failed = []
    if not (regen_rec["finite"] and chain_err <= LEGACY_CHAIN_TOL):
        failed.append(f"regeneration against the gan+sgmse chain: {chain_err}")
    if counts != all_kernels(LEGACY_REGEN_LAUNCHES):
        failed.append(f"regeneration launches {counts}, expected {LEGACY_REGEN_LAUNCHES}")
    if not (nfe == CHAIN_N and rtf > 0 and lsm_rec["finite"] and lsm_rec["rel_err"] <= 1e-6):
        failed.append(f"LegacyScoreModel.enhance: {lsm_rec}")
    if not (dm_rec["enhance_rel_err"] <= 1e-6 and loss_err <= LEGACY_LOSS_REL_TOL
            and grads_finite and ema_err <= 1e-6):
        failed.append(f"DiscriminativeModel / EMA: {dm_rec}")
    if failed:
        raise AssertionError("legacy_models: " + "; ".join(failed))
    torch.cuda.empty_cache()
    return counts


def legacy_layers_forward_phase(torch, dev):
    """Phase 31: the NCSNv1 layers and the norm zoo at LEGACY_LAYER_SHAPE,
    fp32, TF32 off, seeded weights: RefineBlock on two inputs (the second
    at half the resolution), unconditional and conditional
    (ConditionalInstanceNorm2dPlus on 10 classes), a 'down' ResidualBlock
    with that norm, and each norm of the zoo; the card against the CPU
    within ZOO_REL_TOL x max|ref| (the CPU on the first two lanes, but the
    batch norm on all); K1, K2 and K3 launched no time."""
    from use_tpu_torch.models.ncsnpp import legacy_layers as ll, normalization as nz

    b, c, h, w = LEGACY_LAYER_SHAPE
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(LEGACY_LAYER_SHAPE, generator=gen)
    x2 = torch.randn((b, c, h // 2, w // 2), generator=gen)
    y = torch.arange(b) % 10
    lanes = 2

    def cond(ch):
        return nz.ConditionalInstanceNorm2dPlus(ch, num_classes=10)

    cases = [
        ("refine", ll.RefineBlock((c, c), c), lambda m, a, a2, yy: m([a, a2], (h, w)), lanes),
        ("refine conditional", ll.RefineBlock((c, c), c, normalizer=cond),
         lambda m, a, a2, yy: m([a, a2], (h, w), yy), lanes),
        ("residual down conditional", ll.ResidualBlock(c, 2 * c, "down", normalizer=cond),
         lambda m, a, a2, yy: m(a, yy), lanes),
    ]
    for (name, conditional), kw in (
            (("instancenorm", False), {}), (("batchnorm", False), {}),
            (("groupnorm", False), {}), (("variancenorm", False), {}),
            (("variancenorm", True), {"num_classes": 10}), (("instancenorm++", False), {}),
            (("instancenorm++", True), {"num_classes": 10})):
        norm = nz.get_normalization(name, conditional)(c, **kw)
        fn = (lambda m, a, a2, yy: m(a, yy)) if conditional else (lambda m, a, a2, yy: m(a))
        cases.append((name + (" conditional" if conditional else ""), norm, fn,
                      None if name == "batchnorm" else lanes))
    records = []
    for i, (name, module, fn, n) in enumerate(cases):
        ll.reset_parameters(module, torch.Generator().manual_seed(10 + i))
        card = copy.deepcopy(module).to(dev)
        cut = (lambda t: t) if n is None else (lambda t: t[:n].contiguous())
        rec, _, _ = _zoo_case(torch, dev, name, lambda: fn(module, cut(x), cut(x2), cut(y)),
                              lambda: fn(card, x.to(dev), x2.to(dev), y.to(dev)), lanes=n)
        records.append(rec)
        del card
    phase("legacy_layers_forward", dtype="float32", shape=list(LEGACY_LAYER_SHAPE),
          tf32=bool(torch.backends.cudnn.allow_tf32), tol=ZOO_REL_TOL, cases=records)
    failed = [f"{r['case']}: {r}" for r in records
              if not (r["shapes_equal"] and r["finite"] and r["max_rel_err"] <= ZOO_REL_TOL
                      and r["launches"] == all_kernels(NO_LAUNCHES))]
    if failed:
        raise AssertionError("legacy_layers_forward: " + "; ".join(failed))
    torch.cuda.empty_cache()


# -- data-parallel and bf16 training (phases 32-34) ------------------------

def dist_phases(torch, dev):
    """Phases 32-34; -> {run label: launches by kernel} of the torchrun run."""
    timed("train_bf16_step", train_bf16_step_phase, torch, dev)
    runs = timed("train_ddp", train_ddp_phase, torch, dev)
    timed("ddp_two_ranks", ddp_two_ranks_phase, torch, dev)
    return runs


def _grad_rel(got, want, skip=()):
    """{name: max |got - want| / max |want|} over `want`'s tensors but
    `skip`, and |got - want| / |want| (L2) over all of them together."""
    rel, num, den = {}, 0.0, 0.0
    for k, w in want.items():
        if k in skip:
            continue
        g = got[k].float()
        rel[k] = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        num += float(((g - w) ** 2).sum())
        den += float((w ** 2).sum())
    return rel, math.sqrt(num / den)


@contextlib.contextmanager
def k2_backward_without_scale(torch):
    """A bf16 training path broken on purpose, for the bf16 gate to reject:
    K2's backward without its skip_rescale factor (1/sqrt(2))."""
    from use_tpu_torch.ops import fused_skip

    backward = fused_skip._FusedSkipAdd.backward

    def unscaled(ctx, dy):
        scale, ctx.scale = ctx.scale, 1.0
        try:
            return backward(ctx, dy)
        finally:
            ctx.scale = scale

    fused_skip._FusedSkipAdd.backward = staticmethod(unscaled)
    try:
        yield
    finally:
        fused_skip._FusedSkipAdd.backward = staticmethod(backward)


def _bf16_cases(torch, dev, recipe):
    """`recipe` ('sgmse': SGMSE_Large's score model on TRAIN_SHAPE[0] clips;
    'lsgan': LSGAN's generator and D on GAN_TRAIN_SHAPE[0] clips), remat:
    for each of BF16_SEEDS (the weights and the batch), one microbatch in
    fp32 and one with the backbone in bf16 (the same fp32 weights, the same
    draws), and the first seed's again with the control; -> a record a
    case: the bf16 loss and gradients against the fp32 ones, launches,
    seconds and peak memory (the first seed's timed, median of 3)."""
    from use_tpu_torch import ops

    if recipe == "sgmse":
        model, _ = _train_model(torch, dev)
        owner, attr = model, "score_net"

        def batch_of(seed):
            return _train_batch(torch, model, TRAIN_SHAPE[0], seed=seed)

        def run(data):
            loss, s = _microbatch(torch, model, *data)
            return float(loss), {k: p.grad for k, p in model.score_net.named_parameters()
                                 if p.grad is not None}, s
    else:
        model, _ = _gan_model(torch, dev)
        owner, attr = model.generator, "net"

        def batch_of(seed):
            return _gan_batch(torch, model, GAN_TRAIN_SHAPE[0], seed=seed)

        def run(data):
            loss_d, logs, s = _gan_microbatch(torch, model, *data)
            return logs["loss_G"] + float(loss_d), _gan_grads(model), s

    fp32 = getattr(owner, attr)
    bf16 = _bf16_twin(torch, fp32, dev)
    key_biases = {f"{name}.NIN_1.b" for name, m in fp32.named_modules()
                  if type(m).__name__ == "AttnBlockpp"}
    key_biases |= {f"G.{k}" for k in key_biases}
    records = []
    for seed, control in [(s, False) for s in BF16_SEEDS] + [(BF16_SEEDS[0], True)]:
        _randomize(torch, fp32, seed=seed)
        bf16.load_state_dict(fp32.state_dict())
        data = batch_of(seed)
        setattr(owner, attr, fp32)
        loss32, g32, _ = run(data)
        want = {k: g.detach().clone() for k, g in g32.items()}
        timed32 = [run(data)[2] for _ in range(3)] if seed == BF16_SEEDS[0] and not control \
            else []
        setattr(owner, attr, bf16)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        with k2_backward_without_scale(torch) if control else contextlib.nullcontext():
            loss16, g16, s = run(data)
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        rel, l2 = _grad_rel(g16, want, key_biases)
        worst = max(rel, key=rel.get)
        rec = {"recipe": recipe, "seed": seed, "control": control, "loss_fp32": loss32,
               "loss_bf16": loss16, "loss_rel_err": abs(loss16 - loss32) / abs(loss32),
               "grad_l2_rel_err": l2, "max_grad_rel_err": rel[worst], "worst_grad": worst,
               "median_grad_rel_err": float(np.median(list(rel.values()))), "grads": len(rel),
               "launches": counts, "seconds": s, "peak_memory_bytes": peak,
               "param_dtypes": sorted({str(p.dtype) for p in bf16.parameters()})}
        if timed32:
            rec["microbatch_s"] = float(np.median([run(data)[2] for _ in range(3)]))
            rec["microbatch_s_fp32"] = float(np.median(timed32))
        records.append(rec)
        del want, g32, g16
    setattr(owner, attr, fp32)
    del model, fp32, bf16
    torch.cuda.empty_cache()
    return records


def _bf16_twin(torch, net, dev):
    """A copy of the NCSN++ `net` that computes in bf16 (its config's
    dtype; the weights float32), on `dev`."""
    from use_tpu_torch.models.ncsnpp.ncsnpp import NCSNpp

    twin = NCSNpp(dataclasses.replace(net.cfg, dtype="bfloat16"))
    twin.load_state_dict(net.state_dict())
    return twin.to(dev)


def train_bf16_step_phase(torch, dev):
    """bf16 training (phase 32): one SGMSE_Large microbatch (TRAIN_SHAPE,
    remat) and one LSGAN microbatch (GAN_TRAIN_SHAPE, both phases, remat),
    each with the backbone in bf16 against fp32 on the card, on the same
    weights, batch and draws, for BF16_SEEDS: the loss, and every gradient
    against the fp32 one (its largest-relative error per tensor, and the L2
    error of them all, which BF16_GRAD_L2_TOL gates); the control (K2's bf16
    backward without its scale) must exceed that limit; the weights stay
    float32; launches exactly TRAIN_LAUNCHES["remat"] and
    GAN_TRAIN_LAUNCHES["remat"]; seconds a bf16 microbatch (median of 3)
    and its peak memory beside the fp32 ones of phases 10 and 13."""
    records = _bf16_cases(torch, dev, "sgmse") + _bf16_cases(torch, dev, "lsgan")
    phase("train_bf16_step", shapes={"sgmse": list(TRAIN_SHAPE), "lsgan": list(GAN_TRAIN_SHAPE)},
          tol=BF16_GRAD_L2_TOL, control="K2's bf16 backward without its scale",
          tf32=bool(torch.backends.cudnn.allow_tf32), cases=records)
    want = {"sgmse": all_kernels(TRAIN_LAUNCHES["remat"]),
            "lsgan": all_kernels(GAN_TRAIN_LAUNCHES["remat"])}
    failed = []
    for r in records:
        if r["control"]:
            if not r["grad_l2_rel_err"] > BF16_GRAD_L2_TOL:
                failed.append(f"{r['recipe']}: the control passes ({r['grad_l2_rel_err']})")
            continue
        if not (r["grad_l2_rel_err"] <= BF16_GRAD_L2_TOL and math.isfinite(r["loss_bf16"])):
            failed.append(f"{r['recipe']} seed {r['seed']}: L2 {r['grad_l2_rel_err']}, "
                          f"loss {r['loss_bf16']}")
        if r["launches"] != want[r["recipe"]] or r["param_dtypes"] != ["torch.float32"]:
            failed.append(f"{r['recipe']}: launches {r['launches']}, weights {r['param_dtypes']}")
    if failed:
        raise AssertionError("train_bf16_step: " + "; ".join(failed))


def _last_state(out_dir):
    """The model weights of a train run's last checkpoint."""
    from use_tpu_torch.engine.checkpoint import CheckpointManager

    mgr = CheckpointManager(os.path.join(out_dir, "checkpoints"))
    return mgr.restore(mgr.latest_step())["model"]


def _update_rel(a, b, start):
    """|a - b| / |b - start| over all the tensors of b together (L2): how
    far two trained weights part, as a share of the training's update."""
    num = sum(float(((a[k].float() - v.float()) ** 2).sum()) for k, v in b.items())
    den = sum(float(((v.float() - start[k].float()) ** 2).sum()) for k, v in b.items())
    return math.sqrt(num / den)


def _torchrun(args, log_path):
    """Start `python -m torch.distributed.run --standalone` over every card
    with `args`, its output to log_path; -> the process."""
    import torch

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={torch.cuda.device_count()}", *args]
    env = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}
    with open(log_path, "w") as log:
        return subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, env=env,
                                cwd=os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def _reaping(procs):
    """Kill whatever of `procs` still runs when the block ends."""
    try:
        yield
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _finished(proc, log_path, what, timeout=600):
    """Wait for a _torchrun process; -> its output, or raise where it failed."""
    rc = proc.wait(timeout=timeout)
    with open(log_path) as f:
        text = f.read()
    if rc != 0:
        raise AssertionError(f"{what}: torchrun exited {rc}:\n{text[-6000:]}")
    return text


def _summary_line(text):
    lines = [ln for ln in text.splitlines() if "train summary: " in ln]
    if not lines:
        raise AssertionError(f"train_ddp: no train summary in the run's output:\n{text[-4000:]}")
    return json.loads(lines[-1].split("train summary: ", 1)[1])


def _async_checkpoint_check(torch, dev):
    """An SGMSE_Large train state after one optimizer step, saved
    synchronously and asynchronously; a second step changes it in place
    right after the asynchronous save returns: both files hold the first
    state, bit for bit. -> (equal, seconds of the save call, seconds of
    the write it hides)."""
    from use_tpu_torch.engine.checkpoint import CheckpointManager
    from use_tpu_torch.engine.loop import build_train_state

    model, cfg = _train_model(torch, dev)
    batch, draws = _train_batch(torch, model, 1)
    _microbatch(torch, model, batch, draws)
    t = cfg["train"]
    state = build_train_state(model, t["lr"], t["weight_decay"], t["grad_clip"])
    state.apply_gradients()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        sync = CheckpointManager(os.path.join(tmp, "sync"))
        t0 = time.perf_counter()
        sync.save(0, state)
        sync_s = time.perf_counter() - t0
        mgr = CheckpointManager(os.path.join(tmp, "async"), async_save=True)
        t0 = time.perf_counter()
        mgr.save(0, state)
        call_s = time.perf_counter() - t0
        state.apply_gradients()  # the next step, in place, while the write runs
        mgr.wait()
        a, b = mgr.restore(0), sync.restore(0)
    equal = all(torch.equal(a["model"][k], v) for k, v in b["model"].items()) and all(
        torch.equal(x, y) for s, o in zip(a["optimizer"]["state"].values(),
                                          b["optimizer"]["state"].values())
        for x, y in zip(s.values(), o.values()) if isinstance(x, torch.Tensor))
    del model, state, a, b
    torch.cuda.empty_cache()
    return equal, call_s, sync_s


def train_ddp_phase(torch, dev):
    """Data-parallel training through the CLI (phase 33): `python -m
    torch.distributed.run --standalone --nproc_per_node=<the cards> -m
    use_tpu_torch.cli.main train experiment=SGMSE_Large` with
    DDP_TRAIN_ARGS (2 optimizer steps of 2 microbatches of 2 clips, the
    loader in the main process, train.async_ckpt=true, mesh_idle=error):
    exit 0, its world size and backend (NCCL) printed, K1 and K2 launched
    exactly TRAIN_LAUNCHES["remat"] a microbatch plus PER_FORWARD a
    validation or test batch; its last checkpoint's weights against two
    runs of the same command without torchrun (in this process, checkpoints
    written synchronously): within twice their spread (cuDNN's backward
    sums in no fixed order). Then the LSGAN recipe under torchrun with the
    generator in bf16 (DDP_LSGAN_ARGS, mesh_idle=warn): exit 0, finite
    losses, launches exactly GAN_TRAIN_LAUNCHES["remat"] a microbatch plus
    PER_GENERATOR_FORWARD an eval batch. The torchrun runs start first and
    run beside the plain ones. And the asynchronous checkpoint read back
    equals a synchronous one of the same state, bit for bit; and an
    optimizer step through DDP at world 1 is timed against the plain step.
    -> {"train_ddp": the SGMSE run's launches}."""
    from use_tpu_torch.cli.main import _build_model
    from use_tpu_torch.cli.main import main as cli_main
    from use_tpu_torch.config.config import load_config

    sr = 24000
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ddp_") as tmp:
        jl = write_corpus(os.path.join(tmp, "corpus"), DDP_CLIPS, TRAIN_CLIP_S, sr)
        data = [f"data.clean_json_path={jl}", f"data.noise_json_path={jl}",
                "data.reverb_use_FRA=true"]
        # the torchrun runs start first and run beside the plain runs: a new
        # process's start (imports, the model, CUDA's first calls) is most
        # of their time
        out, gan_out = os.path.join(tmp, "ddp"), os.path.join(tmp, "lsgan")
        t0 = time.perf_counter()
        logs = {"sgmse": os.path.join(tmp, "ddp.log"), "lsgan": os.path.join(tmp, "lsgan.log")}
        procs = {"sgmse": _torchrun(["-m", "use_tpu_torch.cli.main", "train",
                                     f"experiment={TRAIN_EXPERIMENT}", *data, *DDP_TRAIN_ARGS,
                                     "train.async_ckpt=true", "train.mesh_idle=error",
                                     f"out_dir={out}"], logs["sgmse"]),
                 "lsgan": _torchrun(["-m", "use_tpu_torch.cli.main", "train",
                                     f"experiment={GAN_EXPERIMENT}", *data, *DDP_LSGAN_ARGS,
                                     "train.async_ckpt=true", "train.mesh_idle=warn",
                                     f"out_dir={gan_out}"], logs["lsgan"])}
        with _reaping(procs.values()):
            plain = []
            for i in range(2):
                p_out = os.path.join(tmp, f"plain{i}")
                with train_steps_timed(torch, dev, profile_step=False) as rec:
                    s = cli_main(["train", f"experiment={TRAIN_EXPERIMENT}", *data,
                                  *DDP_TRAIN_ARGS, f"out_dir={p_out}", f"device={dev}"])
                plain.append((p_out, s, rec))
            text = _finished(procs["sgmse"], logs["sgmse"], "train_ddp")
            wall = time.perf_counter() - t0
            summary = _summary_line(text)
            start = _build_model(load_config(TRAIN_EXPERIMENT), "cpu").score_net.state_dict()
            ref = _last_state(plain[0][0])
            spread = _update_rel(_last_state(plain[1][0]), ref, start)
            err = _update_rel(_last_state(out), ref, start)
            _, s0, rec0 = plain[0]
            want = {k: v * s0["microbatches"] + all_kernels(PER_FORWARD["float32"])[k]
                    * DDP_EVAL_BATCHES for k, v in all_kernels(TRAIN_LAUNCHES["remat"]).items()}
            printed = (f"data-parallel over {torch.cuda.device_count()} ranks "
                       f"(backend {DDP_BACKEND})")
            phase("train_ddp", experiment=TRAIN_EXPERIMENT, args=list(DDP_TRAIN_ARGS),
                  clips=DDP_CLIPS, world_size=summary["world_size"], backend=summary["backend"],
                  printed=printed in text, optimizer_steps=summary["optimizer_steps"],
                  microbatches=summary["microbatches"], fit_seconds=summary["fit_seconds"],
                  plain_fit_seconds=[p[1]["fit_seconds"] for p in plain],
                  plain_step_seconds=[p[2]["step_s"] for p in plain],
                  wall_seconds=wall, launches=summary["launches"], expected_launches=want,
                  plain_launches=s0["launches"],
                  eval_batches=rec0["eval_steps"], weights_rel_err_of_update=err,
                  plain_runs_rel_spread_of_update=spread, floor=DDP_WEIGHTS_FLOOR)
            if not (printed in text and summary["backend"] == DDP_BACKEND
                    and summary["world_size"] == torch.cuda.device_count()):
                raise AssertionError(f"train_ddp: world {summary['world_size']}, backend "
                                     f"{summary['backend']}, printed {printed in text}")
            if (summary["launches"] != want or s0["launches"] != want
                    or rec0["eval_steps"] != DDP_EVAL_BATCHES or summary["optimizer_steps"] != 2):
                raise AssertionError(f"train_ddp: launches {summary['launches']}, expected {want}; "
                                     f"{summary['optimizer_steps']} steps")
            if not err <= max(2 * spread, DDP_WEIGHTS_FLOOR):
                raise AssertionError(f"train_ddp: weights off the plain runs' by {err} (their "
                                     f"spread {spread})")
            del ref, start

            text = _finished(procs["lsgan"], logs["lsgan"], "train_ddp lsgan")
            gan_wall = time.perf_counter() - t0
            gsum = _summary_line(text)
            micro = gsum["microbatches"]
            with open(os.path.join(gan_out, "optimized_metric.json")) as f:
                record = json.load(f)
            gwant = {k: v * micro + all_kernels(PER_GENERATOR_FORWARD)[k] * DDP_EVAL_BATCHES
                     for k, v in all_kernels(GAN_TRAIN_LAUNCHES["remat"]).items()}
            phase("train_ddp_lsgan", experiment=GAN_EXPERIMENT, args=list(DDP_LSGAN_ARGS),
                  world_size=gsum["world_size"], backend=gsum["backend"],
                  optimizer_steps=gsum["optimizer_steps"], microbatches=micro,
                  fit_seconds=gsum["fit_seconds"], wall_seconds=gan_wall,
                  optimized_metric=record, launches=gsum["launches"], expected_launches=gwant)
            if not (np.isfinite(record["value"]) and gsum["launches"] == gwant
                    and gsum["optimizer_steps"] == 1):
                raise AssertionError(f"train_ddp lsgan: {record}, launches {gsum['launches']}, "
                                     f"expected {gwant}")
    equal, call_s, sync_s = _async_checkpoint_check(torch, dev)
    phase("async_checkpoint", experiment=TRAIN_EXPERIMENT, bit_equal=equal,
          async_call_seconds=call_s, sync_save_seconds=sync_s)
    if not equal:
        raise AssertionError("train_ddp: the asynchronous checkpoint differs from the "
                             "synchronous one")
    _ddp_world1_step(torch, dev)
    torch.cuda.empty_cache()
    return {"train_ddp": summary["launches"]}


def _ddp_world1_step(torch, dev):
    """An SGMSE_Large optimizer step (TRAIN_SHAPE, one microbatch, remat)
    plain and through DDP in a process group of one rank (NCCL), in turns
    (plain, DDP, DDP, plain, ...), in this process: the seconds of each
    (medians of 3), the cost of DDP's hooks and bucket copies at world 1."""
    import torch.distributed as dist

    from use_tpu_torch.engine.loop import distribute, build_train_state
    from use_tpu_torch.engine.train import sgmse_train_step
    from use_tpu_torch.parallel.mesh import World

    model, cfg = _train_model(torch, dev)
    batch, draws = _train_batch(torch, model, TRAIN_SHAPE[0])
    micro = [{k: v.to(dev) for k, v in batch.items()}]
    tc = cfg["train"]
    state = build_train_state(model, tc["lr"], tc["weight_decay"], tc["grad_clip"])
    dist.init_process_group(DDP_BACKEND, init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        distribute(state, World(), dev)
        ddp = state.ddp
        times = {"plain": [], "ddp": []}
        for label in ("ddp", "plain") + ("plain", "ddp", "ddp", "plain") * 2 + ("ddp",):
            state.ddp = ddp if label == "ddp" else None
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            sgmse_train_step(model, state, micro, draws=[draws])
            torch.cuda.synchronize(dev)
            times[label].append(time.perf_counter() - t0)
    finally:
        dist.destroy_process_group()
    plain, wrapped = times["plain"][1:], times["ddp"][1:]  # the first of each warms up
    phase("ddp_world1_step", experiment=TRAIN_EXPERIMENT, shape=list(TRAIN_SHAPE),
          backend=DDP_BACKEND, plain_step_s=float(np.median(plain)),
          ddp_step_s=float(np.median(wrapped)), plain_steps_s=plain, ddp_steps_s=wrapped)
    del model, state, ddp


def ddp_rank_worker(tmp, device):
    """One of ddp_two_ranks' two processes (torchrun's environment set by
    the phase): joins the gloo group, takes one sgmse_train_step of
    SGMSE_Large at batch 1 (its row of the 2-clip batch and of the global
    draws) on the card, and saves the gradient it applied and the weights
    after the step; times the step and one all-reduce of the whole
    gradient."""
    import torch
    import torch.distributed as dist

    from use_tpu_torch.engine.loop import distribute, build_train_state
    from use_tpu_torch.engine.train import sgmse_train_step
    from use_tpu_torch.parallel.mesh import default_world, init_distributed, local_rows

    assert init_distributed("gloo")
    dev = torch.device(device)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    model, cfg = _train_model(torch, dev)
    batch, (start, t, z) = _train_batch(torch, model, 2)
    world = default_world(2)
    tc = cfg["train"]
    state = build_train_state(model, tc["lr"], tc["weight_decay"], tc["grad_clip"])
    distribute(state, world, dev)
    seen = {}
    real = state.apply_gradients

    def record():
        seen.update({k: p.grad.detach().cpu() for k, p in model.score_net.named_parameters()
                     if p.grad is not None})
        real()

    state.apply_gradients = record
    local = {k: local_rows(v, world).to(dev) for k, v in batch.items()}
    dist.barrier()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = sgmse_train_step(model, state, [local],
                           draws=[(start, local_rows(t, world), local_rows(z, world))])
    torch.cuda.synchronize(dev)
    step_s = time.perf_counter() - t0
    flat = torch.cat([p.grad.flatten() for p in model.score_net.parameters()
                      if p.grad is not None])
    dist.barrier()
    t0 = time.perf_counter()
    dist.all_reduce(flat)
    torch.cuda.synchronize(dev)
    reduce_s = time.perf_counter() - t0
    torch.save({"rank": world.rank, "grads": seen, "loss": float(out["loss_Score"]),
                "weights": {k: p.detach().cpu() for k, p in model.score_net.named_parameters()},
                "step_s": step_s, "all_reduce_s": reduce_s, "all_reduce_bytes": flat.numel() * 4},
               os.path.join(tmp, f"rank{world.rank}.pt"))
    dist.destroy_process_group()


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def ddp_two_ranks_phase(torch, dev):
    """Two ranks share the card through gloo (phase 34; NCCL refuses two
    ranks on one GPU), each one sgmse_train_step of SGMSE_Large at batch 1
    through the engine (ddp_rank_worker): both ranks end bit-identical, and
    the gradient they apply is the one-process step's over the 2-clip batch
    with the same global draws, each tensor within TRAIN_GRAD_REL_TOL of its
    largest (the attention's key biases below KEY_BIAS_GRAD_FLOOR of the
    largest of all); the weights after Adam within rtol 1e-5 + 1e-7 where
    the gradient is not within twice that gate of 0 (there a first Adam
    step is lr sign(g), the sign rounding's), within 2 lr everywhere.
    Seconds of the step and of a gloo all-reduce of the whole gradient."""
    from use_tpu_torch.engine.loop import build_train_state
    from use_tpu_torch.engine.train import sgmse_train_step

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ranks_") as tmp:
        port = _free_port()
        procs = []
        for rank in range(2):
            env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": "2", "LOCAL_RANK": "0",
                   "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}
            procs.append(subprocess.Popen(
                [sys.executable, sys.argv[0], "--ddp-rank-worker", tmp, str(dev)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        with _reaping(procs):
            logs = [p.communicate(timeout=600)[0] for p in procs]
        if any(p.returncode for p in procs):
            raise AssertionError("ddp_two_ranks: a rank failed:\n" + "\n".join(
                log[-4000:] for log in logs))
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
    identical = all(torch.equal(ranks[0][part][k], ranks[1][part][k])
                    for part in ("grads", "weights") for k in ranks[0][part])
    model, cfg = _train_model(torch, dev)
    batch, draws = _train_batch(torch, model, 2)
    tc = cfg["train"]
    lr = tc["lr"]
    state = build_train_state(model, lr, tc["weight_decay"], tc["grad_clip"])
    seen = {}
    real = state.apply_gradients

    def record():
        seen.update({k: p.grad.detach().cpu() for k, p in model.score_net.named_parameters()
                     if p.grad is not None})
        real()

    state.apply_gradients = record
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = sgmse_train_step(model, state, [{k: v.to(dev) for k, v in batch.items()}],
                           draws=[draws])
    torch.cuda.synchronize(dev)
    one_s = time.perf_counter() - t0
    key_biases = {f"{name}.NIN_1.b" for name, m in model.score_net.named_modules()
                  if type(m).__name__ == "AttnBlockpp"}
    got = ranks[0]
    rel, _ = _grad_rel(got["grads"], seen, key_biases)
    worst = max(rel, key=rel.get)
    top = max(float(g.abs().max()) for g in seen.values())
    key_bias = {k: [float(got["grads"][k].abs().max()) / top, float(seen[k].abs().max()) / top]
                for k in key_biases}
    step_off, sure_off = 0.0, 0.0
    for k, p in model.score_net.named_parameters():
        w, g = p.detach().cpu(), seen.get(k)
        diff = (got["weights"][k] - w).abs()
        step_off = max(step_off, float(diff.max()) / lr)
        if g is None or k in key_biases:
            continue
        sure = g.abs() > 2 * TRAIN_GRAD_REL_TOL * float(g.abs().max())
        if bool(sure.any()):
            sure_off = max(sure_off, float((diff[sure] - 1e-5 * w.abs()[sure]).max()))
    phase("ddp_two_ranks", experiment=TRAIN_EXPERIMENT, backend="gloo", ranks=2,
          clips_a_rank=1, ranks_bit_identical=identical,
          losses=[r["loss"] for r in ranks], loss_one_process=float(out["loss_Score"]),
          grad_tol=TRAIN_GRAD_REL_TOL, max_grad_rel_err=rel[worst], worst_grad=worst,
          median_grad_rel_err=float(np.median(list(rel.values()))),
          key_bias_grads_over_top=key_bias, max_weight_step_over_lr=step_off,
          max_sure_weight_err=sure_off, step_seconds=[r["step_s"] for r in ranks],
          one_process_step_seconds=one_s,
          all_reduce_seconds=[r["all_reduce_s"] for r in ranks],
          all_reduce_bytes=ranks[0]["all_reduce_bytes"])
    loss_err = abs(np.mean([r["loss"] for r in ranks]) - float(out["loss_Score"])) \
        / abs(float(out["loss_Score"]))
    if not identical:
        raise AssertionError("ddp_two_ranks: the ranks' weights or gradients differ")
    if not (rel[worst] <= TRAIN_GRAD_REL_TOL and loss_err <= 1e-4
            and max(max(v) for v in key_bias.values()) <= KEY_BIAS_GRAD_FLOOR):
        raise AssertionError(f"ddp_two_ranks: gradient {worst} off by {rel[worst]}, loss "
                             f"{loss_err}, key biases {key_bias}")
    if not (sure_off <= 1e-7 and step_off <= 2 * (1 + 1e-5)):
        raise AssertionError(f"ddp_two_ranks: weights off by {sure_off} (sure gradients), "
                             f"{step_off} lr (any)")
    del model, state, seen, ranks
    torch.cuda.empty_cache()


@contextlib.contextmanager
def summing_gather_backward():
    """A tensor-parallel path broken on purpose, for phase 35's gates to
    reject: the gather's backward summed over the model ranks before this
    rank's slice, as torch.distributed.nn's all_gather has it."""
    from use_tpu_torch.parallel import sharding

    real = sharding._GatherFromModel.backward

    def summing(ctx, g):
        return real(ctx, sharding._all_reduce(g.contiguous().clone(), ctx.world))

    sharding._GatherFromModel.backward = staticmethod(summing)
    try:
        yield
    finally:
        sharding._GatherFromModel.backward = staticmethod(real)


@contextlib.contextmanager
def cut_int8_calls(calls):
    """Each call of a cut int8 conv that quantizes (``FusedQConv3x3.local``,
    ``QConv.local``: the forward's and the BigGAN block's ahead of its
    sharded K2) appended to `calls` as (the conv, its arguments, its output
    on this rank's channels)."""
    from use_tpu_torch.models.ncsnpp import layers

    reals = {cls: cls.local for cls in (layers.FusedQConv3x3, layers.QConv)}

    def recording(real):
        def local(self, *args):
            out = real(self, *args)
            quantized = not isinstance(self, layers.QConv) or len(args) > 1 or self.quantizes()
            if self.tp is not None and quantized:
                calls.append((self, args, out))
            return out
        return local

    for cls, real in reals.items():
        cls.local = recording(real)
    try:
        yield calls
    finally:
        for cls, real in reals.items():
            cls.local = real


def check_cut_int8_calls(torch, calls, uncut, names, world):
    """Each recorded call of a cut int8 conv: its output gathered against
    the uncut net's same conv on the same arguments (bit for bit), and the
    control (``bias_after_gather``) against it. -> a summary by kind."""
    from use_tpu_torch.parallel import sharding

    out = {}
    for conv, args, local in calls:
        got = sharding.model_all_gather(local, 1, world.model_group.group_name, world.model)
        want = uncut.get_submodule(names[id(conv)])(*args)
        control = bias_after_gather(conv, args, world)
        kind = out.setdefault(type(conv).__name__, {
            "calls": 0, "bit_equal": 0, "max_abs_err": 0.0, "control_bit_equal": 0,
            "control_max_abs_err": 0.0, "out_channels": {}})
        kind["calls"] += 1
        kind["bit_equal"] += int(torch.equal(got, want))
        kind["max_abs_err"] = max(kind["max_abs_err"], float((got - want).abs().max()))
        kind["control_bit_equal"] += int(torch.equal(control, want))
        kind["control_max_abs_err"] = max(kind["control_max_abs_err"],
                                          float((control - want).float().abs().max()))
        key = f"{local.shape[1]} of {want.shape[1]}"
        kind["out_channels"][key] = kind["out_channels"].get(key, 0) + 1
    return out


def bias_after_gather(conv, args, world):
    """A cut int8 conv's call broken on purpose, for phase 35's bit-equality
    gate to reject: the kernel on this rank's output channels without the
    bias, gathered, then the whole bias added in the compute dtype (as
    column_parallel adds a bias after its gather) instead of the rank's
    slice in the kernel's epilogue. -> the gathered output."""
    from use_tpu_torch.parallel import sharding

    bias = conv.bias
    conv._parameters["bias"] = None
    conv._prepared = None
    try:
        y = conv.local(*args)
    finally:
        conv._parameters["bias"] = bias
        conv._prepared = None
    y = sharding.model_all_gather(y, 1, world.model_group.group_name, world.model)
    return y + bias.to(conv.dtype)[None, :, None, None]


def tp_rank_worker(tmp, device):
    """One of tp_ranks' four processes (torchrun's environment set by the
    phase): joins the gloo group, lays the ranks out as make_mesh(*TP_LAYOUT),
    shards SGMSE_Large's net (shard_params, the rule's default min_size),
    and takes one sgmse_train_step through DDP over its data group on its
    data index's clip and rows of the global draws with the summing gather
    backward (the control, and the warm-up), then the step itself from the
    same weights. Saves each step's loss, seconds, launches, peak memory and
    the bytes gathered and all-reduced over the model group, and this
    rank's weights after the step; rank 0 also the gradient the optimizer
    applied (after the clip) gathered whole, the weights after the step
    gathered whole, and K2's call shapes."""
    import torch
    import torch.distributed as dist

    from use_tpu_torch import ops
    from use_tpu_torch.engine.loop import build_train_state, distribute
    from use_tpu_torch.engine.train import sgmse_train_step
    from use_tpu_torch.models.ncsnpp import layers
    from use_tpu_torch.parallel import sharding
    from use_tpu_torch.parallel.mesh import init_distributed, local_rows, make_mesh

    assert init_distributed("gloo")
    dev = torch.device(device)
    # the four ranks share the host's cores (their models are built on the CPU)
    torch.set_num_threads(max(1, (os.cpu_count() or 4) // (TP_LAYOUT[0] * TP_LAYOUT[1])))
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    world = make_mesh(*TP_LAYOUT)
    model, cfg = _train_model(torch, dev, num_frames=TP_FRAMES)
    batch, (start, t, z) = _train_batch(torch, model, TP_LAYOUT[0])
    net = model.score_net
    sharding.shard_params(net, world)
    init = {k: v.clone() for k, v in net.state_dict().items()}
    names = sharding.sharded_parameters(net)
    k2_shapes = {}
    k2 = layers.fused_skip_add

    def counted_k2(x, h, w, b, scale):
        key = str([x.shape[0], x.shape[1], h.shape[1], x.shape[2], x.shape[3]])
        k2_shapes[key] = k2_shapes.get(key, 0) + 1
        return k2(x, h, w, b, scale)

    local = {k: local_rows(v, world).to(dev) for k, v in batch.items()}
    draws = [(start, local_rows(t, world), local_rows(z, world))]
    tc = cfg["train"]
    out = {"rank": dist.get_rank(), "data_rank": world.rank, "model_rank": world.model_rank,
           "sharded": sorted(names), "k2_shapes": k2_shapes}
    ddp = None
    for run in ("summing", "step"):
        net.load_state_dict(init)
        state = build_train_state(model, tc["lr"], tc["weight_decay"], TP_GRAD_CLIP)
        if ddp is None:
            distribute(state, world, dev)
            ddp = state.ddp
        else:
            state.world, state.ddp = world, ddp
        seen = {}
        real = state.optimizer.step

        def step(*a, **kw):
            seen.update({k: p.grad.detach().clone() for k, p in net.named_parameters()
                         if p.grad is not None})
            return real(*a, **kw)

        state.optimizer.step = step
        ops.reset_launch_counts()
        for k in sharding.model_bytes:
            sharding.model_bytes[k] = 0
        torch.cuda.reset_peak_memory_stats(dev)
        layers.fused_skip_add = counted_k2 if run == "step" else k2
        dist.barrier()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with summing_gather_backward() if run == "summing" else contextlib.nullcontext():
            metrics = sgmse_train_step(model, state, [local], draws=draws)
        torch.cuda.synchronize(dev)
        res = {"step_s": time.perf_counter() - t0, "loss": float(metrics["loss_Score"]),
               "launches": ops.launch_counts(), "bytes": dict(sharding.model_bytes),
               "peak_bytes": torch.cuda.max_memory_allocated(dev)}
        layers.fused_skip_add = k2
        grads = sharding.gather_slices(net, seen, world)
        if run == "step":
            weights = sharding.gather_state_dict(net, world)
            res["local"] = {k: p.detach().to("cpu", copy=True) for k, p in net.named_parameters()}
        if out["rank"] == 0:  # every rank gathers the same whole tensors
            res["grads"] = {k: g.cpu() for k, g in grads.items()}
            if run == "step":
                res["weights"] = {k: v.to("cpu", copy=True) for k, v in weights.items()}
        out[run] = res
        del grads, seen
    del model, net, state, ddp, init
    torch.cuda.empty_cache()
    out.update(_tp_gan_worker(torch, dev, world, out["rank"] == 0))
    out.update(_tp_int8_worker(torch, dev, world))
    torch.save(out, os.path.join(tmp, f"rank{out['rank']}.pt"))
    dist.destroy_process_group()


@contextlib.contextmanager
def _recorded_branches(torch):
    """Each leaky ReLU of the discriminators and each PReLU, in call order:
    their branches (x > 0), and each mel spectrogram the mel bank takes,
    kept on the device (a copy to the host would sit inside the timed
    step). -> {"lrelu": [...], "prelu": [...], "mel": [...]}."""
    import torch.nn.functional as F

    from use_tpu_torch.models.gan import discriminators as disc

    real_lrelu, real_prelu, real_mel = disc._lrelu, F.prelu, disc.melspectrogram
    rec = {"lrelu": [], "prelu": [], "mel": []}

    def lrelu(x):
        rec["lrelu"].append(x > 0)
        return real_lrelu(x)

    def prelu(x, weight):
        rec["prelu"].append(x > 0)
        return real_prelu(x, weight)

    def melspectrogram(x, cfg):
        m = real_mel(x, cfg)
        rec["mel"].append(m.detach().clone())
        return m

    disc._lrelu, F.prelu, disc.melspectrogram = lrelu, prelu, melspectrogram
    try:
        yield rec
    finally:
        disc._lrelu, F.prelu, disc.melspectrogram = real_lrelu, real_prelu, real_mel


def _digest(t):
    import hashlib

    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()


def _tp_gan_runs(torch, dev, world, gan, tc, local, start, runs, rank0):
    """gan_train_step of `gan` (both nets cut) on this rank's rows `local`
    through DDP over the data group, once for each of `runs` ("summing":
    the control, "step"), each from the same weights. -> {run: the losses,
    seconds, launches, bytes over the model group and peak memory; rank 0
    the applied gradients gathered whole; "step": each parameter's digest,
    model rank 0 the branches of its leaky ReLUs and PReLUs and its mel
    spectrograms, rank 0 the weights after the steps gathered whole}."""
    import torch.distributed as dist

    from use_tpu_torch import ops
    from use_tpu_torch.engine.loop import build_gan_train_state, distribute
    from use_tpu_torch.engine.train import gan_train_step
    from use_tpu_torch.parallel import sharding

    nets = {"G": gan.generator.net, "D": gan.discriminator}
    init = {k: {n: v.clone() for n, v in net.state_dict().items()} for k, net in nets.items()}
    out = {"sharded": {k: sorted(sharding.sharded_parameters(net)) for k, net in nets.items()}}
    ddps = None
    for run in runs:
        for k, net in nets.items():
            net.load_state_dict(init[k])
        state = build_gan_train_state(gan, tc["g_lr"], tc["d_lr"], tc["weight_decay"])
        states = {"G": state.g, "D": state.d}
        if ddps is None:
            distribute(state.g, world, dev,
                       getattr(gan.generator, "ddp_find_unused_parameters", False))
            distribute(state.d, world, dev)
            ddps = {k: st.ddp for k, st in states.items()}
        for k, st in states.items():
            st.world, st.ddp = world, ddps[k]
        seen = {}
        for k, st in states.items():
            real = st.optimizer.step

            def step(*a, k=k, st=st, real=real, **kw):
                seen[k] = {n: p.grad.detach().clone() for n, p in st.model.named_parameters()
                           if p.grad is not None}
                return real(*a, **kw)

            st.optimizer.step = step
        ops.reset_launch_counts()
        for k in sharding.model_bytes:
            sharding.model_bytes[k] = 0
        torch.cuda.reset_peak_memory_stats(dev)
        dist.barrier()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with summing_gather_backward() if run == "summing" else contextlib.nullcontext(), \
                _recorded_branches(torch) as branches:
            metrics = gan_train_step(gan, state, [local], starts=[start])
        torch.cuda.synchronize(dev)
        res = {"step_s": time.perf_counter() - t0,
               "metrics": {k: float(v) for k, v in metrics.items()},
               "launches": ops.launch_counts(), "bytes": dict(sharding.model_bytes),
               "peak_bytes": torch.cuda.max_memory_allocated(dev)}
        grads = {k: sharding.gather_slices(net, seen[k], world) for k, net in nets.items()}
        if run == "step":
            res["digests"] = {k: {n: _digest(p) for n, p in net.named_parameters()}
                              for k, net in nets.items()}
            weights = {k: sharding.gather_state_dict(net, world) for k, net in nets.items()}
            if world.model_rank == 0:
                res["branches"] = {k: [m.cpu() for m in v] for k, v in branches.items()}
            if rank0:
                res["weights"] = {k: {n: v.to("cpu", copy=True) for n, v in w.items()}
                                  for k, w in weights.items()}
        if rank0:
            res["grads"] = {k: {n: g.cpu() for n, g in v.items()} for k, v in grads.items()}
        out[run] = res
        del grads, seen, branches
    for k, net in nets.items():
        net.load_state_dict(init[k])
    return out


def _tp_csmgan(torch, dev, discriminator):
    """The CSMGAN recipe on the card with `discriminator` (the LSGAN
    recipe's bank, so that one bank serves both tasks in phase 35)."""
    from use_tpu_torch.cli.main import _build_model
    from use_tpu_torch.config.config import load_config

    cfg = load_config(CSMGAN_EXPERIMENT)
    gan = _build_model(cfg, str(dev))
    gan.discriminator = discriminator
    return gan, cfg


def _tp_gan_worker(torch, dev, world, rank0):
    """tp_rank_worker's GAN tasks, each the summing control (the warm-up)
    then the step: the LSGAN recipe at TP_GAN_FRAMES and CSMGAN on
    TP_CSMGAN_S clips, G and D cut (shard_params), this rank's data
    index's clip."""
    from use_tpu_torch.parallel import sharding
    from use_tpu_torch.parallel.mesh import local_rows

    gan, cfg = _gan_model(torch, dev)
    gen = gan.generator
    _crop(gen, TP_GAN_FRAMES)
    for net in (gen.net, gan.discriminator):
        sharding.shard_params(net, world)
    batch, start = _gan_batch(torch, gan, TP_LAYOUT[0])
    local = {k: local_rows(v, world).to(dev) for k, v in batch.items()}
    out = {"lsgan": _tp_gan_runs(torch, dev, world, gan, cfg["train"], local, start,
                                 ("summing", "step"), rank0)}
    d = gan.discriminator
    del gan, gen
    torch.cuda.empty_cache()
    csm, ccfg = _tp_csmgan(torch, dev, d)
    sharding.shard_params(csm.generator.net, world)
    clean, noisy = _csmgan_pairs(TP_LAYOUT[0], TP_CSMGAN_S)
    local = {k: local_rows(torch.from_numpy(v), world).to(dev)
             for k, v in (("clean", clean), ("perturbed", noisy))}
    out["csmgan"] = _tp_gan_runs(torch, dev, world, csm, ccfg["train"], local, 0,
                                 ("summing", "step"), rank0)
    return out


def _tp_int8_worker(torch, dev, world):
    """tp_rank_worker's int8 serving: for each quant of TP_INT8_RUNS, the
    full-width bf16 ncsnpplarge uncut and cut (shard_params, the rule's
    default min_size) from one seeded state, each forward on this data
    rank's lane under inference mode; the cut forward's launches, every
    cut int8 conv's call against the uncut conv's (check_cut_int8_calls),
    the forwards' largest difference. Then HiFi-GAN's generator (full
    width, fp32) uncut and with its convs, transposed ones included, cut.
    Every rank returns its own readings."""
    from use_tpu_torch import ops
    from use_tpu_torch.models import BackboneRegistry
    from use_tpu_torch.models.gan.hifigan_vocoder import HifiganGenerator
    from use_tpu_torch.models.ncsnpp.ncsnpp import cast_backbone_for_inference
    from use_tpu_torch.parallel import sharding
    from use_tpu_torch.parallel.mesh import local_rows

    t_worker = time.perf_counter()
    gen = torch.Generator().manual_seed(TP_INT8_SEED)
    x = local_rows(0.5 * torch.randn(TP_INT8_SHAPE, generator=gen), world).to(dev)
    t = local_rows(torch.linspace(0.2, 0.8, TP_INT8_SHAPE[0]), world).to(dev)
    state = None
    out = {}
    for quant in TP_INT8_RUNS:
        nets = []
        for _ in range(2):  # uncut, cut: built outside inference mode, as the CLI builds them
            net = BackboneRegistry.get_by_name(FORWARD_BACKBONE)(
                input_channels=4, dtype="bfloat16", quant=quant)
            if state is None:
                _randomize(torch, net, seed=TP_INT8_SEED)
                state = {k: v.clone() for k, v in net.state_dict().items()}
            net.load_state_dict(state)
            nets.append(net.to(dev))
        uncut, cut = nets
        sharded = sharding.shard_params(cut, world)
        for net in nets:
            cast_backbone_for_inference(net)
        names = {id(m): n for n, m in cut.named_modules()}
        calls = []
        with torch.inference_mode():
            ops.reset_launch_counts()
            y_uncut = uncut(x, t)
            uncut_launches = ops.launch_counts()
            ops.reset_launch_counts()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            with cut_int8_calls(calls):
                y = cut(x, t)
            torch.cuda.synchronize(dev)
            first_s = time.perf_counter() - t0
            launches = ops.launch_counts()
            t0 = time.perf_counter()
            cut(x, t)
            torch.cuda.synchronize(dev)
            warm_s = time.perf_counter() - t0
            checked = check_cut_int8_calls(torch, calls, uncut, names, world)
            top = float(y_uncut.float().abs().max())
            out[quant] = {
                "launches": launches, "one_process_launches": uncut_launches,
                "calls": checked, "finite": bool(torch.isfinite(y).all()),
                "max_rel_err": float((y.float() - y_uncut.float()).abs().max()) / top,
                "sharded_weights": sum(a is not None for a in sharded.values()),
                "first_forward_s": first_s, "forward_s": warm_s}
        del nets, uncut, cut, calls, y, y_uncut
        torch.cuda.empty_cache()
    frames = torch.randn((1, 80, TP_HIFIGAN_FRAMES), generator=gen).to(dev)
    hifigan = [HifiganGenerator(seed=TP_INT8_SEED).to(dev) for _ in range(2)]
    plan = sharding.shard_params(hifigan[1], world)
    with torch.inference_mode():
        wav_uncut, wav = (net(frames) for net in hifigan)
    transposed = [k for k, axis in plan.items() if axis == 1]
    out["hifigan"] = {
        "shape": list(frames.shape), "sharded_weights": sum(a is not None for a in plan.values()),
        "transposed_cut": len(transposed), "samples": wav.shape[-1],
        "finite": bool(torch.isfinite(wav).all()),
        "max_rel_err": float((wav - wav_uncut).abs().max()) / float(wav_uncut.abs().max())}
    del hifigan
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_worker
    return {"int8": out}


def _tp_int8_check(ranks, smi):
    """Phase 35's int8 serving and HiFi-GAN gates on every rank's readings
    (_tp_int8_worker); prints their line. -> the launches of rank 0's cut
    forwards, by run label."""
    failed = []
    for r in ranks:
        for quant, label in TP_INT8_RUNS.items():
            got = r["int8"][quant]
            want = all_kernels(PER_FORWARD[label])
            if all_kernels(got["launches"]) != want or \
                    all_kernels(got["one_process_launches"]) != want:
                failed.append(f"rank {r['rank']} {quant}: launches {got['launches']}, "
                              f"one process {got['one_process_launches']}, want {want}")
            calls = got["calls"]
            if any(k["bit_equal"] != k["calls"] for k in calls.values()) or not calls:
                failed.append(f"rank {r['rank']} {quant}: gathered outputs not bit-equal {calls}")
            fused = calls.get("FusedQConv3x3")
            if fused and fused["control_bit_equal"] == fused["calls"]:
                failed.append(f"rank {r['rank']} {quant}: the bias-after-gather control passed")
            if not (got["finite"] and got["max_rel_err"] <= BF16_REL_TOL):
                failed.append(f"rank {r['rank']} {quant}: forward off by {got['max_rel_err']}")
        hifigan = r["int8"]["hifigan"]
        if not (hifigan["finite"] and hifigan["transposed_cut"]
                and hifigan["max_rel_err"] <= ZOO_REL_TOL):
            failed.append(f"rank {r['rank']} hifigan: {hifigan}")
    phase("tp_ranks_int8", backbone=FORWARD_BACKBONE, dtype="bfloat16",
          layout={"data": TP_LAYOUT[0], "model": TP_LAYOUT[1]}, backend="gloo",
          shape=list(TP_INT8_SHAPE), lanes_a_data_rank=1, tol=BF16_REL_TOL,
          control="bias added after the gather in bf16", nvidia_smi=smi,
          ranks={str(r["rank"]): {q: {k: v for k, v in r["int8"][q].items()
                                      if k != "one_process_launches"} for q in TP_INT8_RUNS}
                 for r in ranks},
          hifigan={str(r["rank"]): r["int8"]["hifigan"] for r in ranks},
          hifigan_tol=ZOO_REL_TOL, worker_seconds=[r["int8"]["seconds"] for r in ranks],
          failed=failed)
    if failed:
        raise AssertionError("tp_ranks_int8: " + "; ".join(failed))
    return {f"tp_{label}": all_kernels(ranks[0]["int8"][quant]["launches"])
            for quant, label in TP_INT8_RUNS.items()}


def tp_ranks_phase(torch, dev):
    """Phase 35: four ranks share the card through gloo as make_mesh(data=2,
    model=2), one sharded sgmse_train_step each (tp_rank_worker), against
    the one-process unsharded step on the card over the same clips and
    draws; -> rank 0's launches. Gates in the module docstring. The timed
    steps are each process's second (the control warms the ranks up, a
    step from the same weights the one process); the first beside them."""
    from use_tpu_torch import ops
    from use_tpu_torch.engine.loop import build_train_state
    from use_tpu_torch.engine.train import sgmse_train_step

    n = TP_LAYOUT[0] * TP_LAYOUT[1]
    t_ranks = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as tmp:
        port = _free_port()
        procs = []
        for rank in range(n):
            env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": str(n), "LOCAL_RANK": "0",
                   "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}
            procs.append(subprocess.Popen(
                [sys.executable, sys.argv[0], "--tp-rank-worker", tmp, str(dev)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        with _reaping(procs):
            logs = [p.communicate(timeout=600)[0] for p in procs]
        if any(p.returncode for p in procs):
            raise AssertionError("tp_ranks: a rank failed:\n" + "\n".join(
                log[-4000:] for log in logs))
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(n)]
    ranks_s = time.perf_counter() - t_ranks
    model, cfg = _train_model(torch, dev, num_frames=TP_FRAMES)
    batch, draws = _train_batch(torch, model, TP_LAYOUT[0])
    batch = {k: v.to(dev) for k, v in batch.items()}
    tc = cfg["train"]
    lr = tc["lr"]
    init = {k: v.clone() for k, v in model.score_net.state_dict().items()}
    seen, one_s = {}, []
    for _ in range(2):  # a warm-up step, then the reference from the same weights
        model.score_net.load_state_dict(init)
        state = build_train_state(model, lr, tc["weight_decay"], TP_GRAD_CLIP)
        real = state.optimizer.step

        def record(*a, **kw):
            seen.update({k: p.grad.detach().clone() for k, p in model.score_net.named_parameters()
                         if p.grad is not None})
            return real(*a, **kw)

        state.optimizer.step = record
        ops.reset_launch_counts()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = sgmse_train_step(model, state, [batch], draws=[draws])
        torch.cuda.synchronize(dev)
        one_s.append(time.perf_counter() - t0)
    seen = {k: g.cpu() for k, g in seen.items()}
    one_launches = ops.launch_counts()
    loss = float(out["loss_Score"])
    grad_norm = math.sqrt(sum(float((g.double() ** 2).sum()) for g in seen.values()))
    key_biases = {f"{name}.NIN_1.b" for name, m in model.score_net.named_modules()
                  if type(m).__name__ == "AttnBlockpp"}
    top = max(float(g.abs().max()) for g in seen.values())
    sharded = set(ranks[0]["sharded"])
    steps = [r["step"] for r in ranks]
    # replicas within each model group (one data index), everything within
    # each data group (one model index); rank = d * model + m
    model_groups = [range(d * TP_LAYOUT[1], (d + 1) * TP_LAYOUT[1]) for d in range(TP_LAYOUT[0])]
    data_groups = [range(m, n, TP_LAYOUT[1]) for m in range(TP_LAYOUT[1])]
    replicas_equal = all(torch.equal(steps[g[0]]["local"][k], steps[r]["local"][k])
                         for g in model_groups for r in g[1:]
                         for k in steps[0]["local"] if k not in sharded)
    slices_equal = all(torch.equal(steps[g[0]]["local"][k], steps[r]["local"][k])
                       for g in data_groups for r in g[1:] for k in steps[g[0]]["local"])
    report = {}
    for run in ("step", "summing"):
        rel, _ = _grad_rel(ranks[0][run]["grads"], seen, key_biases)
        worst = max(rel, key=rel.get)
        report[run] = {"max_grad_rel_err": rel[worst], "worst_grad": worst,
                       "median_grad_rel_err": float(np.median(list(rel.values()))),
                       "loss_rel_err": abs(ranks[0][run]["loss"] - loss) / abs(loss)}
    got = steps[0]["grads"]
    key_bias = {k: [float(got[k].abs().max()) / top, float(seen[k].abs().max()) / top]
                for k in key_biases}
    step_off, sure_off = 0.0, 0.0
    for k, p in model.score_net.named_parameters():
        w, g = p.detach().cpu(), seen.get(k)
        diff = (steps[0]["weights"][k] - w).abs()
        step_off = max(step_off, float(diff.max()) / lr)
        if g is None or k in key_biases:
            continue
        sure = g.abs() > 2 * TRAIN_GRAD_REL_TOL * float(g.abs().max())
        if bool(sure.any()):
            sure_off = max(sure_off, float((diff[sure] - 1e-5 * w.abs()[sure]).max()))
    want = all_kernels(TRAIN_LAUNCHES["remat"])
    launches = [all_kernels(s["launches"]) for s in steps]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    phase("tp_ranks", experiment=TRAIN_EXPERIMENT,
          layout={"data": TP_LAYOUT[0], "model": TP_LAYOUT[1]}, backend="gloo",
          frames=TP_FRAMES, clips_a_data_rank=1, grad_clip=TP_GRAD_CLIP,
          sharded_weights=len(sharded), nvidia_smi=smi,
          ranks=[[r["rank"], r["data_rank"], r["model_rank"]] for r in ranks],
          losses=[s["loss"] for s in steps], loss_one_process=loss,
          grad_tol=TRAIN_GRAD_REL_TOL, applied_grad_norm=grad_norm, step=report["step"],
          summing_control=report["summing"],
          key_bias_grads_over_top=key_bias, max_weight_step_over_lr=step_off,
          max_sure_weight_err=sure_off, replicas_bit_identical=replicas_equal,
          slices_bit_identical=slices_equal, launches=launches,
          one_process_launches=all_kernels(one_launches),
          step_seconds=[s["step_s"] for s in steps],
          first_step_seconds=[r["summing"]["step_s"] for r in ranks],
          one_process_step_seconds=one_s[1], one_process_first_step_seconds=one_s[0],
          ranks_wall_seconds=ranks_s,
          model_group_bytes=[s["bytes"] for s in steps],
          peak_memory_bytes=[s["peak_bytes"] for s in steps], k2_shapes=ranks[0]["k2_shapes"])
    if not (replicas_equal and slices_equal):
        raise AssertionError(f"tp_ranks: replicas equal {replicas_equal}, "
                             f"slices equal {slices_equal}")
    if any(lc != want for lc in launches):
        raise AssertionError(f"tp_ranks: launches {launches}, want {want} on every rank")
    if not (report["step"]["max_grad_rel_err"] <= TRAIN_GRAD_REL_TOL
            and report["step"]["loss_rel_err"] <= TRAIN_GRAD_REL_TOL
            and max(max(v) for v in key_bias.values()) <= KEY_BIAS_GRAD_FLOOR):
        raise AssertionError(f"tp_ranks: {report['step']}, key biases {key_bias}")
    if not (sure_off <= 1e-7 and step_off <= 2 * (1 + 1e-5)):
        raise AssertionError(f"tp_ranks: weights off by {sure_off} (sure gradients), "
                             f"{step_off} lr (any)")
    if report["summing"]["max_grad_rel_err"] <= TRAIN_GRAD_REL_TOL:
        raise AssertionError(f"tp_ranks: the summing-backward control passed: {report}")
    del model, state, seen, steps
    torch.cuda.empty_cache()
    _tp_gan_check(torch, dev, ranks, smi)
    return {"tp_ranks": launches[0], **_tp_int8_check(ranks, smi)}


def _tp_gan_reference(torch, dev, gan, tc, batch, start, ranks, task):
    """The one-process unsharded gan_train_step of `task` on the card over
    both data ranks' clips, twice from the same weights: "warm" (timed),
    then "check": each leaky ReLU and PReLU on the branch the ranks took
    and each mel spectrogram of the mel bank at the ranks' values (the
    model rank 0 of each data index recorded its clip's: a pre-activation
    within rounding of 0, or a near-null mel bin under log(mel + 1e-5),
    reads the rounding of the convs that the cut splits otherwise), and
    the G phase against the D the ranks stepped (their gathered weights
    loaded after this process's own D step, which is kept for the weight
    gate).
    -> the losses, applied gradients (D. / G.), weights after the steps,
    own D step, launches, seconds and the replays' flips."""
    from use_tpu_torch import ops
    from use_tpu_torch.engine.loop import build_gan_train_state
    from use_tpu_torch.engine.train import gan_train_step

    nets = {"G": gan.generator.net, "D": gan.discriminator}
    init = {k: {n: v.clone() for n, v in net.state_dict().items()} for k, net in nets.items()}
    heads = [ranks[d * TP_LAYOUT[1]][task]["step"]["branches"] for d in range(TP_LAYOUT[0])]
    replay = {k: [torch.cat(ms) for ms in zip(*(h[k] for h in heads))] for k in heads[0]}
    ranks_d = ranks[0][task]["step"]["weights"]["D"]
    mb = {k: v.to(dev) for k, v in batch.items()}
    out = {"seconds": {}}
    for run in ("warm", "check"):
        for k, net in nets.items():
            net.load_state_dict(init[k])
        state = build_gan_train_state(gan, tc["g_lr"], tc["d_lr"], tc["weight_decay"])
        seen, own_d = {}, {}
        for k, st in (("G", state.g), ("D", state.d)):
            real = st.optimizer.step

            def step(*a, k=k, st=st, real=real, **kw):
                seen.update({f"{k}.{n}": p.grad.detach().cpu().clone()
                             for n, p in st.model.named_parameters() if p.grad is not None})
                return real(*a, **kw)

            st.optimizer.step = step
        real_apply = state.d.apply_gradients

        def apply_d(run=run, real_apply=real_apply):
            real_apply()
            own_d.update({n: p.detach().cpu().clone()
                          for n, p in gan.discriminator.named_parameters()})
            if run == "check":
                with torch.no_grad():
                    for n, p in gan.discriminator.named_parameters():
                        p.copy_(ranks_d[n].to(dev))

        state.d.apply_gradients = apply_d
        ops.reset_launch_counts()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with contextlib.ExitStack() as replays:
            if run == "check":
                lrelus = replays.enter_context(lrelu_branches(torch, replay["lrelu"]))
                prelus = replays.enter_context(prelu_branches(torch, replay["prelu"]))
                replays.enter_context(mel_inputs(torch, replay["mel"]))
            metrics = gan_train_step(gan, state, [mb], starts=[start])
        torch.cuda.synchronize(dev)
        out["seconds"][run] = time.perf_counter() - t0
    out.update(metrics={k: float(v) for k, v in metrics.items()}, grads=seen, own_d=own_d,
               weights={k: {n: p.detach().cpu().clone() for n, p in net.named_parameters()}
                        for k, net in nets.items()},
               launches=ops.launch_counts(),
               flips={"lrelu": [lrelus["flips"], lrelus["elements"]],
                      "prelu": [prelus["flips"], prelus["elements"]]})
    for k, net in nets.items():
        net.load_state_dict(init[k])
    return out


def _weights_off(got, want, grads, lr, prefix, skip=()):
    """(the largest |difference| where the gradient is sure, less 1e-5 of
    the weight; the largest in lr; the names of both) of the weights `got`
    against `want`, as phase 34's gate reads them, a gradient being sure
    where it is also above ADAM_SURE_FLOOR; the gradients named in `skip`
    (the attention's key biases, 0 up to rounding) are never sure."""
    sure_off = step_off = 0.0
    worst = [None, None]
    for n, w in want.items():
        diff = (got[n] - w).abs()
        if float(diff.max()) / lr > step_off:
            step_off, worst[1] = float(diff.max()) / lr, n
        g = grads.get(f"{prefix}.{n}")
        if g is None or f"{prefix}.{n}" in skip:
            continue
        sure = (g.abs() > 2 * TRAIN_GRAD_REL_TOL * float(g.abs().max())) & \
            (g.abs() > ADAM_SURE_FLOOR)
        if bool(sure.any()):
            off = float((diff[sure] - 1e-5 * w.abs()[sure]).max())
            if off > sure_off:
                sure_off, worst[0] = off, n
    return sure_off, step_off, worst


def _tp_gan_task(torch, dev, ranks, task, gan, tc, batch, start, key_biases, want_launches, smi):
    """Phase 35's gates on one GAN task: the ranks' step against the
    one-process reference (_tp_gan_reference); prints the task's line.
    -> the failures."""
    t0 = time.perf_counter()
    ref = _tp_gan_reference(torch, dev, gan, tc, batch, start, ranks, task)
    ref_s = time.perf_counter() - t0
    res = [r[task] for r in ranks]
    step = res[0]["step"]
    got = {f"{k}.{n}": g for k, v in step["grads"].items() for n, g in v.items()}
    rel, key_bias = _gan_grad_errors(got, ref["grads"], key_biases)
    worst = max(rel, key=rel.get)
    failed = []
    loss_errs = {k: abs(v - ref["metrics"][k]) / max(abs(ref["metrics"][k]), 1e-30)
                 for k, v in step["metrics"].items()}
    for k, e in loss_errs.items():
        tol = 1e-3 if k in ("loss_G", "loss_G_mag_log", "loss_G_mel_log") else 1e-4
        if not e <= tol:
            failed.append(f"{k} off by {e} (tol {tol})")
    if any(r["step"]["metrics"] != step["metrics"] for r in res):
        failed.append("the ranks report different losses")
    tol = TRAIN_GRAD_REL_TOL if task == "lsgan" else TP_CSMGAN_GRAD_REL_TOL
    if not rel[worst] <= tol:
        failed.append(f"gradient {worst} off by {rel[worst]} (tol {tol})")
    if key_bias and not max(max(v) for v in key_bias.values()) <= KEY_BIAS_GRAD_FLOOR:
        failed.append(f"attention key-bias gradients {key_bias}")
    t = {"G": tc["g_lr"], "D": tc["d_lr"]}
    off = {"D": _weights_off(step["weights"]["D"], ref["own_d"], ref["grads"], t["D"], "D"),
           "G": _weights_off(step["weights"]["G"], ref["weights"]["G"], ref["grads"], t["G"], "G",
                             key_biases)}
    for k, (sure_off, step_off, _) in off.items():
        if not (sure_off <= 1e-7 and step_off <= 2 * (1 + 1e-5)):
            failed.append(f"{k} weights off by {sure_off} (sure gradients), {step_off} lr (any)")
    # replicas within each model group, everything within each data group
    n, m = len(ranks), TP_LAYOUT[1]
    digests = [r["step"]["digests"] for r in res]
    replicas_equal = slices_equal = True
    for k in ("G", "D"):
        cut = set(res[0]["sharded"][k])
        for d in range(TP_LAYOUT[0]):
            for r in range(d * m + 1, (d + 1) * m):
                replicas_equal &= all(digests[r][k][p] == digests[d * m][k][p]
                                      for p in digests[0][k] if p not in cut)
        for j in range(m):
            slices_equal &= all(digests[r][k] == digests[j][k] for r in range(j, n, m))
    if not (replicas_equal and slices_equal):
        failed.append(f"replicas equal {replicas_equal}, slices equal {slices_equal}")
    want = all_kernels(want_launches)
    launches = [all_kernels(r["step"]["launches"]) for r in res]
    if any(lc != want for lc in launches) or all_kernels(ref["launches"]) != want:
        failed.append(f"launches {launches} (one process {ref['launches']}), want {want}")
    control = None
    if "summing" in res[0]:
        got = {f"{k}.{n}": g for k, v in res[0]["summing"]["grads"].items()
               for n, g in v.items()}
        crel, _ = _gan_grad_errors(got, ref["grads"], key_biases)
        cworst = max(crel, key=crel.get)
        control = {"max_grad_rel_err": crel[cworst], "worst_grad": cworst}
        if crel[cworst] <= tol:
            failed.append(f"the summing-backward control passed: {control}")
    phase("tp_ranks_gan", task=task, layout={"data": TP_LAYOUT[0], "model": TP_LAYOUT[1]},
          backend="gloo", nvidia_smi=smi, clips_a_data_rank=1,
          samples=int(batch["clean"].shape[-1]), crop_start=start,
          frames=TP_GAN_FRAMES if task == "lsgan" else None,
          sharded_weights={k: len(v) for k, v in res[0]["sharded"].items()},
          losses=step["metrics"], losses_one_process=ref["metrics"], loss_rel_errs=loss_errs,
          grad_tol=tol, max_grad_rel_err=rel[worst], worst_grad=worst,
          median_grad_rel_err=float(np.median(list(rel.values()))), grads_checked=len(rel),
          worst_grads=dict(sorted(rel.items(), key=lambda kv: -kv[1])[:6]),
          key_bias_grads_over_top=key_bias, summing_control=control,
          weights_off={k: {"sure": v[0], "step_over_lr": v[1], "worst": v[2]}
                       for k, v in off.items()},
          replay_flips=ref["flips"], replicas_bit_identical=replicas_equal,
          slices_bit_identical=slices_equal, launches=launches,
          one_process_launches=all_kernels(ref["launches"]),
          step_seconds=[r["step"]["step_s"] for r in res],
          first_step_seconds=[r["summing"]["step_s"] for r in res] if control else None,
          one_process_step_seconds=ref["seconds"]["warm"],
          one_process_replayed_step_seconds=ref["seconds"]["check"], reference_seconds=ref_s,
          model_group_bytes=[r["step"]["bytes"] for r in res],
          peak_memory_bytes=[r["step"]["peak_bytes"] for r in res])
    return [f"tp_ranks {task}: {f}" for f in failed]


def _tp_gan_check(torch, dev, ranks, smi):
    """Phase 35's GAN tasks against the one-process unsharded steps on the
    card: the LSGAN recipe at TP_GAN_FRAMES, then CSMGAN on the same bank
    from its initial weights (its gradients held to
    TP_CSMGAN_GRAD_REL_TOL)."""
    gan, cfg = _gan_model(torch, dev)
    gen = gan.generator
    _crop(gen, TP_GAN_FRAMES)
    batch, start = _gan_batch(torch, gan, TP_LAYOUT[0])
    key_biases = {f"G.{name}.NIN_1.b" for name, m in gen.net.named_modules()
                  if type(m).__name__ == "AttnBlockpp"}
    failed = _tp_gan_task(torch, dev, ranks, "lsgan", gan, cfg["train"], batch, start,
                          key_biases, GAN_TRAIN_LAUNCHES["remat"], smi)
    d = gan.discriminator
    del gan, gen
    torch.cuda.empty_cache()
    csm, ccfg = _tp_csmgan(torch, dev, d)
    clean, noisy = _csmgan_pairs(TP_LAYOUT[0], TP_CSMGAN_S)
    batch = {"clean": torch.from_numpy(clean), "perturbed": torch.from_numpy(noisy)}
    failed += _tp_gan_task(torch, dev, ranks, "csmgan", csm, ccfg["train"], batch, 0, set(),
                           NO_LAUNCHES, smi)
    del csm, d, ranks
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError("; ".join(failed))


if __name__ == "__main__":
    sys.exit(main())
