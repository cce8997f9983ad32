#!/usr/bin/env python3
"""The learning gates of tests/test_learning.py, run on one device, and
repeated to see how far one run's outcome spreads.

    python3 -m use_tpu_torch.tools.learn_gate [--task sgmse|lsgan] [--device cuda]
        [--reps 1] [--deterministic]

--task lsgan runs test_lsgan_generator_learns_to_enhance instead: a tiny
generator (ncsnpp nf 32, ch_mult (1, 1), one block) against a period
bank at 2 and 3, through fit_lsgan for 500 steps (g_lr 5e-4, d_lr 1e-4,
unit wav-L1 and feature-matching weights) on 12 probes at 0 dB SNR; the
gate is a mean SI-SDR gain of the two held-out probes above 1 dB.

A run trains a tiny score net (ncsnpp nf 24, ch_mult (1, 1), one block)
with fit_sgmse for 600 steps at lr 2e-3 on 12 synth_speech probes, then
enhances two held-out probes with N=30 and reports the SI-SDR gain of the
enhanced over the noisy input (the gate is a mean gain above 2 dB). The
weights and the training draws are seeded 0 as there, the draws from a
CPU generator on either device.
--deterministic runs the card with deterministic algorithms (cuDNN,
cuBLAS with CUBLAS_WORKSPACE_CONFIG=:4096:8), so that repeated runs give
the same trajectory. Prints one JSON line a run, then the card's name and
power limit on a GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

STEPS, POOL, BATCH = 600, 12, 4
HOP, N_FFT, FRAMES = 32, 126, 32
LENGTH = (FRAMES - 1) * HOP
HELDOUT_SEEDS = (100, 101)
SEED = 0
GATE_DB = 2.0
GAN_STEPS, GAN_GATE_DB, GAN_SNR_DB = 500, 1.0, 0.0


class FixedPairs:
    """tests/test_learning.py's toy corpus: a pool of (clean, noisy)
    synth_speech pairs served batch 4 in rotation."""

    def __init__(self, length, steps_per_epoch, snr_db=5.0, pool=POOL):
        from use_tpu_torch.data.synth_speech import synth_pair

        self._steps = steps_per_epoch
        pairs = [synth_pair(length, s, snr_db=snr_db, sr=24000) for s in range(pool)]
        self._clean = np.stack([p[0] for p in pairs])
        self._noisy = np.stack([p[1] for p in pairs])
        self._pool = pool

    def train_dataloader(self):
        idx = 0
        for _ in range(self._steps):
            sel = [(idx + j) % self._pool for j in range(BATCH)]
            idx = (idx + BATCH) % self._pool
            yield {"clean": self._clean[sel], "perturbed": self._noisy[sel]}

    def val_dataloader(self):
        yield {"clean": self._clean[:BATCH], "perturbed": self._noisy[:BATCH]}


def learn_run(torch, device):
    """One run of the gate's recipe on `device`: -> its optimizer
    steps, fit seconds, first and last epoch's loss and the SI-SDR gains
    (dB) of the held-out probes, each and their mean."""
    from use_tpu_torch.data.synth_speech import synth_pair
    from use_tpu_torch.engine.loop import fit_sgmse
    from use_tpu_torch.models.sgmse.score_model import ScoreModel
    from use_tpu_torch.utils.metrics import si_sdr

    dev = torch.device(device)
    model = ScoreModel(backbone="ncsnpp", sde="ouve", condition="noisy", sde_input="noisy",
                       n_fft=N_FFT, hop_length=HOP, num_frames=FRAMES,
                       backbone_kwargs=dict(nf=24, ch_mult=(1, 1), num_res_blocks=1),
                       device=dev, seed=SEED)
    t0 = time.perf_counter()
    res = fit_sgmse(model, FixedPairs(LENGTH, steps_per_epoch=STEPS // 12), lr=2e-3,
                    accumulate_grad_batches=1, max_epochs=12, seed=SEED,
                    scheduler={"step_size": 1000, "gamma": 1.0})
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    fit_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(1)
    gains = []
    for s in HELDOUT_SEEDS:
        clean, noisy = synth_pair(LENGTH, s, snr_db=5.0, sr=24000)
        out = model.sample({"perturbed": torch.from_numpy(noisy[None]).to(dev)}, gen, N=30)
        enhanced = out["enhanced"][0].float().cpu().numpy()
        gains.append(si_sdr(clean, enhanced) - si_sdr(clean, noisy))
    return dict(seed=SEED, steps=res.steps, fit_seconds=fit_s,
                loss_first_epoch=res.history[0]["train/loss_Score"],
                loss_last_epoch=res.history[-1]["train/loss_Score"],
                gains_db=gains, gain_db=float(np.mean(gains)))


def gan_gate_model(torch, device):
    """The LSGAN gate's model on `device`: the tiny generator, the period
    bank at 2 and 3 as D, unit wav-L1 and feature-matching weights, all
    seeded SEED."""
    from use_tpu_torch.models.gan.discriminators import MultiPeriodDiscriminator, reset_parameters
    from use_tpu_torch.models.gan.generator import NCSNPPWrapper
    from use_tpu_torch.models.gan.lsgan import LSGAN

    class TinyMPD(torch.nn.Module):
        """The gate's D: the period bank at 2 and 3, [bank][disc] lists."""

        def __init__(self):
            super().__init__()
            self.MPD = MultiPeriodDiscriminator(periods=(2, 3))
            reset_parameters(self, torch.Generator().manual_seed(SEED))

        def forward(self, x):
            logits, fmaps = self.MPD(x)
            return [logits], [fmaps]

    gen = NCSNPPWrapper(n_fft=N_FFT, hop_length=HOP, num_frames=FRAMES,
                        backbone_kwargs=dict(nf=32, ch_mult=(1, 1), num_res_blocks=1),
                        device=device, seed=SEED)
    return LSGAN(generator=gen, discriminator=TinyMPD(),
                 g_loss_cfg=dict(sampling_rate=24000, alpha_wav_l1=1.0, alpha_adv_feat=1.0))


def gan_learn_run(torch, device):
    """One run of the LSGAN gate's recipe on `device`: -> its optimizer
    steps, fit seconds, first and last epoch's G and D losses and the SI-SDR
    gains (dB) of the held-out probes over their noisy input, each and
    their mean."""
    from use_tpu_torch.data.synth_speech import synth_pair
    from use_tpu_torch.engine.loop import fit_lsgan
    from use_tpu_torch.utils.metrics import si_sdr

    dev = torch.device(device)
    gan = gan_gate_model(torch, dev)
    t0 = time.perf_counter()
    res = fit_lsgan(gan, FixedPairs(LENGTH, steps_per_epoch=GAN_STEPS // 10, snr_db=GAN_SNR_DB),
                    g_lr=5e-4, d_lr=1e-4, accumulate_grad_batches=1, max_epochs=10, seed=SEED,
                    scheduler={"step_size": 1000, "gamma": 1.0})
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    fit_s = time.perf_counter() - t0
    gains = []
    for s in HELDOUT_SEEDS:
        clean, noisy = synth_pair(LENGTH, s, snr_db=GAN_SNR_DB, sr=24000)
        out = gan.enhance({"perturbed": torch.from_numpy(noisy[None]).to(dev)})
        gains.append(si_sdr(clean, out["fake"][0].float().cpu().numpy()) - si_sdr(clean, noisy))
    first, last = res.history[0], res.history[-1]
    return dict(seed=SEED, steps=res.steps, fit_seconds=fit_s,
                loss_G_first_epoch=first["train/loss_G"], loss_G_last_epoch=last["train/loss_G"],
                loss_D_first_epoch=first["train/loss_D"], loss_D_last_epoch=last["train/loss_D"],
                gains_db=gains, gain_db=float(np.mean(gains)))


def deterministic(torch, on: bool) -> None:
    """Deterministic algorithms on the card, or the defaults back. cuBLAS
    needs CUBLAS_WORKSPACE_CONFIG=:4096:8 set before its first call."""
    if on and os.environ.get("CUBLAS_WORKSPACE_CONFIG") != ":4096:8":
        raise RuntimeError("deterministic runs need CUBLAS_WORKSPACE_CONFIG=:4096:8 in the "
                           "environment before torch is imported")
    torch.use_deterministic_algorithms(on)
    torch.backends.cudnn.deterministic = on


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", choices=("sgmse", "lsgan"), default="sgmse")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--deterministic", action="store_true")
    args = ap.parse_args()
    if args.deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    import torch

    import use_tpu_torch.models  # noqa: F401 (registries)

    if args.device.startswith("cuda"):
        from use_tpu_torch.ops import cuda_build

        cuda_build.build_all()
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    deterministic(torch, args.deterministic)
    run_fn, gate = (learn_run, GATE_DB) if args.task == "sgmse" else (gan_learn_run, GAN_GATE_DB)
    for rep in range(args.reps):
        run = run_fn(torch, args.device)
        print(json.dumps({"rep": rep, "task": args.task, "device": args.device,
                          "deterministic": args.deterministic, **run,
                          "passed": run["gain_db"] > gate}), flush=True)
    if args.device.startswith("cuda"):
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
