"""CLI entry point of the port: predict (folder -> folder enhancement).

Port of use_tpu/cli/main.py (`_split_args`, `_build_model` for task=sgmse
and task=lsgan, `cmd_predict` with its hybrid chains, `main`):

    python -m use_tpu_torch.cli.main predict experiment=SGMSE_Large \
        [ckpt_path=weights.pt] predict.data_folder=in/ predict.target_folder=out/ \
        [infer.N=30] [infer.sampler_type=pc|parallel_pc|ode] [device=cpu]
    python -m use_tpu_torch.cli.main predict experiment=LSGAN ...
    python -m use_tpu_torch.cli.main predict experiment=SGMSE_Large \
        predict.chain=sgmse+gan predict.second_experiment=LSGAN [predict.second_ckpt=g.pt] ...
    python -m use_tpu_torch.cli.main predict experiment=LSGAN \
        predict.chain=gan+sgmse predict.second_experiment=SGMSE_Large \
        second.model.condition=both second.model.sde_input=denoised ...

Runs on CUDA unless `device=cpu`. `ckpt_path` (and `predict.second_ckpt`
for a chain's second stage) loads a torch state_dict of the backbone
(.pt): the score network for task=sgmse, the generator's NCSN++ for
task=lsgan; without one the backbone is initialized from `train.seed`.
Sampler settings go under `infer.*` (`window` and `tol` for parallel_pc),
and are read from the first experiment's config; `second.*` overrides go to
the second experiment's. On CUDA, TF32 is off for cuDNN and cuBLAS, so fp32
convolutions and matmuls run in full fp32. `train`, `eval` and
`predict.streaming` are not ported yet.
"""
from __future__ import annotations

import logging
import sys
import time
from typing import Dict, List, Optional

import torch

from use_tpu_torch.config.config import load_config

log = logging.getLogger("use_tpu_torch")

_PREDICT_KEYS = {"predict.data_folder", "predict.target_folder", "predict.chain",
                 "predict.second_experiment", "predict.second_ckpt"}
_NOT_PORTED = {"predict.streaming", "predict.chunk_frames"}
# chain -> (task of the first experiment, task of the second)
_CHAINS = {"sgmse+gan": ("sgmse", "lsgan"), "gan+sgmse": ("lsgan", "sgmse")}


def _split_args(argv: List[str]):
    experiment = None
    overrides = []
    extras: Dict[str, str] = {}
    for a in argv:
        if a.startswith("experiment="):
            experiment = a.split("=", 1)[1]
        elif a.startswith(("ckpt_path=", "device=", "predict.")):
            k, v = a.split("=", 1)
            if k in _NOT_PORTED:
                raise SystemExit(f"{k} is not ported yet (ROADMAP queue 1)")
            if k.startswith("predict.") and k not in _PREDICT_KEYS:
                raise SystemExit(
                    f"unknown key {k!r}; predict options are {sorted(_PREDICT_KEYS)} "
                    "(sampler settings go under infer.*, e.g. infer.N=30)"
                )
            extras[k] = v
        elif "=" in a:
            overrides.append(a)
        else:
            raise SystemExit(f"unrecognized argument {a!r} (use key=value)")
    if experiment is None:
        raise SystemExit("experiment=<name> is required")
    return experiment, overrides, extras


def _build_model(cfg: Dict, device: str):
    import use_tpu_torch.models  # noqa: F401 (populate the registries)
    from use_tpu_torch.models.gan.lsgan import LSGAN
    from use_tpu_torch.models.registry import GeneratorRegistry
    from use_tpu_torch.models.sgmse.score_model import ScoreModel

    seed = int(cfg["train"].get("seed", 0))
    if cfg["task"] == "sgmse":
        return ScoreModel(**dict(cfg["model"]), device=device, seed=seed)
    if cfg["task"] == "lsgan":
        gcfg = dict(cfg["model"]["generator"])
        gen_name = gcfg.pop("name", "ncsnpp_wrapper")
        gen = GeneratorRegistry.get_by_name(gen_name)(**gcfg, device=device, seed=seed)
        missing = [a for a in ("net", "target_len", "forward_infer") if not hasattr(gen, a)]
        if missing:
            raise SystemExit(
                f"model.generator.name={gen_name} resolves {type(gen).__name__}, which "
                f"lacks the LSGAN generator interface ({', '.join(missing)}); the usable "
                "generator for the GAN task is ncsnpp_wrapper"
            )
        return LSGAN(generator=gen, discriminator=cfg["model"].get("discriminator"),
                     g_loss_cfg=cfg["model"].get("g_loss"),
                     enhanced_key=cfg["model"].get("enhanced_key", "fake"))
    raise SystemExit(f"unknown task {cfg['task']}")


def _load_for_serving(model, ckpt: Optional[str]) -> None:
    """Load a backbone state_dict (.pt) into the model, strictly, then cast
    its weights for serving."""
    if ckpt:
        state = torch.load(ckpt, map_location="cpu", weights_only=True)
        net = model.score_net if hasattr(model, "score_net") else model.generator.net
        net.load_state_dict(state, strict=True)
    model.cast_params_for_inference()


def cmd_predict(experiment: str, overrides: List[str], extras: Dict[str, str]) -> Dict:
    """Folder -> folder enhancement, mirroring the input structure
    (SGMSE_module.predict_step:65-82 / GANModule.predict_step:139-155).

    Hybrid chains (README.md:174-179), with predict.second_experiment= /
    predict.second_ckpt= for stage two:
      predict.chain=sgmse+gan  SGMSE enhances, LSGAN refines the result;
      predict.chain=gan+sgmse  LSGAN's output conditions the diffusion
        (batch['fake']; needs condition=both|denoised on the SGMSE side).
    Returns a summary: files written, audio seconds, wall seconds of the
    enhancement loop and, where SGMSE sampled, its network evaluations
    (`nfe`) and, for parallel_pc, its sweeps."""
    from use_tpu_torch.data.audio_io import write_wav
    from use_tpu_torch.data.loadwav import LoadWavConfig, LoadWavDataset, predict_batches
    from use_tpu_torch.utils.device import resolve_device

    second_overrides = [o[len("second."):] for o in overrides if o.startswith("second.")]
    overrides = [o for o in overrides if not o.startswith("second.")]
    cfg = load_config(experiment, overrides)
    data_folder = extras.get("predict.data_folder")
    target_folder = extras.get("predict.target_folder")
    if not data_folder or not target_folder:
        raise SystemExit("predict.data_folder= and predict.target_folder= required")
    chain = extras.get("predict.chain")
    if chain is not None and chain not in _CHAINS:
        raise SystemExit(f"predict.chain={chain!r}; chains are {sorted(_CHAINS)}")
    if chain and "predict.second_experiment" not in extras:
        raise SystemExit(f"predict.chain={chain} needs predict.second_experiment=")
    device = resolve_device(extras.get("device", "cuda"))
    icfg = cfg.get("infer", {})
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    model = _build_model(cfg, str(device))
    _load_for_serving(model, extras.get("ckpt_path"))
    second = None
    if chain:
        second_cfg = load_config(extras["predict.second_experiment"], second_overrides)
        tasks = (cfg["task"], second_cfg["task"])
        if tasks != _CHAINS[chain]:
            raise SystemExit(f"predict.chain={chain} needs tasks {_CHAINS[chain]}, got {tasks}")
        second = _build_model(second_cfg, str(device))
        _load_for_serving(second, extras.get("predict.second_ckpt"))

    sr = int(cfg["data"].get("sampling_rate", 24000))
    dataset = LoadWavDataset(
        LoadWavConfig(data_folder=data_folder, target_folder=target_folder, sampling_rate=sr)
    )
    generator = torch.Generator(device=device).manual_seed(int(cfg["train"].get("seed", 0)))
    kw = dict(
        sampler_type=icfg.get("sampler_type", "pc"), N=int(icfg.get("N", 50)),
        corrector_steps=int(icfg.get("corrector_steps", 1)), snr=float(icfg.get("snr", 0.5)),
        **{k: icfg[k] for k in ("window", "tol") if k in icfg},
    )
    # single-utterance default: clips of >= 5 s run as overlapped chunk
    # lanes of one batched sampler call (infer.chunks, default 8); shorter
    # clips, conditioning on a GAN output ('fake'), other samplers and
    # infer.chunks=1 run full-clip.
    chunks = int(icfg.get("chunks", 8))
    counts = {"nfe": 0}  # the sampler's evaluations (and parallel_pc's sweeps) over files

    def run_sgmse(m, batch):
        wav = batch["perturbed"]
        if (chunks > 1 and wav.shape[0] == 1 and "fake" not in batch
                and kw["sampler_type"] == "pc" and wav.shape[-1] >= 5 * sr):
            out = m.sample_chunked(
                batch, generator, n_chunks=chunks,
                overlap_frames=int(icfg.get("chunk_overlap_frames", 32)), **kw,
            )
        else:
            out = m.sample(batch, generator, **kw)
        for k in ("nfe", "sweeps"):
            if k in out:
                counts[k] = counts.get(k, 0) + out[k]
        return out["fake_sde_enhanced" if m.sde_input == "denoised" else "enhanced"]

    t0 = time.perf_counter()
    n_done, audio_s = 0, 0.0
    for batch in predict_batches(dataset):
        wav = torch.as_tensor(batch["perturbed"], device=device)
        if chain == "sgmse+gan":
            enhanced = second.enhance({"perturbed": run_sgmse(model, {"perturbed": wav})})["fake"]
        elif chain == "gan+sgmse":
            fake = model.enhance({"perturbed": wav})["fake"]
            enhanced = run_sgmse(second, {"perturbed": wav, "fake": fake})
        elif cfg["task"] == "sgmse":
            enhanced = run_sgmse(model, {"perturbed": wav})
        else:
            enhanced = model.enhance({"perturbed": wav})["fake"]
        enhanced = enhanced.float().cpu().numpy()
        for i, path in enumerate(batch["audio_path"]):
            tgt = path.replace(batch["data_folder"], batch["target_folder"])
            n = int(batch["sample_length"][i])
            write_wav(tgt, enhanced[i][:n], int(batch["sampling_rate"][i]))
            n_done += 1
            audio_s += n / float(batch["sampling_rate"][i])
            log.info("wrote %s", tgt)
    seconds = time.perf_counter() - t0
    log.info("enhanced %d files -> %s", n_done, target_folder)
    summary = {"files": n_done, "audio_seconds": audio_s, "seconds": seconds}
    if cfg["task"] == "sgmse" or chain:
        summary.update(counts)
    return summary


def main(argv: Optional[List[str]] = None) -> Dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in ("train", "eval", "predict"):
        raise SystemExit(__doc__)
    cmd, rest = argv[0], argv[1:]
    if cmd != "predict":
        raise SystemExit(f"{cmd} is not ported yet (ROADMAP queue 1); predict is")
    experiment, overrides, extras = _split_args(rest)
    return cmd_predict(experiment, overrides, extras)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    main()
