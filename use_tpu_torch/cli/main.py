"""CLI entry point of the port: predict (folder -> folder enhancement).

Port of use_tpu/cli/main.py (`_split_args`, `_build_model` for task=sgmse,
`cmd_predict`, `main`):

    python -m use_tpu_torch.cli.main predict experiment=SGMSE_Large \
        [ckpt_path=weights.pt] predict.data_folder=in/ predict.target_folder=out/ \
        [infer.N=30] [device=cpu]

Runs on CUDA unless `device=cpu`. `ckpt_path` loads a torch state_dict of
the backbone (.pt); without it the backbone is initialized from `train.seed`.
Sampler settings go under `infer.*`. On CUDA, TF32 is off for cuDNN and
cuBLAS, so fp32 convolutions and matmuls run in full fp32.
`train`, `eval`, `predict.chain` and `predict.streaming` are not ported yet.
"""
from __future__ import annotations

import logging
import sys
import time
from typing import Dict, List, Optional

import torch

from use_tpu_torch.config.config import load_config

log = logging.getLogger("use_tpu_torch")

_PREDICT_KEYS = {"predict.data_folder", "predict.target_folder"}
_NOT_PORTED = {"predict.chain", "predict.second_experiment", "predict.second_ckpt",
               "predict.streaming", "predict.chunk_frames"}


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
    from use_tpu_torch.models.sgmse.score_model import ScoreModel

    if cfg["task"] != "sgmse":
        raise SystemExit(f"task={cfg['task']} is not ported yet (ROADMAP queue 1)")
    m = dict(cfg["model"])
    return ScoreModel(**m, device=device, seed=int(cfg["train"].get("seed", 0)))


def cmd_predict(experiment: str, overrides: List[str], extras: Dict[str, str]) -> Dict:
    """Folder -> folder enhancement, mirroring the input structure
    (SGMSE_module.predict_step:65-82). Returns a summary: files written,
    audio seconds, wall seconds."""
    from use_tpu_torch.data.audio_io import write_wav
    from use_tpu_torch.data.loadwav import LoadWavConfig, LoadWavDataset, predict_batches
    from use_tpu_torch.utils.device import resolve_device

    cfg = load_config(experiment, overrides)
    data_folder = extras.get("predict.data_folder")
    target_folder = extras.get("predict.target_folder")
    if not data_folder or not target_folder:
        raise SystemExit("predict.data_folder= and predict.target_folder= required")
    device = resolve_device(extras.get("device", "cuda"))
    icfg = cfg.get("infer", {})
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    model = _build_model(cfg, str(device))
    ckpt = extras.get("ckpt_path")
    if ckpt:
        state = torch.load(ckpt, map_location="cpu", weights_only=True)
        model.score_net.load_state_dict(state, strict=True)
    model.cast_params_for_inference()

    sr = int(cfg["data"].get("sampling_rate", 24000))
    dataset = LoadWavDataset(
        LoadWavConfig(data_folder=data_folder, target_folder=target_folder, sampling_rate=sr)
    )
    generator = torch.Generator(device=device).manual_seed(int(cfg["train"].get("seed", 0)))
    kw = dict(
        sampler_type=icfg.get("sampler_type", "pc"), N=int(icfg.get("N", 50)),
        corrector_steps=int(icfg.get("corrector_steps", 1)), snr=float(icfg.get("snr", 0.5)),
    )
    # single-utterance default: clips of >= 5 s run as overlapped chunk
    # lanes of one batched sampler call (infer.chunks, default 8); shorter
    # clips and infer.chunks=1 run full-clip.
    chunks = int(icfg.get("chunks", 8))

    t0 = time.perf_counter()
    n_done, audio_s = 0, 0.0
    for batch in predict_batches(dataset):
        wav = torch.as_tensor(batch["perturbed"], device=device)
        if chunks > 1 and wav.shape[0] == 1 and kw["sampler_type"] == "pc" and wav.shape[-1] >= 5 * sr:
            out = model.sample_chunked(
                {"perturbed": wav}, generator, n_chunks=chunks,
                overlap_frames=int(icfg.get("chunk_overlap_frames", 32)), **kw,
            )
        else:
            out = model.sample({"perturbed": wav}, generator, **kw)
        enhanced = out["enhanced"].float().cpu().numpy()
        for i, path in enumerate(batch["audio_path"]):
            tgt = path.replace(batch["data_folder"], batch["target_folder"])
            n = int(batch["sample_length"][i])
            write_wav(tgt, enhanced[i][:n], int(batch["sampling_rate"][i]))
            n_done += 1
            audio_s += n / float(batch["sampling_rate"][i])
            log.info("wrote %s", tgt)
    seconds = time.perf_counter() - t0
    log.info("enhanced %d files -> %s", n_done, target_folder)
    return {"files": n_done, "audio_seconds": audio_s, "seconds": seconds}


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
