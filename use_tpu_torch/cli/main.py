"""CLI entry point of the port: train, eval and predict.

Port of use_tpu/cli/main.py (`_split_args`, `_build_model`,
`resolve_auto_batch`, `_build_datamodule`, `cmd_train` with
`_test_after_fit`, `cmd_eval`, `cmd_predict` with its hybrid chains,
`main`), for task=sgmse and task=lsgan (generator `ncsnpp_wrapper`, the
LSGAN recipe, or `csmgan`, the CSMGAN recipe):

    python -m use_tpu_torch.cli.main train experiment=SGMSE_Large|LSGAN|CSMGAN \
        data.clean_json_path=clean.jsonl data.noise_json_path=noise.jsonl \
        [out_dir=runs/x] [ckpt_path=runs/x/checkpoints] [device=cpu]
    python -m use_tpu_torch.cli.main eval experiment=SGMSE_Large|LSGAN|CSMGAN \
        data.clean_json_path=... data.noise_json_path=... [ckpt_path=...] \
        [eval.rich=false] [eval.max_files=4] [infer.N=50] [out_dir=...] [device=cpu]
    python -m use_tpu_torch.cli.main predict experiment=SGMSE_Large \
        [ckpt_path=weights.pt|run.ckpt|runs/x/checkpoints|params.npz] [ckpt.use_ema=true] \
        [ckpt.lenient=true] predict.data_folder=in/ predict.target_folder=out/ \
        [infer.N=30] [infer.sampler_type=pc|parallel_pc|ode] [device=cpu]
    python -m use_tpu_torch.cli.main predict experiment=LSGAN|CSMGAN ...
    python -m use_tpu_torch.cli.main predict experiment=CSMGAN predict.streaming=true \
        [predict.chunk_frames=4] ...
    python -m use_tpu_torch.cli.main predict experiment=SGMSE_Large \
        predict.chain=sgmse+gan predict.second_experiment=LSGAN [predict.second_ckpt=g.pt] ...
    python -m use_tpu_torch.cli.main predict experiment=LSGAN \
        predict.chain=gan+sgmse predict.second_experiment=SGMSE_Large \
        second.model.condition=both second.model.sde_input=denoised ...

Runs on CUDA unless `device=cpu`; on CUDA, TF32 is off for cuDNN and
cuBLAS, so fp32 convolutions and matmuls run in full fp32.

`predict.streaming=true` (task=lsgan with the csmgan generator, no chain)
enhances each file chunk by chunk through a CSMGANStream session of
`predict.chunk_frames` STFT frames a chunk (default 4, at least 2), reused
from file to file where the batch allows.

task=lsgan takes its discriminator bank from `model.discriminator=`: the
recipes' `hifigan_vocoder_discriminator_24k_MVD`, or
`hifigan_vocoder_discriminator_24k` (MPD, the DWT multi-scale bank, the
mel bank). The generators `hifigan_generator` and `hifigan_bwe` are
registered but lack the GAN task's interface: `model.generator.name=` of
either is refused before a model is built, as use_tpu refuses them.

`train` trains from `train.seed` (task=sgmse the score network; task=lsgan
the generator and the discriminator, two optimizers), writes
`metrics.csv`, `checkpoints/` (one step an epoch) and, after a test of the
best checkpoint, `optimized_metric.json` under `out_dir`; `ckpt_path=`
(a checkpoint directory) resumes.

`eval` reports the test split's losses (task=sgmse `loss_Score`;
task=lsgan every `loss_G*`, against the checkpoint's discriminator, or a
freshly initialized one where the checkpoint holds the generator only) and
then, unless `eval.rich=false`, enhances `eval.max_files` test utterances
(sgmse with the `infer.*` sampler settings) and scores them: SI-SDR,
SI-SIR, SI-SAR, LSD, ESTOI, and PESQ where the `pesq` package is installed,
with figures and audio to TensorBoard.

`ckpt_path` (and `predict.second_ckpt` for a chain's second stage) of
`predict` and `eval` is one of: a checkpoint directory of `train` (its
best step, or the latest where no metric was recorded; `ckpt.use_ema=true`
serves its EMA weights; of an LSGAN run, its generator); a Lightning
checkpoint (`.ckpt`, or a `.pt`/`.pth` holding a `state_dict`) whose
backbone keys sit under `Score.score_net.` (sgmse) or `G.net.` (lsgan);
a bare backbone state_dict (`.pt`); or a `.npz` of use_tpu's weights,
written where JAX is installed by scripts/export_use_tpu_params.py from a
use_tpu params directory or training directory (`ckpt.use_ema=true` then
needs an export of the EMA weights). Without one the
backbone is initialized from `train.seed`. Loads are strict unless
`ckpt.lenient=true`. `train` takes a `.npz` as `ckpt_path=` too: it
initializes the model (an LSGAN run's D as well, where the export holds
it) from it instead of resuming. Sampler settings go under `infer.*` (`window` and
`tol` for parallel_pc), and are read from the first experiment's config;
`second.*` overrides go to the second experiment's.
"""
from __future__ import annotations

import json
import logging
import os
import pickle
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from use_tpu_torch.config.config import load_config

log = logging.getLogger("use_tpu_torch")

_PREDICT_KEYS = {"predict.data_folder", "predict.target_folder", "predict.chain",
                 "predict.second_experiment", "predict.second_ckpt", "predict.streaming",
                 "predict.chunk_frames"}
_EVAL_KEYS = {"eval.rich", "eval.max_files"}
_TRUE = ("1", "true")
# chain -> (task of the first experiment, task of the second)
_CHAINS = {"sgmse+gan": ("sgmse", "lsgan"), "gan+sgmse": ("lsgan", "sgmse")}


def _split_args(argv: List[str]):
    experiment = None
    overrides = []
    extras: Dict[str, str] = {}
    for a in argv:
        if a.startswith("experiment="):
            experiment = a.split("=", 1)[1]
        elif a.startswith(("ckpt_path=", "ckpt.lenient=", "ckpt.use_ema=", "out_dir=",
                           "device=", "predict.", "eval.")):
            k, v = a.split("=", 1)
            if k.startswith("eval.") and k not in _EVAL_KEYS:
                raise SystemExit(f"unknown key {k!r}; eval options are {sorted(_EVAL_KEYS)}")
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


# backbones registered as library modules that no task wrapper can build: a
# GaGNet takes [B, F, T, 2] (no conditioning channels) and a ConvTasNet a
# waveform; use_tpu's ScoreModel and NCSNPPWrapper fail on both as well
LIBRARY_BACKBONES = ("gagnet", "convtasnet")


def _refuse_registry_backbone(name: Optional[str], key: str, wrapper: str) -> None:
    if name in LIBRARY_BACKBONES:
        raise SystemExit(
            f"{key}={name} is a library module of the backbone registry that {wrapper} "
            "cannot build, nor can use_tpu's task wrappers; build it directly "
            f"(BackboneRegistry.get_by_name({name!r})) or use an NCSN++ backbone"
        )


def _build_model(cfg: Dict, device: str):
    import use_tpu_torch.models  # noqa: F401 (populate the registries)
    from use_tpu_torch.models.gan.generator import GENERATOR_INTERFACE
    from use_tpu_torch.models.gan.lsgan import LSGAN
    from use_tpu_torch.models.registry import GeneratorRegistry
    from use_tpu_torch.models.sgmse.score_model import ScoreModel

    seed = int(cfg["train"].get("seed", 0))
    if cfg["task"] == "sgmse":
        _refuse_registry_backbone(cfg["model"].get("backbone"), "model.backbone", "ScoreModel")
        return ScoreModel(**dict(cfg["model"]), device=device, seed=seed)
    if cfg["task"] == "lsgan":
        gcfg = dict(cfg["model"]["generator"])
        gen_name = gcfg.pop("name", "ncsnpp_wrapper")
        if gen_name == "ncsnpp_wrapper":
            _refuse_registry_backbone(gcfg.get("backbone"), "model.generator.backbone",
                                      "NCSNPPWrapper")
        cls = GeneratorRegistry.get_by_name(gen_name)
        missing = [a for a in GENERATOR_INTERFACE if not callable(getattr(cls, a, None))]
        if missing:
            raise SystemExit(
                f"model.generator.name={gen_name} resolves {cls.__name__}, which "
                f"lacks the LSGAN generator interface ({', '.join(missing)}); the usable "
                "generators for the GAN task are ncsnpp_wrapper and csmgan"
            )
        gen = cls(**gcfg, device=device, seed=seed)
        return LSGAN(generator=gen, discriminator=cfg["model"].get("discriminator"),
                     g_loss_cfg=cfg["model"].get("g_loss"),
                     enhanced_key=cfg["model"].get("enhanced_key", "fake"), seed=seed)
    raise SystemExit(f"unknown task {cfg['task']}")


_PREFIX = {"sgmse": "Score.score_net.", "lsgan": "G.net."}  # Lightning module paths
_MONITOR = {"sgmse": "val/loss_Score", "lsgan": "val/loss_G"}


def _backbone(model) -> torch.nn.Module:
    return model.score_net if hasattr(model, "score_net") else model.generator.net


def _manager_state(path: str, task: str) -> Dict:
    """The train state of a checkpoint directory's best step, else its latest."""
    from use_tpu_torch.engine.checkpoint import CheckpointManager

    mgr = CheckpointManager(path, monitor=_MONITOR[task])
    step = mgr.best_step()
    return mgr.restore(mgr.latest_step() if step is None else step)


def _npz_state(path: str, task: str, use_ema: bool, generator: str) -> Dict[str, torch.Tensor]:
    """The backbone state_dict of a use_tpu export (.npz): its generator's
    (or score network's) params, converted for the port's backbone."""
    from use_tpu_torch.engine import convert_jax

    meta = convert_jax.export_meta(path)
    for key, want in (("task", task), ("generator", generator if task == "lsgan" else None)):
        if meta.get(key, want) != want:
            raise SystemExit(f"ckpt_path={path}: exported for {key} {meta[key]!r}, "
                             f"the experiment has {want!r}")
    if use_ema and not meta.get("ema"):
        raise SystemExit(f"ckpt.use_ema=true but {path} holds no EMA params (export them "
                         "with ckpt.use_ema=true from a training directory that has them)")
    params = convert_jax.load_flat_params(path)
    params.pop("D", None)
    if generator == "csmgan":
        return convert_jax.csmgan_params_to_state_dict(params)
    if task == "lsgan":
        return convert_jax.lsgan_params_to_state_dict(params)
    return convert_jax.ncsnpp_params_to_state_dict(params)


def _checkpoint_state(path: str, task: str, use_ema: bool,
                      generator: str = "ncsnpp_wrapper") -> Dict[str, torch.Tensor]:
    """The backbone state_dict that `path` names (use_tpu's
    _load_state_params, cli/main.py:337-410): a checkpoint directory of
    `train` (its best step, else its latest; with use_ema its EMA weights),
    a use_tpu export (.npz, ``_npz_state``), a Lightning checkpoint (backbone
    keys under _PREFIX[task], stripped), or a bare backbone state_dict. Of
    an LSGAN run's directory, the generator's."""
    from use_tpu_torch.engine.checkpoint import is_manager_dir

    if path.endswith(".npz"):
        return _npz_state(path, task, use_ema, generator)
    if os.path.isdir(path):
        if not is_manager_dir(path):
            raise SystemExit(f"ckpt_path={path}: a directory without checkpoint steps")
        state = _manager_state(path, task)
        state = state.get("g", state)  # a GANTrainState's: the generator's
        if not use_ema:
            return state["model"]
        if state.get("ema_params") is None:
            raise SystemExit("ckpt.use_ema=true but the checkpoint has no EMA params "
                             "(train with train.ema_decay > 0)")
        return state["ema_params"]
    if use_ema:
        raise SystemExit(f"ckpt.use_ema=true: {path} holds no EMA params (it is not a "
                         "checkpoint directory of train)")
    try:
        loaded = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        if not path.endswith(".ckpt"):
            raise
        # a Lightning .ckpt may pickle more than tensors (its hyper-parameters)
        log.warning("ckpt_path=%s holds objects other than tensors: unpickling it in full "
                    "(load only a checkpoint you trust)", path)
        loaded = torch.load(path, map_location="cpu", weights_only=False)
    prefix = _PREFIX[task]
    lightning = "state_dict" in loaded
    sd = loaded["state_dict"] if lightning else loaded
    if lightning or any(k.startswith(prefix) for k in sd):
        out = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
        if not out:
            raise SystemExit(f"ckpt_path={path}: no key under {prefix!r}; roots "
                             f"{sorted({k.split('.')[0] for k in sd})}")
        return out
    return sd


def _load_backbone(model, cfg: Dict, path: Optional[str], lenient: bool = False,
                   use_ema: bool = False) -> None:
    """Load `path` (see _checkpoint_state) into the model's backbone:
    strictly, or with lenient=True merged shape-tolerantly into its
    initialization (use_tpu's merge_params_lenient). A generator's
    Lightning checkpoint may carry the time embedding's all_modules.0.W,
    which a non-conditional net does not hold (use_tpu/models/ncsnpp/
    ncsnpp.py:173-179): it is dropped."""
    from use_tpu_torch.engine.checkpoint import merge_lenient_checked

    if not path:
        if use_ema:
            raise SystemExit("ckpt.use_ema=true requires ckpt_path=")
        return
    net = _backbone(model)
    sd = _checkpoint_state(path, cfg["task"], use_ema, _generator_name(cfg))
    own = net.state_dict()
    if "all_modules.0.W" in sd and "all_modules.0.W" not in own:
        sd = {k: v for k, v in sd.items() if k != "all_modules.0.W"}
    if lenient:
        sd = merge_lenient_checked(own, sd, path)
    net.load_state_dict(sd, strict=True)


def _generator_name(cfg: Dict) -> str:
    return dict(cfg["model"].get("generator") or {}).get("name", "ncsnpp_wrapper")


def resolve_auto_batch(cfg: Dict) -> None:
    """data.batch_size: auto -> micro_batch_per_device (one device) and
    train.accumulate_grad_batches: auto -> max(1, effective_batch // batch),
    in place (use_tpu/cli/main.py:109, with n_devices 1)."""
    d, t = cfg["data"], cfg["train"]
    if d.get("batch_size") == "auto":
        d["batch_size"] = int(d.get("micro_batch_per_device", 1))
    if t.get("accumulate_grad_batches") == "auto":
        eff = int(t.get("effective_batch", d.get("batch_size", 4)))
        t["accumulate_grad_batches"] = max(1, eff // int(d["batch_size"]))


def _build_datamodule(cfg: Dict):
    from use_tpu_torch.data.datamodule import DistortDataModule
    from use_tpu_torch.data.distort_dataset import DistortConfig

    resolve_auto_batch(cfg)
    d = dict(cfg["data"])
    batch_size = d.pop("batch_size", 4)
    num_workers = d.pop("num_workers", 4)
    overfit_items = d.pop("overfit_items", None)
    known = set(DistortConfig.__dataclass_fields__)
    return DistortDataModule(
        train_cfg=DistortConfig(**{k: v for k, v in d.items() if k in known}),
        batch_size=batch_size, num_workers=num_workers, seed=cfg["train"].get("seed", 0),
        overfit_items=overfit_items,
    )


def _test_split_means(model, task: str, dm) -> Dict[str, float]:
    """Means over the test split (use_tpu's _test_split_means; reference
    SGMSE_module.test_step:61-63, LSGAN_module.test_step:130-137): task=sgmse
    the score-matching loss, drawn from a CPU generator seeded 0;
    task=lsgan every loss_G* of gan_eval_step, against model.discriminator."""
    from use_tpu_torch.engine.loop import float_batch
    from use_tpu_torch.engine.train import gan_eval_step, sgmse_eval_step

    device = model.device
    if task == "sgmse":
        generator = torch.Generator().manual_seed(0)
        rows = [{k: float(v) for k, v in sgmse_eval_step(model, float_batch(b, device),
                                                         generator).items()}
                for b in dm.test_dataloader()]
    else:
        rows = [{k: float(v) for k, v in gan_eval_step(model, float_batch(b, device)).items()}
                for b in dm.test_dataloader()]
    return {f"test/{k}": float(np.mean([r[k] for r in rows])) for k in (rows[0] if rows else {})}


def _test_after_fit(model, cfg: Dict, dm, out_dir: str, history: List[Dict], logger) -> None:
    """Reload the best checkpoint (else the latest), test it and write
    optimized_metric.json (use_tpu/cli/main.py:_test_after_fit; reference
    src/train.py:90-108): the best checkpoint's monitored metric and the
    test split's means from that same state."""
    from use_tpu_torch.engine.checkpoint import CheckpointManager

    monitor = _MONITOR[cfg["task"]]
    mgr = CheckpointManager(os.path.join(out_dir, "checkpoints"), monitor=monitor)
    best = mgr.best_step()
    best = mgr.latest_step() if best is None else best
    if best is None:
        log.warning("no checkpoint to test after fit")
        return
    state = mgr.restore(best, map_location=model.device)
    if cfg["task"] == "sgmse":
        model.score_net.load_state_dict(state["model"])
    else:
        model.generator.net.load_state_dict(state["g"]["model"])
        model.discriminator.load_state_dict(state["d"]["model"])
    means = _test_split_means(model, cfg["task"], dm)
    logger.log({"step": int(best), **means})

    best_rows = [h for h in history if h.get("epoch") == int(best)]
    best_val = best_rows[-1].get(monitor) if best_rows else None
    explicit = "optimized_metric" in cfg["train"]
    metric_name = cfg["train"].get("optimized_metric", monitor)
    candidates = dict(means)
    if best_val is not None and np.isfinite(best_val):
        candidates[monitor] = float(best_val)
    if metric_name not in candidates:
        if explicit or not candidates:
            raise SystemExit(f"train.optimized_metric={metric_name!r} not found; "
                             f"available: {sorted(candidates)}")
        metric_name = sorted(candidates)[0]  # e.g. validation never ran
    record = {"metric": metric_name, "value": float(candidates[metric_name]),
              "best_epoch": int(best), "monitor": {monitor: best_val}, "test": means}
    with open(os.path.join(out_dir, "optimized_metric.json"), "w") as f:
        json.dump(record, f, indent=2)
    log.info("test-after-fit @ epoch %d: %s; optimized %s=%.5g", best,
             " ".join(f"{k}={v:.5f}" for k, v in means.items()), metric_name, record["value"])


def _cuda_fp32(device: torch.device) -> None:
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def cmd_train(experiment: str, overrides: List[str], extras: Dict[str, str]) -> Dict:
    """Training (reference src/train.py:42-131): task=sgmse score matching
    (with train.rich_eval_every, the rich harness on validation utterances
    every K epochs), task=lsgan adversarial training of G and D; then the
    test of the best checkpoint. -> a summary: the fit's history, optimizer
    steps, microbatches, clips, seconds of the fit and out_dir."""
    from use_tpu_torch.engine import loop
    from use_tpu_torch.utils.device import resolve_device
    from use_tpu_torch.utils.logging import MetricLogger

    cfg = load_config(experiment, overrides)
    device = resolve_device(extras.get("device", "cuda"))
    _cuda_fp32(device)
    out_dir = extras.get("out_dir",
                         os.path.join("runs", experiment, time.strftime("%Y%m%d-%H%M%S")))
    ckpt_dir = os.path.join(out_dir, "checkpoints")
    resume = extras.get("ckpt_path")
    init = resume if resume and resume.endswith(".npz") else None
    resume = None if init else resume
    if resume and os.path.abspath(resume) != os.path.abspath(ckpt_dir):
        raise SystemExit(f"ckpt_path={resume}: train resumes from its own out_dir's "
                         f"checkpoints ({ckpt_dir})")
    logger = MetricLogger(csv_path=os.path.join(out_dir, "metrics.csv"),
                          tensorboard_dir=os.path.join(out_dir, "tb"))
    model = _build_model(cfg, str(device))
    if init:
        _load_backbone(model, cfg, init, lenient=extras.get("ckpt.lenient", "").lower() in _TRUE,
                       use_ema=extras.get("ckpt.use_ema", "").lower() in _TRUE)
        if cfg["task"] == "lsgan":
            _load_discriminator(model, init)
    dm = _build_datamodule(cfg)
    t = cfg["train"]
    t0 = time.perf_counter()
    common = dict(accumulate_grad_batches=t.get("accumulate_grad_batches", 1),
                  scheduler=t.get("scheduler"), max_epochs=t.get("max_epochs", 1),
                  seed=t.get("seed", 0), ckpt_dir=ckpt_dir, resume=bool(resume), logger=logger)
    if cfg["task"] == "sgmse":
        result = loop.fit_sgmse(
            model, dm, lr=t["lr"], weight_decay=t["weight_decay"],
            grad_clip=t.get("grad_clip", 100.0), ema_decay=t.get("ema_decay", 0.0),
            rich_eval_every=t.get("rich_eval_every"),
            rich_eval_files=t.get("rich_eval_files", 2), rich_eval_N=t.get("rich_eval_N", 10),
            **common)
    else:
        result = loop.fit_lsgan(model, dm, g_lr=t["g_lr"], d_lr=t["d_lr"],
                                weight_decay=t["weight_decay"], **common)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    fit_seconds = time.perf_counter() - t0
    _test_after_fit(model, cfg, dm, out_dir, result.history, logger)
    logger.close()
    log.info("training done -> %s", out_dir)
    return {"history": result.history, "fit_seconds": fit_seconds, "out_dir": out_dir,
            "optimizer_steps": result.steps, "microbatches": result.microbatches,
            "clips": result.clips}


def _load_for_serving(model, cfg: Dict, path: Optional[str], extras: Dict[str, str]) -> None:
    """Load `path` into the backbone (``_load_backbone`` with the ckpt.*
    keys), then cast its weights for serving."""
    _load_backbone(model, cfg, path, lenient=extras.get("ckpt.lenient", "").lower() in _TRUE,
                   use_ema=extras.get("ckpt.use_ema", "").lower() in _TRUE)
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
    _cuda_fp32(device)

    streaming = extras.get("predict.streaming", "").lower() in _TRUE
    chunk_frames = int(extras.get("predict.chunk_frames", "4"))
    if streaming:
        _check_streaming(cfg, chain, chunk_frames)
    model = _build_model(cfg, str(device))
    if streaming:
        _check_stream_frontend(model.generator.feature)
    _load_for_serving(model, cfg, extras.get("ckpt_path"), extras)
    second = None
    if chain:
        second_cfg = load_config(extras["predict.second_experiment"], second_overrides)
        tasks = (cfg["task"], second_cfg["task"])
        if tasks != _CHAINS[chain]:
            raise SystemExit(f"predict.chain={chain} needs tasks {_CHAINS[chain]}, got {tasks}")
        second = _build_model(second_cfg, str(device))
        _load_for_serving(second, second_cfg, extras.get("predict.second_ckpt"), extras)

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
    session = None  # the CSMGANStream that streaming reuses from file to file
    for batch in predict_batches(dataset):
        wav = torch.as_tensor(batch["perturbed"], device=device)
        if chain == "sgmse+gan":
            enhanced = second.enhance({"perturbed": run_sgmse(model, {"perturbed": wav})})["fake"]
        elif chain == "gan+sgmse":
            fake = model.enhance({"perturbed": wav})["fake"]
            enhanced = run_sgmse(second, {"perturbed": wav, "fake": fake})
        elif cfg["task"] == "sgmse":
            enhanced = run_sgmse(model, {"perturbed": wav})
        elif streaming:
            enhanced, session = model.generator.enhance_streaming(
                wav, chunk_frames=chunk_frames, session=session)
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


def _check_streaming(cfg: Dict, chain: Optional[str], chunk_frames: int) -> None:
    """predict.streaming's conditions on the config, checked before the
    model is built (use_tpu/cli/main.py:469-501): task=lsgan with a
    streamable generator and no chain, chunk_frames >= 2."""
    import use_tpu_torch.models  # noqa: F401 (populate the registries)
    from use_tpu_torch.models.registry import GeneratorRegistry

    if chain or cfg["task"] != "lsgan" or not hasattr(
            GeneratorRegistry.get_by_name(_generator_name(cfg)), "enhance_streaming"):
        raise SystemExit(
            "predict.streaming=true requires task=lsgan with a "
            "streamable generator (model.generator.name=csmgan) and no "
            "predict.chain"
        )
    if chunk_frames < 2:
        raise SystemExit(
            f"predict.chunk_frames={chunk_frames} invalid: streaming "
            "needs >= 2 frames per chunk (the first chunk primes the "
            "centered-STFT reflection)"
        )


def _check_stream_frontend(feat) -> None:
    """The streaming front-end's framing: win_length == n_fft == 2 * hop."""
    if feat.cfg.wl != feat.n_fft or feat.n_fft != 2 * feat.hop_length:
        raise SystemExit(
            "predict.streaming=true requires the generator front-end to "
            "satisfy win_length == n_fft == 2*hop (got n_fft="
            f"{feat.n_fft}, win_length={feat.cfg.wl}, "
            f"hop={feat.hop_length}); use the csmgan defaults or adjust "
            "model.generator.* overrides"
        )


def _load_discriminator(model, path: Optional[str]) -> bool:
    """Load the discriminator of an LSGAN run's checkpoint directory `path`
    (its best step, else its latest), or of a use_tpu export (.npz) that
    holds one, into model.discriminator; -> False where `path` holds no
    discriminator."""
    from use_tpu_torch.engine import convert_jax
    from use_tpu_torch.engine.checkpoint import is_manager_dir

    if path and path.endswith(".npz"):
        d = convert_jax.load_flat_params(path).get("D")
        if d is None:
            return False
        model.discriminator.load_state_dict(convert_jax.discriminator_params_to_state_dict(d))
        return True
    if not path or not is_manager_dir(path):
        return False
    state = _manager_state(path, "lsgan")
    if "d" not in state:
        return False
    model.discriminator.load_state_dict(state["d"]["model"])
    return True


def cmd_eval(experiment: str, overrides: List[str], extras: Dict[str, str]) -> Dict:
    """Test-set evaluation of either task (reference src/eval.py:38-95;
    use_tpu cmd_eval): the test split's mean losses, then the rich harness
    (sgmse/util/inference.py:23-101) over eval.max_files test utterances
    unless eval.rich=false. -> a summary: the test means, the rich metrics
    (None with eval.rich=false), the figures drawn, the files scored and
    out_dir."""
    from use_tpu_torch.engine.evaluate import evaluate_model
    from use_tpu_torch.engine.loop import first_pairs
    from use_tpu_torch.utils.device import resolve_device
    from use_tpu_torch.utils.logging import MetricLogger

    cfg = load_config(experiment, overrides)
    device = resolve_device(extras.get("device", "cuda"))
    _cuda_fp32(device)
    model = _build_model(cfg, str(device))
    path = extras.get("ckpt_path")
    _load_backbone(model, cfg, path, lenient=extras.get("ckpt.lenient", "").lower() in _TRUE,
                   use_ema=extras.get("ckpt.use_ema", "").lower() in _TRUE)
    if cfg["task"] == "lsgan" and not _load_discriminator(model, path):
        log.warning("no discriminator in the checkpoint; the adversarial and feature terms "
                    "use a freshly initialized D (the reconstruction terms are unaffected)")
    out_dir = extras.get("out_dir", os.path.join("runs", experiment + "_eval",
                                                 time.strftime("%Y%m%d-%H%M%S")))
    logger = MetricLogger(csv_path=os.path.join(out_dir, "metrics.csv"),
                          tensorboard_dir=os.path.join(out_dir, "tb"))
    dm = _build_datamodule(cfg)
    means = _test_split_means(model, cfg["task"], dm)
    logger.log({"step": 0, **means})
    summary = {"test": means, "rich": None, "figures": 0, "out_dir": out_dir}
    if extras.get("eval.rich", "true").lower() not in ("0", "false"):
        icfg = cfg.get("infer", {})
        sr = int(cfg["data"].get("sampling_rate", 24000))
        if cfg["task"] == "sgmse":
            kw = dict(sampler_type=icfg.get("sampler_type", "pc"), N=int(icfg.get("N", 50)),
                      corrector_steps=int(icfg.get("corrector_steps", 1)),
                      snr=float(icfg.get("snr", 0.5)))

            def enhance_fn(noisy, generator):
                wav = torch.as_tensor(noisy[None], device=device)
                return model.sample({"perturbed": wav}, generator, **kw)["enhanced"][0]
        else:
            def enhance_fn(noisy, generator):
                return model.enhance({"perturbed": torch.as_tensor(noisy[None], device=device)}
                                     )["fake"][0]

        pairs = first_pairs(dm.test_dataloader(), int(extras.get("eval.max_files", 4)))
        result = evaluate_model(lambda n, g: enhance_fn(n, g).float().cpu().numpy(), pairs,
                                torch.Generator(device=device).manual_seed(0), sr=sr)
        logger.log({"step": 0, **{f"test/{k}": v for k, v in result["metrics"].items()}})
        for i, fig in enumerate(result["figures"]):
            logger.log_figure(f"eval/example_{i}", fig, step=0)
        for i, clips in enumerate(result["audio"]):
            for name, wav in clips.items():
                logger.log_audio(f"eval/{name}_{i}", wav, sr, step=0)
        summary.update(rich=result["metrics"], figures=len(result["figures"]),
                       files=len(pairs))
    logger.close()
    log.info("eval done: %s -> %s", " ".join(f"{k}={v:.5f}" for k, v in means.items()), out_dir)
    return summary


def main(argv: Optional[List[str]] = None) -> Dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in ("train", "eval", "predict"):
        raise SystemExit(__doc__)
    cmd, rest = argv[0], argv[1:]
    experiment, overrides, extras = _split_args(rest)
    return {"train": cmd_train, "eval": cmd_eval, "predict": cmd_predict}[cmd](
        experiment, overrides, extras)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    main()
