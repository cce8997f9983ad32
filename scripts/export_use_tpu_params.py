#!/usr/bin/env python3
"""Export the weights of a use_tpu checkpoint to a flat .npz that the PyTorch
port (use_tpu_torch) serves, trains from and evaluates.

    python scripts/export_use_tpu_params.py experiment=SGMSE_Large \
        ckpt_path=runs/x/checkpoints [ckpt.use_ema=true] [ckpt.lenient=true] \
        out=params.npz [use_tpu overrides, e.g. model.backbone=ncsnpplarge]

then, on the machine with the card:

    python -m use_tpu_torch.cli.main predict experiment=SGMSE_Large \
        ckpt_path=params.npz predict.data_folder=in/ predict.target_folder=out/

Run it where use_tpu (JAX, Flax, Orbax) is installed: Orbax writes its
directories with tensorstore, which the port does not need. The checkpoint
is restored by use_tpu's own ``_build_model`` and ``_load_state_params``
(use_tpu/cli/main.py), so ``ckpt_path`` is whatever use_tpu's predict takes:
an Orbax params directory, a ``CheckpointManager`` training directory (its
latest step; ``ckpt.use_ema=true`` its EMA weights), or a torch Lightning
checkpoint, for task sgmse (the score network) and task lsgan (the NCSN++
or the CSMGAN generator). The .npz holds the generator's (or score
network's) params under their Flax paths joined with ``/``, the
discriminator's under ``D/`` where a training directory holds them, and a
``__meta__`` entry (JSON: experiment, task, generator, ema, discriminator)
that the port checks on load. Imports use_tpu and numpy only.
"""
from __future__ import annotations

import json
import os
import sys
from typing import Any, Dict, List, Mapping

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

META_KEY = "__meta__"  # as use_tpu_torch/engine/convert_jax.py reads it


def flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested params -> {"a/b/leaf": array}."""
    out: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(flatten(value, path + "/"))
        else:
            out[path] = np.asarray(value)
    return out


def export(argv: List[str]) -> Dict[str, Any]:
    """Restore the checkpoint that argv names and write its .npz; -> the
    recorded meta and the count of arrays written."""
    from use_tpu.cli.main import _build_model, _load_state_params, _split_args
    from use_tpu.config.config import load_config

    out = [a.split("=", 1)[1] for a in argv if a.startswith("out=")]
    if len(out) != 1 or not out[0].endswith(".npz"):
        raise SystemExit("out=<file>.npz is required, once")
    experiment, overrides, extras = _split_args([a for a in argv if not a.startswith("out=")])
    if not extras.get("ckpt_path"):
        raise SystemExit("ckpt_path= is required")
    truthy = ("1", "true")
    use_ema = extras.get("ckpt.use_ema", "").lower() in truthy
    cfg = load_config(experiment, overrides)
    model = _build_model(cfg)
    loaded = _load_state_params(model, cfg, extras["ckpt_path"],
                                lenient=extras.get("ckpt.lenient", "").lower() in truthy,
                                use_ema=use_ema)
    params, d_params = loaded if cfg["task"] == "lsgan" else (loaded, None)
    flat = flatten(params)
    if d_params is not None:
        flat.update(flatten(d_params, "D/"))
    generator = None
    if cfg["task"] == "lsgan":
        generator = dict(cfg["model"]["generator"]).get("name", "ncsnpp_wrapper")
    meta = {"experiment": experiment, "task": cfg["task"], "generator": generator,
            "ema": use_ema, "discriminator": d_params is not None}
    flat[META_KEY] = np.asarray(json.dumps(meta))
    os.makedirs(os.path.dirname(os.path.abspath(out[0])), exist_ok=True)
    np.savez(out[0], **flat)
    return {**meta, "arrays": len(flat) - 1, "out": out[0]}


def main(argv: List[str]) -> int:
    print(json.dumps(export(argv)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
