"""Checkpoints over torch files: train state + metrics, top-k by a metric.

Port of use_tpu/engine/checkpoint.py with its interface (``save``,
``restore``, ``latest_step``, ``best_step``, ``max_to_keep``, monitor and
mode), written with ``torch.save`` instead of Orbax:

    <directory>/<step>/state.pt      TrainState.state_dict()
    <directory>/<step>/metrics.json  the metrics saved with it

Beyond max_to_keep the worst step by the monitored metric goes (steps
without a finite metric first, then the oldest). ``save_params`` /
``load_params`` are the one-file form of a backbone's state_dict, and
``merge_params_lenient`` the shape-tolerant merge of use_tpu's lenient load
(checkpoint.py:132), on flat state_dicts.
"""
from __future__ import annotations

import json
import logging
import math
import os
import shutil
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

log = logging.getLogger("use_tpu_torch")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 10, monitor: str = "val/loss",
                 mode: str = "min"):
        if mode not in ("min", "max"):
            raise ValueError(f"mode {mode!r} (min | max)")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.monitor = monitor
        self.mode = mode

    def steps(self) -> List[int]:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(self._file(int(d), "state.pt")))

    def _file(self, step: int, name: str) -> str:
        return os.path.join(self.directory, str(step), name)

    def metrics(self, step: int) -> Dict[str, float]:
        path = self._file(step, "metrics.json")
        if not os.path.exists(path):
            return {}
        with open(path) as f:
            return json.load(f)

    def _score(self, step: int) -> Optional[float]:
        v = self.metrics(step).get(self.monitor)
        if v is None or not math.isfinite(v):
            return None
        return v if self.mode == "min" else -v

    def save(self, step: int, state: Any, metrics: Optional[Dict[str, float]] = None) -> None:
        """Write `state` (a TrainState or a picklable dict of tensors) as `step`."""
        d = os.path.join(self.directory, str(step))
        os.makedirs(d, exist_ok=True)
        payload = state.state_dict() if hasattr(state, "state_dict") else state
        tmp = self._file(step, "state.pt.tmp")
        torch.save(payload, tmp)
        with open(self._file(step, "metrics.json"), "w") as f:
            json.dump({k: float(v) for k, v in (metrics or {}).items()}, f)
        os.replace(tmp, self._file(step, "state.pt"))
        steps = self.steps()
        while len(steps) > self.max_to_keep:
            worst = self._worst(steps)
            shutil.rmtree(os.path.join(self.directory, str(worst)))
            steps.remove(worst)

    def _worst(self, steps: List[int]) -> int:
        """The oldest step without a finite metric, else the worst scored
        (the older on a tie)."""
        unscored = [s for s in steps if self._score(s) is None]
        if unscored:
            return min(unscored)
        return max(steps, key=lambda s: (self._score(s), -s))

    def restore(self, step: Optional[int] = None, map_location: Any = "cpu") -> Dict:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return torch.load(self._file(step, "state.pt"), map_location=map_location,
                          weights_only=True)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        """The step with the best finite monitored metric (the later on a
        tie); None where no step has one."""
        scored = [(self._score(s), s) for s in self.steps() if self._score(s) is not None]
        if not scored:
            return None
        return min(scored, key=lambda vs: (vs[0], -vs[1]))[1]


def is_manager_dir(path: str) -> bool:
    """True for a CheckpointManager directory (numeric step subdirectories)."""
    return os.path.isdir(path) and any(d.isdigit() for d in os.listdir(path))


def save_params(path: str, state_dict: Mapping[str, torch.Tensor]) -> None:
    """One backbone state_dict in one file (predict / export)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(dict(state_dict), path)


def load_params(path: str, template: Optional[Mapping[str, torch.Tensor]] = None,
                lenient: bool = False, max_skipped_frac: float = 0.5) -> Dict[str, torch.Tensor]:
    """A state_dict from `path`. lenient=True merges it into `template`
    shape-tolerantly (``merge_params_lenient``), logs what was skipped and
    raises where more than max_skipped_frac of the template's entries were."""
    loaded = torch.load(path, map_location="cpu", weights_only=True)
    if not lenient:
        return loaded
    if template is None:
        raise ValueError("a lenient load needs a template")
    return merge_lenient_checked(template, loaded, path, max_skipped_frac)


def merge_lenient_checked(template: Mapping[str, torch.Tensor], loaded: Mapping[str, Any],
                          what: str, max_skipped_frac: float = 0.5) -> Dict[str, torch.Tensor]:
    merged, skipped = merge_params_lenient(template, loaded)
    template_side = [s for s in skipped if "[loaded-only]" not in s]
    if skipped:
        log.warning("lenient load of %s skipped %d/%d template entries (+%d loaded-only): %s%s",
                    what, len(template_side), len(template), len(skipped) - len(template_side),
                    skipped[:5], "..." if len(skipped) > 5 else "")
    if template and len(template_side) / len(template) > max_skipped_frac:
        raise ValueError(f"lenient load of {what} skipped {len(template_side)}/{len(template)} "
                         f"entries (> {max_skipped_frac:.0%}); this checkpoint does not match "
                         "the model")
    return merged


def merge_params_lenient(template: Mapping[str, torch.Tensor],
                         loaded: Mapping[str, Any]) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """Take each entry of `loaded` whose key is in `template` with the same
    shape (cast to the template's dtype), keep the template's otherwise.
    -> (merged, skipped): template entries not restored ([missing],
    [shape ...]) and loaded entries the template lacks ([loaded-only])."""
    merged, skipped = {}, []
    for k, v in template.items():
        got = loaded.get(k)
        if got is None:
            skipped.append(f"{k} [missing]")
            merged[k] = v
        elif tuple(got.shape) != tuple(v.shape):
            skipped.append(f"{k} [shape {tuple(got.shape)} != {tuple(v.shape)}]")
            merged[k] = v
        else:
            merged[k] = torch.as_tensor(got).to(v.dtype)
    skipped += [f"{k} [loaded-only]" for k in loaded if k not in template]
    return merged, skipped
