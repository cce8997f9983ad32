"""Task utilities: crash-safe wrappers, config printing, profiling.

Port of use_tpu/utils/utils.py (reference src/utils/utils.py:12-119:
extras, task_wrapper, get_metric_value; src/utils/rich_utils.py's config
tree; the profiler presets of configs/debug/profiler.yaml, here
torch.profiler writing a Chrome trace).
"""
from __future__ import annotations

import contextlib
import os
import time
import warnings
from typing import Any, Callable, Dict, Optional

from use_tpu_torch.utils.logging import ranked_logger

log = ranked_logger()


def extras(cfg: Dict) -> None:
    """Pre-task housekeeping (utils.py:12-40): warning suppression and a
    config print."""
    if cfg.get("ignore_warnings"):
        warnings.filterwarnings("ignore")
    if cfg.get("print_config", True):
        print_config_tree(cfg)


def print_config_tree(cfg: Dict, indent: int = 0) -> None:
    """The config as an indented plain-text tree (rich_utils.print_config_tree)."""
    for key, value in cfg.items():
        if isinstance(value, dict):
            log.info("  " * indent + f"{key}:")
            print_config_tree(value, indent + 1)
        else:
            log.info("  " * indent + f"{key}: {value}")


def enforce_tags(cfg: Dict, save_to: Optional[str] = None) -> None:
    """Experiment tags (rich_utils.py:78): where none are given, ['dev']
    with a warning (the reference prompts; a batch job cannot); appended to
    `save_to` when given."""
    if not cfg.get("tags"):
        cfg["tags"] = ["dev"]
        log.warning("no tags provided in config — defaulting to ['dev']")
    if save_to:
        with open(save_to, "a") as f:
            f.write(" ".join(map(str, cfg["tags"])) + "\n")


def task_wrapper(task_func: Callable) -> Callable:
    """Crash-safe task execution (utils.py:43-95): log the exception and
    re-raise; always log the task's elapsed time."""

    def wrap(*args, **kwargs):
        t0 = time.time()
        try:
            return task_func(*args, **kwargs)
        except Exception:
            log.exception("task failed")
            raise
        finally:
            log.info(f"task '{task_func.__name__}' finished in {time.time() - t0:.1f}s")

    return wrap


def get_metric_value(metric_dict: Dict[str, Any], metric_name: Optional[str]) -> Optional[float]:
    """The optimized metric of a run, for sweeps (utils.py:98-119)."""
    if not metric_name:
        return None
    if metric_name not in metric_dict:
        raise KeyError(f"Metric '{metric_name}' not found. Available: {sorted(metric_dict)}")
    return float(metric_dict[metric_name])


@contextlib.contextmanager
def profiler(trace_dir: Optional[str] = None):
    """torch.profiler over the block (CPU, and CUDA where a card
    is present) that writes a Chrome trace, <trace_dir>/trace.json (open
    it in Perfetto or chrome://tracing); a no-op without trace_dir."""
    if trace_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    log.info(f"profiler trace written to {path}")


def rtf(wall_seconds: float, audio_samples: int, sr: int) -> float:
    """Real-time factor: wall time over the audio's duration (model.py:396-400)."""
    return wall_seconds / (audio_samples / sr)
