"""Metric logging: a rank-aware console logger, CSV, and TensorBoard where
it is installed.

Port of use_tpu/utils/logging.py. ``ranked_logger`` (logging.py:21-61,
the reference's RankedLogger) drops the records of every process but rank
0 of a torch.distributed group, the rank read when a record is emitted, so
a logger made before the group starts still filters right. Every
``MetricLogger.log(row)`` goes to that logger and, on rank 0 only, to a CSV
file (a new header where the row's keys change); scalars, and the eval
harness's figures and audio (``log_figure``, ``log_audio``), also go to
TensorBoard when ``torch.utils.tensorboard`` imports. use_tpu's other
trackers (wandb, comet, mlflow, neptune, aim) are not ported.
"""
from __future__ import annotations

import csv
import logging
import os
from typing import Dict, Optional

import numpy as np


def _dist_rank() -> int:
    """This process's rank in the torch.distributed group; 0 before one
    starts and without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class _RankZero(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        return _dist_rank() == 0


def ranked_logger(name: str = "use_tpu_torch") -> logging.Logger:
    """The logger `name`, dropping the records of every rank but 0 (the
    reference's rank_zero_only); its records reach the handlers the
    application configured (the CLI's ``logging.basicConfig``)."""
    logger = logging.getLogger(name)
    if not any(isinstance(f, _RankZero) for f in logger.filters):
        logger.addFilter(_RankZero())
    return logger


log = ranked_logger()


class MetricLogger:
    def __init__(self, csv_path: Optional[str] = None, tensorboard_dir: Optional[str] = None):
        self.csv_path = csv_path
        self._csv_keys = None
        self._tb = None
        if tensorboard_dir and _dist_rank() == 0:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                log.info("tensorboard is not installed; logging to CSV only")
            else:
                self._tb = SummaryWriter(tensorboard_dir)

    def log(self, row: Dict) -> None:
        log.info(" ".join(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                          for k, v in row.items()))
        if self.csv_path and _dist_rank() == 0:
            keys = list(row.keys())
            new = not os.path.exists(self.csv_path)
            os.makedirs(os.path.dirname(os.path.abspath(self.csv_path)), exist_ok=True)
            with open(self.csv_path, "a", newline="") as f:
                writer = csv.DictWriter(f, fieldnames=keys)
                if new or keys != self._csv_keys:
                    writer.writeheader()  # a new section when the schema changes
                writer.writerow(row)
            self._csv_keys = keys
        if self._tb is not None:
            step = int(row.get("epoch", row.get("step", 0)))
            for k, v in row.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(k, v, step)

    def log_figure(self, tag: str, fig, step: int = 0) -> None:
        """A matplotlib figure to TensorBoard (the reference logs
        spectrogram figures each validation epoch, sgmse/model.py:221-255),
        then closed; a no-op without TensorBoard."""
        if self._tb is not None:
            try:
                self._tb.add_figure(tag, fig, global_step=step)
            except Exception:
                log.warning("tensorboard add_figure failed for %s", tag)
        try:
            import matplotlib.pyplot as plt
        except ImportError:
            return
        plt.close(fig)

    def log_audio(self, tag: str, wav, sr: int, step: int = 0) -> None:
        """An audio clip to TensorBoard (sgmse/model.py:221-233); a no-op
        without TensorBoard."""
        if self._tb is not None:
            try:
                w = np.asarray(wav, dtype=np.float32).reshape(1, -1)
                self._tb.add_audio(tag, w, global_step=step, sample_rate=sr)
            except Exception:
                log.warning("tensorboard add_audio failed for %s", tag)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
