"""Metric logging: console + CSV, and TensorBoard where it is installed.

Port of use_tpu/utils/logging.py::MetricLogger for one process: every
``log(row)`` goes to the "use_tpu_torch" logger and to a CSV file (a new
header where the row's keys change); scalars, and the eval harness's
figures and audio (``log_figure``, ``log_audio``), also go to TensorBoard
when ``torch.utils.tensorboard`` imports. use_tpu's other trackers (wandb,
comet, mlflow, neptune, aim) are not ported.
"""
from __future__ import annotations

import csv
import logging
import os
from typing import Dict, Optional

import numpy as np

log = logging.getLogger("use_tpu_torch")


class MetricLogger:
    def __init__(self, csv_path: Optional[str] = None, tensorboard_dir: Optional[str] = None):
        self.csv_path = csv_path
        self._csv_keys = None
        self._tb = None
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                log.info("tensorboard is not installed; logging to CSV only")
            else:
                self._tb = SummaryWriter(tensorboard_dir)

    def log(self, row: Dict) -> None:
        log.info(" ".join(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                          for k, v in row.items()))
        if self.csv_path:
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
