"""Metric logging: console + CSV, and TensorBoard where it is installed.

Port of use_tpu/utils/logging.py::MetricLogger for one process: every
``log(row)`` goes to the "use_tpu_torch" logger and to a CSV file (a new
header where the row's keys change); scalars also go to TensorBoard when
``torch.utils.tensorboard`` imports. use_tpu's other trackers (wandb,
comet, mlflow, neptune, aim) are not ported.
"""
from __future__ import annotations

import csv
import logging
import os
from typing import Dict, Optional

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

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
