"""Data module: train/val/test distortion loaders.

Port of use_tpu/data/datamodule.py::DistortDataModule (reference
src/data/distort_datamodule.py:10-793): builds the three DistortDatasets
on one device, so the batch size is the global one (the reference divides
it by the world size, distort_datamodule.py:656-672). The predict path
reads wavs through data/loadwav.py.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from use_tpu_torch.data.collate import pad_to_longest_monaural
from use_tpu_torch.data.distort_dataset import DistortConfig, DistortDataset
from use_tpu_torch.data.loader import DataLoader


@dataclass
class DistortDataModule:
    train_cfg: DistortConfig = None
    valid_cfg: Optional[DistortConfig] = None
    test_cfg: Optional[DistortConfig] = None
    batch_size: int = 4
    num_workers: int = 4
    seed: int = 0
    # debug: restrict training to the first N synthesized items and recycle
    # them every epoch (configs/debug/overfit.yaml analog)
    overfit_items: Optional[int] = None

    def __post_init__(self):
        if self.valid_cfg is None and self.train_cfg is not None:
            self.valid_cfg = self.train_cfg
        if self.test_cfg is None and self.train_cfg is not None:
            self.test_cfg = self.train_cfg
        self._train = self._valid = self._test = None

    def train_dataloader(self) -> DataLoader:
        if self._train is None:
            ds = DistortDataset(self.train_cfg)
            if self.overfit_items:
                ds = _FixedSubset(ds, self.overfit_items)
            self._train = ds
        return DataLoader(
            self._train, self.batch_size,
            shuffle=not self.overfit_items, num_workers=self.num_workers,
            collate_fn=pad_to_longest_monaural, drop_last=True, seed=self.seed,
        )

    def val_dataloader(self) -> DataLoader:
        if self._valid is None:
            self._valid = DistortDataset(self.valid_cfg)
        return DataLoader(
            self._valid, self.batch_size, shuffle=False, num_workers=self.num_workers,
            collate_fn=pad_to_longest_monaural, drop_last=True, seed=self.seed + 1,
        )

    def test_dataloader(self) -> DataLoader:
        if self._test is None:
            self._test = DistortDataset(self.test_cfg)
        return DataLoader(
            self._test, self.batch_size, shuffle=False, num_workers=self.num_workers,
            collate_fn=pad_to_longest_monaural, drop_last=False, seed=self.seed + 2,
        )


class _FixedSubset:
    """First-N view of a synthesis dataset with per-item caching, so every
    epoch replays the identical batches (overfit debugging)."""

    def __init__(self, ds, n: int):
        self._ds = ds
        self._n = n
        self._cache: Dict[int, Dict] = {}

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, idx: int) -> Dict:
        idx = idx % self._n
        if idx not in self._cache:
            np.random.seed(1000 + idx)  # deterministic synthesis per item
            self._cache[idx] = self._ds[idx]
        return self._cache[idx]
