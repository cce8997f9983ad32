"""Batches of a map-style dataset through torch.utils.data.DataLoader.

Port of use_tpu/data/loader.py with its batch order and worker seeding:
each pass (epoch) shuffles the indices with np.random.default_rng(seed +
epoch), epochs counted from 1 as use_tpu counts them, cuts them into
batches, drops a short last batch where asked, and hands the batches to a
torch DataLoader as its batch sampler. Worker w of epoch e seeds
np.random with seed + 1000 e + w and Python's random with one more, as
use_tpu's workers do (loader.py:19-24). Workers are spawned, never forked,
and never touch CUDA. num_workers=0 runs in-process on the global random
state, as use_tpu does.
"""
from __future__ import annotations

import functools
import random
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch.utils.data


def _seed_worker(base: int, worker_id: int) -> None:
    np.random.seed(base + worker_id)
    random.seed(base + worker_id + 1)


class DataLoader:
    """Map-style dataset -> iterator of collated batches (use_tpu's interface)."""

    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        num_workers: int = 0,
        collate_fn: Optional[Callable[[List[Dict]], Dict]] = None,
        drop_last: bool = False,
        seed: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.collate_fn = collate_fn or (lambda xs: xs)
        self.drop_last = drop_last
        self.seed = seed
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _batches(self) -> List[List[int]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
        bs = self.batch_size
        batches = [order[i : i + bs].tolist() for i in range(0, len(order), bs)]
        if self.drop_last and batches and len(batches[-1]) < bs:
            batches.pop()
        return batches

    def __iter__(self) -> Iterator[Dict]:
        self._epoch += 1
        batches = self._batches()
        if self.num_workers == 0:
            for batch in batches:
                yield self.collate_fn([self.dataset[i] for i in batch])
            return
        yield from torch.utils.data.DataLoader(
            self.dataset, batch_sampler=batches, num_workers=self.num_workers,
            collate_fn=self.collate_fn, prefetch_factor=2,
            worker_init_fn=functools.partial(_seed_worker, self.seed + self._epoch * 1000),
            multiprocessing_context="spawn",
        )
