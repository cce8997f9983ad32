"""Inference dataset: folder/list of wavs -> normalized 24 kHz predict batches.

Port of use_tpu/data/loadwav.py: walk a folder (or read a list), resample to the
target rate (fft method), peak-normalize to 0.8, and carry the paths needed
to mirror the input folder structure at the output. ``predict_batches`` is a
plain loop over the dataset that replaces use_tpu's DataLoader.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from use_tpu_torch.data.audio_io import read_wav
from use_tpu_torch.data.collate import pad_to_longest_monaural_inference
from use_tpu_torch.data.dsp import resample_fft


@dataclass
class LoadWavConfig:
    data_folder: str = ""
    target_folder: str = ""
    list_path: Optional[str] = None
    sampling_rate: int = 24000
    normalize: bool = True
    extensions: tuple = (".wav",)


class LoadWavDataset:
    def __init__(self, cfg: LoadWavConfig):
        self.cfg = cfg
        if cfg.list_path:
            with open(cfg.list_path) as f:
                self.files = [x.strip() for x in f if x.strip()]
        else:
            self.files = []
            for root, _dirs, names in os.walk(cfg.data_folder):
                for n in sorted(names):
                    if n.lower().endswith(cfg.extensions):
                        self.files.append(os.path.join(root, n))
            self.files.sort()

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> Dict:
        path = self.files[idx]
        data, sr = read_wav(path)
        if data.ndim > 1:
            data = data[:, 0]
        if sr != self.cfg.sampling_rate:
            data = resample_fft(data, sr, self.cfg.sampling_rate).astype(np.float32)
        if self.cfg.normalize:
            peak = np.abs(data).max()
            if peak > 0:
                data = data / peak * 0.8
        return {
            "perturbed": data.astype(np.float32),
            "name": os.path.basename(path),
            "audio_path": path,
            "sampling_rate": self.cfg.sampling_rate,
            "data_folder": self.cfg.data_folder,
            "target_folder": self.cfg.target_folder,
        }


def predict_batches(dataset: LoadWavDataset, batch_size: int = 1) -> Iterator[Dict]:
    """In-order collated batches of the dataset (use_tpu's predict loader)."""
    for start in range(0, len(dataset), batch_size):
        items = [dataset[i] for i in range(start, min(start + batch_size, len(dataset)))]
        yield pad_to_longest_monaural_inference(items)
