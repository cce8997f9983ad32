"""Inference dataset: folder/list of wavs -> normalized 24 kHz predict batches.

Port of use_tpu/data/loadwav.py with its helpers ``dsp.resample_fft``
(use_tpu/data/dsp.py:66) and ``collate.pad_to_longest_monaural_inference``
(use_tpu/data/collate.py:36): walk a folder (or read a list), resample to the
target rate (fft method), peak-normalize to 0.8, and carry the paths needed
to mirror the input folder structure at the output. ``predict_batches`` is a
plain loop over the dataset that replaces use_tpu's DataLoader.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np
import scipy.signal as sps

from use_tpu_torch.data.audio_io import read_wav


def resample_fft(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """FFT-domain resampling (scipy.signal.resample), the reference's
    'fft' resample_method."""
    if orig_sr == target_sr:
        return x
    n_out = int(round(len(x) * target_sr / orig_sr))
    return sps.resample(x, n_out)


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


def pad_to_longest_monaural_inference(
    samples: List[Dict], bucket: Optional[int] = 16000
) -> Dict:
    """Inference collate (reference collate.py:42-73): pad 'perturbed' to the
    longest item, rounded up to a multiple of `bucket`, and keep lengths,
    names and the path metadata for output mirroring."""
    max_len = max(len(s["perturbed"]) for s in samples)
    if bucket:
        max_len = int(-(-max_len // bucket) * bucket)
    return {
        "perturbed": np.stack(
            [np.pad(s["perturbed"], (0, max_len - len(s["perturbed"]))) for s in samples]
        ).astype(np.float32),
        "sample_length": np.array([len(s["perturbed"]) for s in samples], np.int32),
        "names": [s.get("name", "") for s in samples],
        "sampling_rate": np.array(
            [int(s.get("sampling_rate", 24000)) for s in samples], np.int32
        ),
        "audio_path": [s["audio_path"] for s in samples],
        "data_folder": samples[0].get("data_folder", ""),
        "target_folder": samples[0].get("target_folder", ""),
    }


def predict_batches(dataset: LoadWavDataset, batch_size: int = 1) -> Iterator[Dict]:
    """In-order collated batches of the dataset (use_tpu's predict loader)."""
    for start in range(0, len(dataset), batch_size):
        items = [dataset[i] for i in range(start, min(start + batch_size, len(dataset)))]
        yield pad_to_longest_monaural_inference(items)
