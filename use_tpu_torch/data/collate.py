"""Batch collation: pad-to-longest (reference src/data/components/collate.py).

The port's copy of use_tpu/data/collate.py, bit-equal under the same seeds.

The inference variant additionally pads every batch's time
axis up to a fixed bucket boundary so batch shapes come from a small static
set (no per-utterance recompilation).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def pad_to_longest_monaural(samples: List[Dict], bucket: Optional[int] = None) -> Dict:
    """Train collate (collate.py:8-39): stacks clean/perturbed, keeps
    lengths/names/SNR."""
    max_len = max(len(s["perturbed"]) for s in samples)
    if bucket:
        max_len = int(-(-max_len // bucket) * bucket)
    out: Dict = {
        "sample_length": np.array([len(s["perturbed"]) for s in samples], np.int32),
        "names": [s.get("name", "") for s in samples],
        "SNR": np.array([float(s.get("SNR", np.inf)) for s in samples], np.float32),
        "sampling_rate": np.array(
            [int(s.get("sampling_rate", 24000)) for s in samples], np.int32
        ),
    }
    for key in ("clean", "perturbed"):
        if key in samples[0]:
            out[key] = np.stack(
                [np.pad(s[key], (0, max_len - len(s[key]))) for s in samples]
            ).astype(np.float32)
    return out


def pad_to_longest_monaural_inference(
    samples: List[Dict], bucket: Optional[int] = 16000
) -> Dict:
    """Inference collate (collate.py:42-73): + path metadata for output
    mirroring."""
    out = pad_to_longest_monaural(samples, bucket=bucket)
    out["audio_path"] = [s["audio_path"] for s in samples]
    out["data_folder"] = samples[0].get("data_folder", "")
    out["target_folder"] = samples[0].get("target_folder", "")
    return out
