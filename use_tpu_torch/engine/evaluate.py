"""Rich evaluation harness: enhance utterances and score them.

Port of use_tpu/engine/evaluate.py (reference src/models/components/sgmse/
util/inference.py:23-101): for each (clean, perturbed) pair, enhance,
score with ``evaluate_pair`` (SI-SDR, SI-SIR, SI-SAR, LSD, ESTOI, and
PESQ where the `pesq` package is installed), and keep spectrogram figures
and audio of the first few for the logger. Where matplotlib does not
import, no figure is drawn (logged once a call); metrics and audio are the
same.
"""
from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from use_tpu_torch.utils.metrics import evaluate_pair

log = logging.getLogger("use_tpu_torch")


def evaluate_model(enhance_fn: Callable[[np.ndarray, Optional[torch.Generator]], np.ndarray],
                   pairs: List[Dict[str, np.ndarray]],
                   generator: Optional[torch.Generator] = None, num_figures: int = 2,
                   sr: int = 24000) -> Dict[str, Any]:
    """enhance_fn(noisy [L], generator) -> enhanced [L], the generator
    shared by every call; pairs: dicts with 'clean' and 'perturbed'. ->
    {"metrics": each metric's mean over the utterances that have it,
    "per_utt", "figures", "audio"}."""
    rows, figures, audio = [], [], []
    draw = True
    for i, pair in enumerate(pairs):
        clean = np.asarray(pair["clean"])
        noisy = np.asarray(pair["perturbed"])
        enhanced = np.asarray(enhance_fn(noisy, generator))
        rows.append(evaluate_pair(clean, enhanced, noisy, sr=sr))
        if i < num_figures:
            if draw:
                try:
                    from use_tpu_torch.utils.graphics import visualize_example

                    figures.append(visualize_example(noisy, enhanced, clean, sr=sr))
                except ImportError as e:
                    log.warning("evaluate_model draws no figures: %s", e)
                    draw = False
            audio.append({"noisy": noisy, "enhanced": enhanced, "clean": clean})
    # a scorer may skip an utterance (ESTOI on a clip shorter than its
    # 384 ms segments): each mean is over the rows that have the key
    keys = sorted({k for r in rows for k in r})
    means = {k: float(np.mean([r[k] for r in rows if k in r])) for k in keys}
    log.info("eval: %s", " ".join(f"{k}={v:.3f}" for k, v in means.items()))
    return {"metrics": means, "per_utt": rows, "figures": figures, "audio": audio}
