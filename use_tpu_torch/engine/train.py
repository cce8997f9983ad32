"""SGMSE train and eval steps.

Port of use_tpu/engine/train.py::make_sgmse_train_step / _accum_grads and
make_sgmse_eval_step. One optimizer step takes a group of microbatches
(successive loader batches): each microbatch's loss is scaled by 1/k
before its backward, so the gradients the step applies are the MEAN over
the group, as use_tpu's (Lightning's accumulate_grad_batches), and only one
microbatch's activations are alive at a time.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from use_tpu_torch.engine.state import TrainState
from use_tpu_torch.models.sgmse.score_model import Batch, ScoreModel, TrainDraws


def sgmse_train_step(model: ScoreModel, state: TrainState, micro: List[Batch],
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[Sequence[TrainDraws]] = None) -> Dict[str, torch.Tensor]:
    """One optimizer step over the microbatches `micro`; -> {"loss_Score":
    mean loss over the group} (a 0-d tensor on the device). ``draws`` gives
    each microbatch's (start, t, z) in place of the generator's."""
    k = len(micro)
    state.optimizer.zero_grad(set_to_none=True)
    total = None
    for i, mb in enumerate(micro):
        loss = model.train_loss(mb, generator, None if draws is None else draws[i])
        (loss / k).backward()
        total = loss.detach() if total is None else total + loss.detach()
    state.apply_gradients()
    return {"loss_Score": total / k}


@torch.no_grad()
def sgmse_eval_step(model: ScoreModel, batch: Batch,
                    generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """The score-matching loss on one batch, no gradient (validation and test)."""
    return {"loss_Score": model.train_loss(batch, generator)}
