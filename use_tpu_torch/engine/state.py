"""Train state: the backbone, its optimizer, the step count and the EMA.

Port of use_tpu/engine/state.py::TrainState. The parameters live in the
module and are updated in place; ``apply_gradients`` takes the gradients
autograd left in ``.grad``: clip, then the optimizer's step (coupled L2,
Adam), then, where ema_decay > 0, ema = d ema + (1 - d) p over every
parameter (the frozen ones too, as use_tpu's tree map). ``GANTrainState``
pairs the generator's and the discriminator's for LSGAN's two optimizers.

Data-parallel (parallel/mesh.py): ``ddp`` is the DistributedDataParallel
wrapper of ``model`` that the train steps call, ``world`` the training
ranks. The optimizer, the clip and the EMA work on ``model``'s own
parameters, which the wrapper shares; every rank applies the same
all-reduced gradients, so the ranks' parameters stay bit-identical.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    grad_clip: Optional[float] = None
    step: int = 0
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    ema_decay: float = 0.0
    ddp: Optional[torch.nn.Module] = None
    world: Any = None  # parallel.mesh.World of the training ranks

    @classmethod
    def create(cls, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               grad_clip: Optional[float] = None, ema_decay: float = 0.0) -> "TrainState":
        ema = None
        if ema_decay > 0:
            ema = {k: p.detach().clone() for k, p in model.named_parameters()}
        return cls(model, optimizer, grad_clip, 0, ema, ema_decay)

    def apply_gradients(self) -> None:
        params = [p for group in self.optimizer.param_groups for p in group["params"]]
        if self.grad_clip is not None:
            torch.nn.utils.clip_grad_norm_(params, self.grad_clip)
        self.optimizer.step()
        self.step += 1
        if self.ema_params is not None:
            d = self.ema_decay
            with torch.no_grad():
                names = list(self.ema_params)
                ema = [self.ema_params[k] for k in names]
                new = dict(self.model.named_parameters())
                torch._foreach_mul_(ema, d)
                torch._foreach_add_(ema, [new[k].detach() for k in names], alpha=1.0 - d)

    def no_sync(self):
        """A context in which backward leaves the gradients local (the
        first microbatches of a group); a no-op without DDP."""
        return self.ddp.no_sync() if self.ddp is not None else contextlib.nullcontext()

    def state_dict(self) -> Dict:
        """What a checkpoint holds: weights, optimizer state, step, EMA."""
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "step": self.step, "ema_params": self.ema_params,
                "ema_decay": self.ema_decay}

    def load_state_dict(self, state: Dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        dev = next(self.model.parameters()).device
        ema = state.get("ema_params")
        self.ema_params = None if ema is None else {k: v.to(dev) for k, v in ema.items()}


@dataclass
class GANTrainState:
    """The generator's and the discriminator's train states (LSGAN's
    two-optimizer loop); a checkpoint holds both."""

    g: TrainState
    d: TrainState

    def state_dict(self) -> Dict:
        return {"g": self.g.state_dict(), "d": self.d.state_dict()}

    def load_state_dict(self, state: Dict) -> None:
        self.g.load_state_dict(state["g"])
        self.d.load_state_dict(state["d"])
