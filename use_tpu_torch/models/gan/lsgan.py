"""LSGAN task, serving: the generator's ``enhance``.

Port of use_tpu/models/gan/lsgan.py (reference src/models/LSGAN_module.py),
inference only. The discriminator bank and the G/D criteria come with the
training slice; until then their config (``discriminator``, ``g_loss_cfg``)
is kept as read and not built.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from use_tpu_torch.models.gan.generator import NCSNPPWrapper
from use_tpu_torch.models.ncsnpp.ncsnpp import cast_backbone_for_inference

Batch = Dict[str, torch.Tensor]


@dataclass
class LSGAN:
    """The shipping LSGAN configuration (configs/model/LSGAN.yaml)."""

    generator: NCSNPPWrapper = None
    discriminator: Optional[Any] = None  # a DiscriminatorRegistry name, not built yet
    g_loss_cfg: Optional[Dict[str, Any]] = None  # the G criterion's weights, not built yet
    enhanced_key: str = "fake"

    def __post_init__(self):
        if self.generator is None:
            self.generator = NCSNPPWrapper()

    def cast_params_for_inference(self) -> None:
        """Cast the generator's backbone to its compute dtype, in place, as
        ScoreModel serves its own (``cast_backbone_for_inference``)."""
        cast_backbone_for_inference(self.generator.net)

    def enhance(self, batch: Batch) -> Batch:
        """batch['perturbed'] [B, L] -> batch with 'fake' [B, L]."""
        return self.generator(batch, train=False)
