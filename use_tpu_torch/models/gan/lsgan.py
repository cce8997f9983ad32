"""LSGAN task: a generator, the discriminator bank and the criteria.

Port of use_tpu/models/gan/lsgan.py (reference src/models/LSGAN_module.py):
``g_forward`` (the generator's random-crop training pass), ``d_loss`` and
``g_loss`` (each through ``_disc_batch``: D on the fake and on the clean
clip), the interface engine/train.py's gan_train_step and gan_eval_step
drive, and ``enhance`` for serving. The generator is any of the
``Generator`` interface (generator.py): NCSNPPWrapper, the default, or
CSMGANWrapper. D is built from its DiscriminatorRegistry
name and seeded from ``seed``; the G criterion from the config's g_loss.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

import torch

from use_tpu_torch.models.gan import losses
from use_tpu_torch.models.gan.generator import Generator, NCSNPPWrapper
from use_tpu_torch.models.registry import DiscriminatorRegistry

Batch = Dict[str, Any]


class _BuiltOnUse:
    """A field that holds a module or a DiscriminatorRegistry name, built
    (with the owner's ``seed``, on its ``device``) at the first read: serving
    never reads the discriminator, so it never builds the bank."""

    def __set_name__(self, owner, name):
        self.key = "_" + name

    def __get__(self, obj, owner=None):
        if obj is None:
            return None  # the dataclass field's default
        value = obj.__dict__[self.key]
        if isinstance(value, str):
            value = DiscriminatorRegistry.get_by_name(value)(seed=obj.seed).to(obj.device)
            obj.__dict__[self.key] = value
        return value

    def __set__(self, obj, value):
        obj.__dict__[self.key] = value


@dataclass
class LSGAN:
    """The shipping LSGAN configuration (configs/model/LSGAN.yaml).

    discriminator: a module, or a DiscriminatorRegistry name built with
        ``seed`` on the generator's device when it is first used (training,
        eval, loading D's weights; predict never builds it).
    g_loss_cfg: a HifiganGLossConfig, or the config's g_loss mapping.
    """

    generator: Generator = None
    discriminator: Union[str, torch.nn.Module, None] = _BuiltOnUse()
    g_loss_cfg: Union[losses.HifiganGLossConfig, Dict[str, Any], None] = None
    enhanced_key: str = "fake"
    seed: int = 0

    def __post_init__(self):
        if self.generator is None:
            self.generator = NCSNPPWrapper()
        d = vars(self)["_discriminator"]  # as given, unbuilt
        if d is None:
            self.discriminator = "hifigan_vocoder_discriminator_24k_MVD"
        elif not isinstance(d, str):
            d.to(self.device)
        if self.g_loss_cfg is None:
            self.g_loss_cfg = dict(sampling_rate=24000, alpha_wav_l1=0.1, alpha_mag_l2=1.0,
                                   alpha_mag_log=1.0, alpha_mag_norm_l2=0.5, alpha_mel_log=0.5,
                                   alpha_mel_l2=0.5, alpha_adv_gen=1.0, alpha_adv_feat=10.0)
        if not isinstance(self.g_loss_cfg, losses.HifiganGLossConfig):
            self.g_loss_cfg = losses.HifiganGLossConfig(
                **{**dict(self.g_loss_cfg), "enhanced_key": self.enhanced_key})

    @property
    def device(self) -> torch.device:
        return self.generator.device

    def cast_params_for_inference(self) -> None:
        """Cast the generator's weights for serving, in place (the
        generator's ``cast_for_inference``)."""
        self.generator.cast_for_inference()

    # -- engine interface ----------------------------------------------------
    def g_forward(self, batch: Batch, generator: Optional[torch.Generator] = None,
                  start: Optional[int] = None) -> Batch:
        return self.generator(batch, generator, train=True, start=start)

    def _disc_batch(self, batch: Batch, clean_grad: bool = True) -> Batch:
        """forward_fake and forward_real (hifigan_dicriminator.py:228-249):
        D's logits and feature maps of batch[enhanced_key] and of the clean
        clip. clean_grad=False runs the clean pass without autograd (the G
        criterion takes no gradient through it)."""
        key = self.enhanced_key
        lg_f, fm_f = self.discriminator(batch[key])
        with torch.set_grad_enabled(clean_grad and torch.is_grad_enabled()):
            lg_r, fm_r = self.discriminator(batch["clean"])
        out = dict(batch)
        out[f"predicted_{key}_logits"] = lg_f
        out[f"predicted_{key}_feature_list"] = fm_f
        out["predicted_clean_logits"] = lg_r
        out["predicted_clean_feature_list"] = fm_r
        return out

    def d_loss(self, batch: Batch) -> torch.Tensor:
        return losses.hifigan_d_loss(self._disc_batch(batch), self.enhanced_key)["loss_D"]

    def g_loss(self, batch: Batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """-> (loss_G, {loss_G*: value})."""
        batch = losses.hifigan_g_loss(self._disc_batch(batch, clean_grad=False),
                                      self.g_loss_cfg)
        return batch["loss_G"], {k: v for k, v in batch.items() if k.startswith("loss_G")}

    # -- inference -----------------------------------------------------------
    def enhance(self, batch: Batch) -> Batch:
        """batch['perturbed'] [B, L] -> batch with 'fake' [B, L]."""
        return self.generator(batch, train=False)
