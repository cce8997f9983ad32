"""The LSGAN family, serving only: the NCSN++ generator and the LSGAN task's
``enhance``. The discriminator bank and the losses come with training."""
from use_tpu_torch.models.gan.generator import NCSNPPWrapper  # noqa: F401
from use_tpu_torch.models.gan.lsgan import LSGAN  # noqa: F401
