"""The GAN family: the NCSN++ and CSMGAN generators, the discriminator bank,
the G/D criteria and the LSGAN task (training and serving)."""
from use_tpu_torch.models.gan.csmgan import CSMGANWrapper  # noqa: F401
from use_tpu_torch.models.gan.generator import NCSNPPWrapper  # noqa: F401
from use_tpu_torch.models.gan.lsgan import LSGAN  # noqa: F401
