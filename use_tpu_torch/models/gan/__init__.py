"""The GAN family: the NCSN++ and CSMGAN generators, the discriminator banks,
the G/D criteria and the LSGAN task (training and serving), and the zoo's
library modules: the multi-scale and spectrogram discriminators, the
HiFi-GAN vocoder and the HiFi-GAN+ bandwidth extender."""
from use_tpu_torch.models.gan.csmgan import CSMGANWrapper  # noqa: F401
from use_tpu_torch.models.gan.discriminators import (  # noqa: F401
    HifiganVocoderDiscriminator24k,
    HifiganVocoderDiscriminator24kMVD,
)
from use_tpu_torch.models.gan.generator import NCSNPPWrapper  # noqa: F401
from use_tpu_torch.models.gan.hifigan_bwe import BandwidthExtender, WaveNet  # noqa: F401
from use_tpu_torch.models.gan.hifigan_vocoder import HifiganGenerator  # noqa: F401
from use_tpu_torch.models.gan.lsgan import LSGAN  # noqa: F401
from use_tpu_torch.models.gan.msd import MultiScaleDiscriminator, ScaleDiscriminator  # noqa: F401
from use_tpu_torch.models.gan.spec_discriminator import (  # noqa: F401
    MultiSpecDiscriminator,
    SpecDiscriminator,
)
