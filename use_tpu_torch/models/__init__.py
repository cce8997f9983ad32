"""Model families. Importing this package populates the registries."""
from use_tpu_torch.models.registry import (
    BackboneRegistry,
    CorrectorRegistry,
    DiscriminatorRegistry,
    GeneratorRegistry,
    PredictorRegistry,
    SDERegistry,
)

# registration side effects
from use_tpu_torch.models.ncsnpp import ncsnpp as _ncsnpp  # noqa: F401
from use_tpu_torch.models.sgmse import sdes as _sdes  # noqa: F401
from use_tpu_torch.models.sgmse import sampling as _sampling  # noqa: F401
from use_tpu_torch.models.gan import generator as _generator  # noqa: F401
from use_tpu_torch.models.gan import csmgan as _csmgan  # noqa: F401
from use_tpu_torch.models.gan import discriminators as _discriminators  # noqa: F401
from use_tpu_torch.models.gan import hifigan_bwe as _hifigan_bwe  # noqa: F401
from use_tpu_torch.models.gan import hifigan_vocoder as _hifigan_vocoder  # noqa: F401
from use_tpu_torch.models import convtasnet as _convtasnet  # noqa: F401
from use_tpu_torch.models import gagnet as _gagnet  # noqa: F401

__all__ = [
    "BackboneRegistry",
    "SDERegistry",
    "PredictorRegistry",
    "CorrectorRegistry",
    "GeneratorRegistry",
    "DiscriminatorRegistry",
]
