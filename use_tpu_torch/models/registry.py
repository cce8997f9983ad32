"""Model-family registries (reference: backbones/shared.py:10, sdes.py:17,
sampling/predictors.py:8, sampling/correctors.py:8)."""
from use_tpu_torch.utils.registry import Registry

BackboneRegistry = Registry("Backbone")
SDERegistry = Registry("SDE")
PredictorRegistry = Registry("Predictor")
CorrectorRegistry = Registry("Corrector")
GeneratorRegistry = Registry("Generator")
DiscriminatorRegistry = Registry("Discriminator")
