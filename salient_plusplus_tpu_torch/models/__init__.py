from .modules import (
    MODEL_REGISTRY, MODELS, SAGE, make_model, mirror_all_specs, model_class,
)

__all__ = ["MODEL_REGISTRY", "MODELS", "SAGE", "make_model",
           "mirror_all_specs", "model_class"]
