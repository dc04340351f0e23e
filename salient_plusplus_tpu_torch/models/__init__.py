from .modules import MODEL_REGISTRY, MODELS, SAGE, make_model

__all__ = ["MODEL_REGISTRY", "MODELS", "SAGE", "make_model"]
