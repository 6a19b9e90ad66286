"""Model zoo of the port: dense and SSM decoders (``build_model``)."""
from repro_torch.models.model_zoo import Model, build_model

__all__ = ["Model", "build_model"]
