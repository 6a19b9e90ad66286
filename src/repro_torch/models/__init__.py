"""Model zoo of the port: the dense, MoE, SSM, hybrid and gemma3
local/global decoders, the VLM and the Whisper encoder-decoder
(``build_model``)."""
from repro_torch.models.model_zoo import Model, build_model

__all__ = ["Model", "build_model"]
