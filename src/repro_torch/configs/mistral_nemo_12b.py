"""Mistral-Nemo-12B [hf:mistralai/Mistral-Nemo-Base-2407].

Dense GQA decoder: 40L, d_model=5120, 32 heads (kv=8), head_dim=128,
d_ff=14336, vocab=131072, 128k context, rope_theta=1e6. Port of
``repro/configs/mistral_nemo_12b.py``.
"""
from repro_torch.configs.base import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family=DENSE,
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1_000_000.0,
    fsdp=True,
)
