"""Qwen3-4B [hf:Qwen/Qwen3 family].

Dense GQA decoder with qk-norm: 36L, d_model=2560, 32 heads (kv=8),
head_dim=128, d_ff=9728, vocab=151936. Port of
``repro/configs/qwen3_4b.py``.
"""
from repro_torch.configs.base import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family=DENSE,
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
)
