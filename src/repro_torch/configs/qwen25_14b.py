"""Qwen2.5-14B [hf:Qwen/Qwen2.5 family].

Dense GQA decoder with QKV bias: 48L, d_model=5120, 40 heads (kv=8),
head_dim=128, d_ff=13824, vocab=152064. Port of
``repro/configs/qwen25_14b.py``.
"""
from repro_torch.configs.base import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family=DENSE,
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    fsdp=True,
)
