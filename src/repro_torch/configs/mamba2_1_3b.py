"""Mamba2-1.3B [arXiv:2405.21060] — SSD (state-space duality).

Attention-free: 48L, d_model=2048, expand=2 (inner 4096), head_dim=64
=> 64 SSD heads, d_state=128, conv=4, vocab=50280. Port of
``repro/configs/mamba2_1_3b.py``.
"""
from repro_torch.configs.base import SSM, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family=SSM,
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_heads=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=256,
    tie_embeddings=True,
)
