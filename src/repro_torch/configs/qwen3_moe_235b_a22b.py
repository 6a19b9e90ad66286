"""Qwen3-MoE-235B-A22B [hf:Qwen/Qwen3 MoE family].

MoE decoder: 94L, d_model=4096, 64 heads (kv=4), head_dim=128,
128 experts top-8, per-expert d_ff=1536, vocab=151936, qk-norm. Port of
``repro/configs/qwen3_moe_235b_a22b.py``.
"""
from repro_torch.configs.base import MOE, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family=MOE,
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=0,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    num_experts=128,
    experts_per_token=8,
    moe_d_ff=1536,
    fsdp=True,
)
