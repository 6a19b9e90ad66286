"""Qwen3-MoE-30B-A3B [hf:Qwen/Qwen3-30B-A3B].

MoE decoder: 48L, d_model=2048, 32 heads (kv=4), head_dim=128,
128 experts top-8, per-expert d_ff=768, vocab=151936, qk-norm. Port of
``repro/configs/qwen3_moe_30b_a3b.py``.
"""
from repro_torch.configs.base import MOE, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family=MOE,
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=0,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    num_experts=128,
    experts_per_token=8,
    moe_d_ff=768,
    fsdp=True,
)
