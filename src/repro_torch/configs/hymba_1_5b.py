"""Hymba-1.5B [arXiv:2411.13676].

Hybrid-head decoder: every layer runs attention heads and Mamba(-2
style SSD) heads *in parallel* on the same input and averages the
branch outputs. 32L, d_model=1600, 25 attn heads (kv=5), head_dim=64,
d_ff=5504, vocab=32001, ssm_state=16. Attention branch uses a sliding
window (Hymba keeps only 3 full-attention layers; we model the
sliding-window branch, which is what makes long_500k bounded). Port of
``repro/configs/hymba_1_5b.py``.
"""
from repro_torch.configs.base import HYBRID, ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family=HYBRID,
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    sliding_window=1024,
    ssm_state=16,
    ssm_heads=25,
    ssm_head_dim=64,
    ssm_chunk=128,
    rope_theta=10_000.0,
)
