"""Gemma-3 1B [hf:google/gemma-3-1b-pt].

Dense GQA decoder with 5:1 local:global attention pattern, 512-token
sliding window on local layers: 26L, d_model=1152, 4 heads (kv=1),
head_dim=256, d_ff=6912, vocab=262144, qk-norm, 128k context. Port of
``repro/configs/gemma3_1b.py``.
"""
from repro_torch.configs.base import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family=DENSE,
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    qk_norm=True,
    rope_theta=1_000_000.0,
    sliding_window=512,
    local_global_pattern=(5, 1),
    tie_embeddings=True,
)
