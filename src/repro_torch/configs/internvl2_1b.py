"""InternVL2-1B [arXiv:2404.16821] — transformer backbone only.

VLM: the InternViT frontend is a STUB (the caller gives 256 precomputed
patch embeddings); the LM backbone is Qwen2-0.5B-like: 24L,
d_model=896, 14 heads (kv=2), head_dim=64, d_ff=4864, vocab=151655, QKV
bias. Port of ``repro/configs/internvl2_1b.py``.
"""
from repro_torch.configs.base import VLM, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family=VLM,
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    num_patches=256,
    tie_embeddings=True,
)
