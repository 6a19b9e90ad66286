"""Whisper-tiny [arXiv:2212.04356] — transformer backbone only.

Enc-dec audio model; the conv frontend is a STUB (the caller gives
precomputed frame embeddings at the post-conv rate). 4L encoder + 4L
decoder, d_model=384, 6 heads (MHA, kv=6), head_dim=64, d_ff=1536,
vocab=51865, decoder max positions 448. Port of
``repro/configs/whisper_tiny.py``.
"""
from repro_torch.configs.base import AUDIO, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family=AUDIO,
    num_layers=4,            # decoder layers
    encoder_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    max_decode_len=448,
    cross_kv_len=1500,       # standard whisper 30 s => 1500 frames
    rope_theta=10_000.0,     # unused: whisper uses sinusoidal positions
)
