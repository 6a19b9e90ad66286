"""Attention block: GQA with RoPE, optional qk-norm / QKV bias / sliding
window; the full-sequence (prefill) and single-token (decode) paths.

Port of ``repro/models/attention.py``. The attention itself goes through
``repro_torch.kernels.ops``: the CUDA kernels on the card, their plain
versions on the CPU. q, k and v are made contiguous ``(B, H, S, D)``
before a kernel sees them (a transposed view is strided).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L


def init_attn(gen: torch.Generator, cfg: ModelConfig,
              dtype: torch.dtype) -> nn.ParameterDict:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    dev = gen.device
    p = {
        "wq": L._dense_init(gen, (d, qd), dtype),
        "wk": L._dense_init(gen, (d, kvd), dtype),
        "wv": L._dense_init(gen, (d, kvd), dtype),
        "wo": L._dense_init(gen, (qd, d), dtype),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", qd), ("bk", kvd), ("bv", kvd)):
            p[name] = nn.Parameter(torch.zeros(n, dtype=dtype, device=dev),
                                   requires_grad=False)
    if cfg.qk_norm:
        p["q_norm"] = L.zeros_f32(cfg.head_dim, dev)
        p["k_norm"] = L.zeros_f32(cfg.head_dim, dev)
    return nn.ParameterDict(p)


def _project_qkv(p, cfg: ModelConfig, x: torch.Tensor, rope_cs):
    """x (B, S, d) -> contiguous q (B, Hq, S, D), k and v (B, Hkv, S, D);
    ``rope_cs`` is ``layers.rope_tables`` of the positions, or None for
    no rotary embedding."""
    B, S, _ = x.shape
    Hq, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, Hq, Dh).transpose(1, 2)
    k = k.reshape(B, S, Hkv, Dh).transpose(1, 2)
    v = v.reshape(B, S, Hkv, Dh).transpose(1, 2)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.rms_eps)
        k = L.rms_norm(k, p["k_norm"], cfg.rms_eps)
    if rope_cs is not None:
        q = L.apply_rope(q, rope_cs)
        k = L.apply_rope(k, rope_cs)
    return q.contiguous(), k.contiguous(), v.contiguous()


def attn_full(p, cfg: ModelConfig, x: torch.Tensor, rope_cs,
              window: int | None = None, causal: bool = True):
    """Full-sequence attention. ``rope_cs``: ``layers.rope_tables`` of
    positions ``0..S-1`` (the reference takes the positions), or None.
    Returns (out (B, S, d), (k, v) for caching)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, rope_cs)
    o = ops.attention(q, k, v, causal=causal, window=window)
    o = o.transpose(1, 2).reshape(B, S, cfg.q_dim)
    return o @ p["wo"], (k, v)


def attn_decode(p, cfg: ModelConfig, x: torch.Tensor, rope_cs,
                k_cache: torch.Tensor, v_cache: torch.Tensor,
                lengths: torch.Tensor, write_idx: int):
    """One-token attention against a (possibly ring) KV cache.

    x: (B, 1, d); rope_cs: ``layers.rope_tables`` of the token's absolute
    position (the reference takes the position), or None; write_idx:
    slot to write (== pos for full caches, pos % W for rings); lengths:
    (B,) int32 valid cache entries *after* this token is appended (the
    reference takes a scalar and fills it). The token's k and v are
    written into the caches in place; returns (out (B, 1, d), k_cache,
    v_cache) as the reference does.
    """
    B = x.shape[0]
    q, k, v = _project_qkv(p, cfg, x, rope_cs)               # (B, H, 1, D)
    k_cache[:, :, write_idx] = k[:, :, 0]
    v_cache[:, :, write_idx] = v[:, :, 0]
    o = ops.decode_attention(q[:, :, 0], k_cache, v_cache, lengths)
    out = o.reshape(B, cfg.q_dim) @ p["wo"]
    return out[:, None, :], k_cache, v_cache
