"""Attention block: GQA with RoPE, optional qk-norm / QKV bias / sliding
window; the full-sequence (prefill) and single-token (decode) paths.

Port of ``repro/models/attention.py``. The attention itself goes through
``repro_torch.kernels.ops``: the CUDA kernels on the card, their plain
versions on the CPU. q, k and v are made contiguous ``(B, H, S, D)``
before a kernel sees them (a transposed view is strided).

On a mesh that splits the heads (``sharding``'s rules) a rank holds the
columns of its query and KV heads in ``wq``, ``wk``, ``wv`` (and the
biases) and their rows of ``wo``: it attends over its own heads, the
same kernel, forward and backward, on the local shard, and its output
projection is a partial sum over the heads' ranks (the reference's
``constrain`` of the output; ``sharding.collectives``). The query and
KV heads must split over the same axis. Where the split does not fall
on whole heads (``fit_spec`` splits a dim by its size: 8 KV heads of
128 over 16 ranks are 64 columns a rank), the projections are gathered
whole and the rank attends over every head its query heads need
(``Heads``), then keeps its share of the output's columns.

Decode against a cache laid out otherwise than the rank's heads
(``KVLayout``: the cache's batch, KV heads and slots each split over
their mesh axes, the reference dry run's decode layouts) re-lays the
token's query, K and V into the cache's layout (``collectives.relay``:
an all-gather over the batch's axes and an all-to-all over ``model``
in the reference's ``hybrid`` layout), writes K and V on the rank that
holds slot ``pos``, attends over the rank's slice of the slots with the
length clipped to it, and merges the slices' outputs over the slots'
axes by their log-sum-exps (max, then the sums of ``exp(lse - max) ·
out`` and of ``exp(lse - max)``, reduce-scattered back into the rank's
rows).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.sharding.collectives import (_gather_summed, all_reduce,
                                              batch_axes, dim_axis, enter,
                                              reduce, relay)
from repro_torch.sharding.partitioning import (current_mesh, sharding_of,
                                               spec_axes)


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


def axes_attn(cfg: ModelConfig) -> dict:
    a = {
        "wq": ("embed_fsdp", "heads"),
        "wk": ("embed_fsdp", "kv_heads"),
        "wv": ("embed_fsdp", "kv_heads"),
        "wo": ("heads", "embed_fsdp"),
    }
    if cfg.qkv_bias:
        a["bq"] = ("heads",)
        a["bk"] = ("kv_heads",)
        a["bv"] = ("kv_heads",)
    if cfg.qk_norm:
        a["q_norm"] = (None,)
        a["k_norm"] = (None,)
    return a


class Heads(NamedTuple):
    """How a rank holds an attention's heads (the module docstring):
    ``ax`` splits its weights' heads dims (None: whole); ``q_local``:
    its query columns are the whole heads ``[q0, q0 + nq)`` (else q is
    gathered, ``gather_q``, and every head computed); ``kv_local``: its
    K/V columns are whole KV heads, those of its query heads (else whole:
    gathered, ``gather_kv``, or not split, where the rules keep the KV
    heads whole)."""
    ax: object
    q_local: bool
    kv_local: bool
    q0: int
    nq: int
    gather_q: bool = False
    gather_kv: bool = False
    names: tuple = ()             # the mesh axes of ``ax``


def heads_of(p, cfg: ModelConfig) -> Heads:
    """This rank's ``Heads`` from its weights' splits."""
    Hq, Hkv = cfg.num_heads, cfg.num_kv_heads
    ax, kv_ax = dim_axis(p["wq"], 1), dim_axis(p["wk"], 1)
    if kv_ax is not None and kv_ax != ax:
        raise ValueError("the KV heads split over other mesh axes than the "
                         "query heads; a rank needs whole GQA groups")
    if ax is None:
        return Heads(None, False, False, 0, Hq)
    q_local = Hq % ax.size == 0
    kv_local = q_local and kv_ax is not None and Hkv % ax.size == 0
    nq = Hq // ax.size if q_local else Hq
    return Heads(ax, q_local, kv_local, ax.index * nq if q_local else 0, nq,
                 not q_local, kv_ax is not None and not kv_local,
                 spec_axes(sharding_of(p["wq"]).spec[1]))


def _heads_of_cols(t: torch.Tensor, B: int, S: int, Dh: int, split: bool,
                   ax) -> torch.Tensor:
    """(B, S, cols) projections -> (B, H, S, Dh) heads: gathered whole
    over ``ax`` first where the columns are split but not whole heads."""
    if split:
        t = _gather_summed(t, ax, -1)
    return t.reshape(B, S, -1, Dh).transpose(1, 2)


def _project_qkv(p, cfg: ModelConfig, x: torch.Tensor, rope_cs,
                 x_kv: torch.Tensor | None = None, hd: Heads | None = None):
    """x (B, S, d) -> contiguous q (B, Hq, S, D), k and v (B, Hkv, Skv,
    D) of this rank's heads (``hd``, default ``heads_of``: gathered whole
    where the split is not at heads); ``rope_cs`` is
    ``layers.rope_tables`` of the positions, or None for no rotary
    embedding; ``x_kv`` (default x) gives the keys and values (Whisper's
    cross-attention: the encoder's output)."""
    B, S, _ = x.shape
    Dh = cfg.head_dim
    hd = hd or heads_of(p, cfg)
    ax = hd.ax
    x = enter(x, ax)
    x_kv = x if x_kv is None else enter(x_kv, ax)
    Skv = x_kv.shape[1]
    q, k, v = x @ p["wq"], x_kv @ p["wk"], x_kv @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = _heads_of_cols(q, B, S, Dh, hd.gather_q, ax)
    k = _heads_of_cols(k, B, Skv, Dh, hd.gather_kv, ax)
    v = _heads_of_cols(v, B, Skv, Dh, hd.gather_kv, ax)
    if cfg.qk_norm:
        q = L.rms_norm(q, enter(p["q_norm"], ax), cfg.rms_eps)
        k = L.rms_norm(k, enter(p["k_norm"], ax), cfg.rms_eps)
    if rope_cs is not None:
        q = L.apply_rope(q, rope_cs)
        k = L.apply_rope(k, rope_cs)
    return q.contiguous(), k.contiguous(), v.contiguous()


def project_q(p, cfg: ModelConfig, x: torch.Tensor,
              hd: Heads) -> torch.Tensor:
    """x (B, S, d) -> q (B, Hq, S, D) of this rank's heads alone, without
    a rotary embedding (Whisper's cross-attention decode)."""
    B, S, _ = x.shape
    q = enter(x, hd.ax) @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    q = _heads_of_cols(q, B, S, cfg.head_dim, hd.gather_q, hd.ax)
    if cfg.qk_norm:
        q = L.rms_norm(q, enter(p["q_norm"], hd.ax), cfg.rms_eps)
    return q.contiguous()


def _kv_for_queries(k: torch.Tensor, hd: Heads, Hq: int) -> torch.Tensor:
    """The KV heads (dim 1 of k) that this rank's query heads read: k
    itself where it holds exactly their groups; else, from the whole
    KV heads, those of heads ``[q0, q0 + nq)`` (one a query head where
    the query heads do not cover whole groups)."""
    Hkv = k.shape[1]
    if hd.ax is None or hd.kv_local or not hd.q_local:
        return k
    G = Hq // Hkv
    if hd.q0 % G == 0 and hd.nq % G == 0:
        return k.narrow(1, hd.q0 // G, hd.nq // G).contiguous()
    idx = torch.arange(hd.q0, hd.q0 + hd.nq, device=k.device) // G
    return k.index_select(1, idx).contiguous()


def _out_proj(p, o: torch.Tensor, hd: Heads) -> torch.Tensor:
    """o (..., this rank's heads x D, or every head's) @ ``wo``'s rows of
    this rank, summed over the heads' ranks."""
    rows = p["wo"].shape[0]
    if hd.gather_q:
        o = o.narrow(-1, hd.ax.index * rows, rows)
    return reduce(o @ p["wo"], hd.ax)


def attn_full(p, cfg: ModelConfig, x: torch.Tensor, rope_cs,
              window: int | None = None, causal: bool = True):
    """Full-sequence attention. ``rope_cs``: ``layers.rope_tables`` of
    positions ``0..S-1`` (the reference takes the positions), or None.
    Returns (out (B, S, d), (k, v) for caching): on a mesh, the rank's
    rows, and its KV heads where they are whole heads (``Heads.
    kv_local``), else every KV head (``kv_src``)."""
    B, S, _ = x.shape
    hd = heads_of(p, cfg)
    q, k, v = _project_qkv(p, cfg, x, rope_cs, hd=hd)
    o = ops.attention(q, _kv_for_queries(k, hd, cfg.num_heads),
                      _kv_for_queries(v, hd, cfg.num_heads), causal=causal,
                      window=window)
    o = o.transpose(1, 2).reshape(B, S, -1)
    return _out_proj(p, o, hd), (k, v)


class KVLayout(NamedTuple):
    """The mesh axes that split a KV cache's batch rows, KV heads and
    slots (each a tuple, ``()`` whole)."""
    rows: tuple
    heads: tuple
    slots: tuple


def kv_layout(cache: torch.Tensor) -> KVLayout | None:
    """The layout of a (..., B, Hkv, S, D) cache from its ``Sharding``
    tag (``Model.prefill``, ``Model.init_cache``); None for an untagged
    cache, which holds the rank's rows and heads as its projections do
    (``kv_src``)."""
    s = sharding_of(cache)
    if s is None:
        return None
    spec = tuple(s.spec) + (None,) * (cache.ndim - len(s.spec))
    return KVLayout(*(spec_axes(e) for e in spec[-4:-1]))


def kv_src(hd: Heads) -> KVLayout:
    """The layout of the K/V that this rank's projections give: its
    batch rows, its KV heads where they are whole (else all), every
    slot."""
    return KVLayout(batch_axes(), hd.names if hd.kv_local else (), ())


def decode_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  k_cache: torch.Tensor, v_cache: torch.Tensor,
                  lengths: torch.Tensor, write_idx, hd: Heads,
                  layout: KVLayout | None, Hq: int) -> torch.Tensor:
    """One token's attention against a cache in ``layout`` (None: as the
    projections hold it). q (B, nq, D) of this rank's query heads, k and
    v (B, Hkv', D) in ``kv_src(hd)``'s layout, written at slot
    ``write_idx`` (None: a cache decode only reads); lengths (B,) int32
    valid slots after the write. Returns o (B, nq, D) of this rank's
    rows and query heads (the module docstring)."""
    src = kv_src(hd)
    if layout is None or layout == src:
        if write_idx is not None:
            k_cache.index_copy_(2, write_idx.reshape(1), k[:, :, None])
            v_cache.index_copy_(2, write_idx.reshape(1), v[:, :, None])
        return ops.decode_attention(
            q, _kv_for_queries(k_cache, hd, Hq),
            _kv_for_queries(v_cache, hd, Hq), lengths)
    q_heads = hd.names if hd.q_local else ()
    rows, heads, slots = layout
    if write_idx is not None and q_heads == src.heads:
        # one relay: each KV head's G query heads, K and V side by side
        B, Hkv, D = k.shape
        G = q.shape[1] // Hkv
        packed = relay(torch.cat([q.reshape(B, Hkv, G * D), k, v], dim=-1),
                       src[:2], (rows, heads))
        qc = packed[..., :G * D].reshape(packed.shape[0], -1, D)
        kc, vc = packed[..., G * D:(G + 1) * D], packed[..., (G + 1) * D:]
    else:
        if write_idx is not None:
            kc = relay(k, src[:2], (rows, heads))
            vc = relay(v, src[:2], (rows, heads))
        qc = relay(q, (src.rows, q_heads), (rows, heads))
    Sl = k_cache.shape[2]
    mesh = current_mesh()
    c0 = mesh.axis(slots).index * Sl if slots else 0
    if write_idx is not None:      # only the rank holding slot pos writes
        slot = write_idx.reshape(1) - c0
        mine = (slot >= 0) & (slot < Sl)
        slot = slot.clamp(0, Sl - 1)
        for cache, new in ((k_cache, kc), (v_cache, vc)):
            old = cache.index_select(2, slot)[:, :, 0]
            cache.index_copy_(2, slot, torch.where(mine, new, old)[:, :, None])
    local = torch.clamp(lengths[:1] - c0, 0, Sl).to(torch.int32)
    local = local.expand(qc.shape[0]).contiguous()
    if not slots:
        o = ops.decode_attention(qc, k_cache, v_cache, local)
        return relay(o, (rows, heads), (src.rows, q_heads))
    o, lse = ops.decode_attention(qc, k_cache, v_cache, local, with_lse=True)
    top = all_reduce(lse, mesh.axis(slots).group, "max")
    w = torch.exp(lse - top)[..., None]
    part = torch.cat([o.float() * w, w], dim=-1)
    part = relay(part, (rows, heads), (src.rows, q_heads), summed=slots)
    return (part[..., :-1] / part[..., -1:]).to(q.dtype)


def attn_decode(p, cfg: ModelConfig, x: torch.Tensor, rope_cs,
                k_cache: torch.Tensor, v_cache: torch.Tensor,
                lengths: torch.Tensor, write_idx: int | torch.Tensor,
                layout: KVLayout | None = None):
    """One-token attention against a (possibly ring) KV cache.

    x: (B, 1, d); rope_cs: ``layers.rope_tables`` of the token's absolute
    position (the reference takes the position), or None; write_idx:
    slot to write (== pos for full caches, pos % W for rings), an int or
    a one-element int64 tensor on the caches' device (then the step reads
    no host value, as a CUDA graph needs); lengths: (B,) int32 valid
    cache entries *after* this token is appended (the reference takes a
    scalar and fills it); ``layout``: the cache's ``KVLayout`` on a mesh
    (``kv_layout``). The token's k and v are written into the caches in
    place; returns (out (B, 1, d), k_cache, v_cache) as the reference
    does.
    """
    hd = heads_of(p, cfg)
    q, k, v = _project_qkv(p, cfg, x, rope_cs, hd=hd)        # (B, H, 1, D)
    if not isinstance(write_idx, torch.Tensor):
        write_idx = torch.full((1,), write_idx, dtype=torch.int64,
                               device=k_cache.device)
    o = decode_attend(q[:, :, 0], k[:, :, 0], v[:, :, 0], k_cache, v_cache,
                      lengths, write_idx, hd, layout, cfg.num_heads)
    out = _out_proj(p, o.reshape(x.shape[0], -1), hd)
    return out[:, None, :], k_cache, v_cache
