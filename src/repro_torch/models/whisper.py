"""Whisper-style encoder-decoder backbone (the conv frontend is a STUB:
the caller gives precomputed frame embeddings at the post-conv rate).
Sinusoidal positions, bidirectional encoder, causal decoder with
cross-attention; no RoPE.

Port of ``repro/models/whisper.py``. The layers are ``nn.ModuleList``s
run by a Python loop (the reference scans stacked layers); the decoder's
caches stay stacked on a leading L axis as the reference's are:
``(k_self, v_self, k_cross, v_cross)``, each ``(L, B, Hkv, slots, D)``.
The self-attention K/V is a ring (decode writes slot ``pos % W`` and
attends over ``min(pos + 1, W)`` slots); the cross-attention K/V is the
encoder output's projection, written by prefill and only read by decode
(``READ`` in ``CACHE_LAYOUT``).

The attention goes through ``repro_torch.kernels.ops`` as in the
decoder families: the encoder's bidirectional attention, the decoder's
causal self-attention and, where the decoder and encoder lengths are
equal, the cross-attention run ``flash_attention`` on the card; every
decode-step attention, self and cross, runs ``decode_attention``. A
cross-attention of unequal lengths is the reference's float32 grouped
einsum and softmax, plain PyTorch as the reference computes it outside
any kernel.

``param_axes`` gives each weight's logical axes as the reference's
does, without the stacking axis. On a mesh a layer's FSDP-split weights
are gathered before it runs (``sharding.collectives.gathered``), and
every attention, the cross-attention too, runs on the rank's heads
(``attention.Heads``), its caches laid out by ``cache_axes`` as the
decoders' are (``attention.decode_attend``).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.transformer import RING, compute_dtype, decode_slot
from repro_torch.sharding.collectives import gathered
from repro_torch.sharding.partitioning import sharding_of

# a cache tensor that decode only reads (``transformer``'s kinds say what
# decode writes in the others)
READ = "read"
# the cache dict's layout, as ``transformer.cache_layout`` gives a
# decoder's: the self K/V a ring, the cross K/V read only
CACHE_LAYOUT = {"layers": (RING, RING, READ, READ)}


class EncLayer(nn.Module):
    """An encoder layer's weights: ``ln1``, ``attn``, ``ln2``, ``mlp``."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig):
        super().__init__()
        dtype, dev = compute_dtype(cfg), gen.device
        self.ln1 = L.zeros_f32(cfg.d_model, dev)
        self.attn = A.init_attn(gen, cfg, dtype)
        self.ln2 = L.zeros_f32(cfg.d_model, dev)
        self.mlp = L.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype)


class DecLayer(nn.Module):
    """A decoder layer's weights: ``ln1``, ``self_attn``, ``ln_x``,
    ``cross_attn`` (the self-attention's shapes), ``ln2``, ``mlp``."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig):
        super().__init__()
        dtype, dev = compute_dtype(cfg), gen.device
        self.ln1 = L.zeros_f32(cfg.d_model, dev)
        self.self_attn = A.init_attn(gen, cfg, dtype)
        self.ln_x = L.zeros_f32(cfg.d_model, dev)
        self.cross_attn = A.init_attn(gen, cfg, dtype)
        self.ln2 = L.zeros_f32(cfg.d_model, dev)
        self.mlp = L.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype)


class Params(nn.Module):
    """The reference's ``init_params`` pytree as a module: ``embed``
    (tied: ``tok`` alone), ``enc_layers``, ``enc_norm``, ``dec_layers``,
    ``final_norm``; and the decoder's positional table of
    ``max_decode_len`` rows (float32, a buffer out of the state dict),
    which the reference rebuilds at every decode step."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig):
        super().__init__()
        self.embed = L.init_embed(gen, cfg.vocab_size, cfg.d_model, True,
                                  compute_dtype(cfg))
        self.enc_layers = nn.ModuleList(EncLayer(gen, cfg)
                                        for _ in range(cfg.encoder_layers))
        self.enc_norm = L.zeros_f32(cfg.d_model, gen.device)
        self.dec_layers = nn.ModuleList(DecLayer(gen, cfg)
                                        for _ in range(cfg.num_layers))
        self.final_norm = L.zeros_f32(cfg.d_model, gen.device)
        self.register_buffer("dec_positions", L.sinusoidal_positions(
            cfg.max_decode_len, cfg.d_model, gen.device), persistent=False)


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random weights at the reference's scales, drawn from ``gen`` on
    its device."""
    return Params(gen, cfg)


def param_axes(cfg: ModelConfig) -> dict:
    """The reference's ``param_axes`` without its stacking axis: one
    layer's axes under ``enc_layers`` and ``dec_layers``."""
    attn = A.axes_attn(cfg)
    return {
        "embed": L.axes_embed(True),
        "enc_layers": {"ln1": (None,), "attn": attn, "ln2": (None,),
                       "mlp": L.axes_mlp()},
        "enc_norm": (None,),
        "dec_layers": {"ln1": (None,), "self_attn": attn, "ln_x": (None,),
                       "cross_attn": attn, "ln2": (None,),
                       "mlp": L.axes_mlp()},
        "final_norm": (None,),
    }


def cache_axes(cfg: ModelConfig) -> dict:
    """The caches' logical axes (the reference's bare tuple, under
    ``"layers"``)."""
    ax = ("layers", "kv_batch", "kv_heads", "ctx", None)
    return {"layers": (ax,) * 4}


def _cross_attn_full(p, cfg: ModelConfig, x: torch.Tensor,
                     enc_out: torch.Tensor):
    """Queries from x (B, Sd, d), keys and values from enc_out (B, Se, d).
    Returns (out (B, Sd, d), (k, v) (B, Hkv, Se, D) for caching); on a
    mesh, the rank's heads (``attention.attn_full``)."""
    B, Sd, _ = x.shape
    Dh = cfg.head_dim
    hd = A.heads_of(p, cfg)
    q, k, v = A._project_qkv(p, cfg, x, None, x_kv=enc_out, hd=hd)
    kq = A._kv_for_queries(k, hd, cfg.num_heads)
    vq = A._kv_for_queries(v, hd, cfg.num_heads)
    if Sd == enc_out.shape[1]:
        o = ops.attention(q, kq, vq, causal=False)
    else:  # ragged cross shape: the reference's grouped float32 path
        Hq, Hkv = q.shape[1], kq.shape[1]
        G = Hq // Hkv
        qg = (q.float() * Dh ** -0.5).reshape(B, Hkv, G, Sd, Dh)
        logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, kq.float())
        o = torch.einsum("bhgqk,bhkd->bhgqd", torch.softmax(logits, -1),
                         vq.float())
        o = o.reshape(B, Hq, Sd, Dh).to(x.dtype)
    o = o.transpose(1, 2).reshape(B, Sd, -1)
    return A._out_proj(p, o, hd), (k, v)


def _cross_attn_decode(p, cfg: ModelConfig, x: torch.Tensor,
                       k_cache: torch.Tensor, v_cache: torch.Tensor,
                       lengths: torch.Tensor,
                       layout: A.KVLayout | None = None) -> torch.Tensor:
    """One token's queries (x (B, 1, d)) against the whole cross cache
    (in ``layout`` on a mesh), which it only reads."""
    B = x.shape[0]
    hd = A.heads_of(p, cfg)
    q = A.project_q(p, cfg, x, hd)
    o = A.decode_attend(q[:, :, 0], None, None, k_cache, v_cache, lengths,
                        None, hd, layout, cfg.num_heads)
    return A._out_proj(p, o.reshape(B, -1), hd)[:, None]


def encode(params: Params, cfg: ModelConfig,
           frames: torch.Tensor) -> torch.Tensor:
    """frames (B, Se, d) stub embeddings -> (B, Se, d) in the compute
    dtype: sinusoidal positions added, the bidirectional stack, then
    ``enc_norm``."""
    dtype = compute_dtype(cfg)
    Se = frames.shape[1]
    x = frames.to(dtype) + L.sinusoidal_positions(
        Se, cfg.d_model, frames.device).to(dtype)[None]
    for lp in params.enc_layers:
        lp = gathered(lp)
        h = L.rms_norm(x, lp.ln1, cfg.rms_eps)
        x = x + A.attn_full(lp.attn, cfg, h, None, causal=False)[0]
        x = x + L.mlp(lp.mlp, L.rms_norm(x, lp.ln2, cfg.rms_eps))
    return L.rms_norm(x, params.enc_norm, cfg.rms_eps)


def decode_full(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                enc_out: torch.Tensor, collect_cache: bool = False):
    """Teacher-forced decoder pass. Returns (logits (B, Sd, V), caches or
    None): the caches are ``(k_self, v_self, k_cross, v_cross)``, each
    stacked on a leading L axis, the self K/V of Sd slots."""
    x = L.embed_tokens(params.embed, tokens)
    Sd = tokens.shape[1]
    x = x + L.sinusoidal_positions(Sd, cfg.d_model, x.device).to(x.dtype)[None]
    per_layer = []
    for lp in params.dec_layers:
        lp = gathered(lp)
        h = L.rms_norm(x, lp.ln1, cfg.rms_eps)
        a, self_kv = A.attn_full(lp.self_attn, cfg, h, None, causal=True)
        x = x + a
        h = L.rms_norm(x, lp.ln_x, cfg.rms_eps)
        c, cross_kv = _cross_attn_full(lp.cross_attn, cfg, h, enc_out)
        x = x + c
        x = x + L.mlp(lp.mlp, L.rms_norm(x, lp.ln2, cfg.rms_eps))
        if collect_cache:
            per_layer.append(self_kv + cross_kv)
    x = L.rms_norm(x, params.final_norm, cfg.rms_eps)
    logits = L.unembed(params.embed, x)
    caches = (tuple(torch.stack(parts) for parts in zip(*per_layer))
              if collect_cache else None)
    return logits, caches


def decode_step(params: Params, cfg: ModelConfig, caches: dict,
                token: torch.Tensor, pos: int | torch.Tensor):
    """One decoder token (B, 1) at position pos against the self ring and
    the fixed cross caches (``caches["layers"]``) -> (logits (B, 1, V),
    caches), the self ring written in place at slot ``pos % W``.

    ``pos`` is an int or a one-element int64 tensor on the token's
    device; the step reads no host value (the positional row, the ring's
    slot and lengths come from that tensor), so a CUDA graph captures it
    once for every position. The positional row is the table's row
    ``min(pos, max_decode_len - 1)``: the reference's
    ``dynamic_slice_in_dim`` clamps its start so (its table is
    ``params.dec_positions``)."""
    x = L.embed_tokens(params.embed, token)
    B = x.shape[0]
    if not isinstance(pos, torch.Tensor):
        pos = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    pos = pos.reshape(1)
    row = params.dec_positions.index_select(
        0, torch.clamp(pos, max=cfg.max_decode_len - 1))
    x = x + row.to(x.dtype)[None]
    k_self, v_self, k_cross, v_cross = caches["layers"]
    write_idx, lengths = decode_slot(pos, k_self, True, B)
    self_layout, cross_layout = A.kv_layout(k_self), A.kv_layout(k_cross)
    Se = k_cross.shape[-2]
    if cross_layout is not None and cross_layout.slots:
        Se *= sharding_of(k_cross).mesh.ways(cross_layout.slots)
    cross_len = torch.full((B,), Se, dtype=torch.int32, device=x.device)
    for l, lp in enumerate(params.dec_layers):
        lp = gathered(lp)
        h = L.rms_norm(x, lp.ln1, cfg.rms_eps)
        x = x + A.attn_decode(lp.self_attn, cfg, h, None, k_self[l],
                              v_self[l], lengths, write_idx, self_layout)[0]
        h = L.rms_norm(x, lp.ln_x, cfg.rms_eps)
        x = x + _cross_attn_decode(lp.cross_attn, cfg, h, k_cross[l],
                                   v_cross[l], cross_len, cross_layout)
        x = x + L.mlp(lp.mlp, L.rms_norm(x, lp.ln2, cfg.rms_eps))
    x = L.rms_norm(x, params.final_norm, cfg.rms_eps)
    return L.unembed(params.embed, x), caches
