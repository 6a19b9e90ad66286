"""Decoder-only LM assembly, dense family.

Port of the dense branch of ``repro/models/transformer.py``. The
reference stacks its layers on a leading L axis and runs them with
``lax.scan``; here the layers are an ``nn.ModuleList`` run by a Python
loop. KV caches stay stacked as ``(L, B, Hkv, S, D)`` tensors, as in
the reference's pytree ``{"layers": (k, v)}``; decode writes each
token's k and v into them in place.

MoE, SSM and hybrid layers, the gemma3 local/global groups, sliding
window caches and ``remat`` raise ``NotImplementedError`` (ROADMAP A11).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import DENSE, ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def require_dense(cfg: ModelConfig) -> None:
    """Raise for what the port's model substrate does not build yet."""
    if cfg.family != DENSE:
        raise NotImplementedError(
            f"{cfg.family} layers are not ported (ROADMAP A11); the port "
            "builds the dense family")
    if cfg.local_global_pattern is not None:
        raise NotImplementedError("gemma3 local/global layer groups are not "
                                  "ported (ROADMAP A11)")
    if cfg.sliding_window is not None:
        raise NotImplementedError("sliding-window ring caches are not ported "
                                  "(ROADMAP A11)")


class Layer(nn.Module):
    """One dense layer's weights: ``ln1``, ``attn``, ``ln2``, ``mlp``."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig):
        super().__init__()
        require_dense(cfg)
        dtype, dev = compute_dtype(cfg), gen.device
        self.ln1 = L.zeros_f32(cfg.d_model, dev)
        self.attn = A.init_attn(gen, cfg, dtype)
        if cfg.d_ff > 0:
            self.ln2 = L.zeros_f32(cfg.d_model, dev)
            self.mlp = L.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype)


class Params(nn.Module):
    """The reference's ``init_params`` pytree as a module: ``embed``
    (``tok``, ``unembed``), ``final_norm`` and ``layers``."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig):
        super().__init__()
        require_dense(cfg)
        self.embed = L.init_embed(gen, cfg.vocab_size, cfg.d_model,
                                  cfg.tie_embeddings, compute_dtype(cfg))
        self.final_norm = L.zeros_f32(cfg.d_model, gen.device)
        self.layers = nn.ModuleList(init_layer(gen, cfg)
                                    for _ in range(cfg.num_layers))


def init_layer(gen: torch.Generator, cfg: ModelConfig) -> Layer:
    return Layer(gen, cfg)


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random weights at the reference's scales, drawn from ``gen`` on
    its device."""
    return Params(gen, cfg)


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------

def layer_full(lp: Layer, cfg: ModelConfig, x: torch.Tensor, rope_cs,
               collect_cache: bool):
    """One layer, full sequence (``rope_cs``: ``layers.rope_tables`` of
    the positions). Returns (x, (k, v) or ())."""
    h = L.rms_norm(x, lp.ln1, cfg.rms_eps)
    a_out, kv = A.attn_full(lp.attn, cfg, h, rope_cs)
    x = x + a_out
    if cfg.d_ff > 0:
        x = x + L.mlp(lp.mlp, L.rms_norm(x, lp.ln2, cfg.rms_eps))
    return x, (kv if collect_cache else ())


def layer_decode(lp: Layer, cfg: ModelConfig, x: torch.Tensor, pos: int,
                 cache: tuple, rope_cs, lengths: torch.Tensor):
    """One layer, one token at ``pos``. ``cache`` is this layer's (k, v)
    slice of the stacked caches, updated in place and returned;
    ``rope_cs`` and ``lengths`` (min(pos + 1, cache slots) per row) are
    built once per step by ``decode_step``."""
    h = L.rms_norm(x, lp.ln1, cfg.rms_eps)
    k_cache, v_cache = cache
    a_out, k_cache, v_cache = A.attn_decode(lp.attn, cfg, h, rope_cs,
                                            k_cache, v_cache, lengths, pos)
    x = x + a_out
    if cfg.d_ff > 0:
        x = x + L.mlp(lp.mlp, L.rms_norm(x, lp.ln2, cfg.rms_eps))
    return x, (k_cache, v_cache)


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill) and decode
# ---------------------------------------------------------------------------

def forward(params: Params, cfg: ModelConfig, x_embed: torch.Tensor,
            collect_cache: bool = False, remat: bool = False):
    """Embedded inputs -> (final hidden, aux loss, caches or None); the
    caches are ``{"layers": (k, v)}``, each ``(L, B, Hkv, S, D)``. The
    aux loss is the reference's MoE balance term, 0 for dense layers."""
    if remat:
        raise NotImplementedError("remat belongs to the training slice "
                                  "(ROADMAP A11)")
    positions = torch.arange(x_embed.shape[1], device=x_embed.device)
    rope_cs = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    x, ks, vs = x_embed, [], []
    for lp in params.layers:
        x, kv = layer_full(lp, cfg, x, rope_cs, collect_cache)
        if collect_cache:
            ks.append(kv[0])
            vs.append(kv[1])
    x = L.rms_norm(x, params.final_norm, cfg.rms_eps)
    caches = ({"layers": (torch.stack(ks), torch.stack(vs))}
              if collect_cache else None)
    return x, 0.0, caches


def logits_from_hidden(params: Params, cfg: ModelConfig,
                       x: torch.Tensor) -> torch.Tensor:
    return L.unembed(params.embed, x)


def decode_step(params: Params, cfg: ModelConfig, caches: dict,
                token: torch.Tensor, pos: int):
    """token (B, 1) at absolute position pos -> (logits (B, 1, V),
    caches), the caches updated in place."""
    x = L.embed_tokens(params.embed, token)
    k_all, v_all = caches["layers"]
    dev = x.device
    rope_cs = L.rope_tables(torch.arange(pos, pos + 1, device=dev),
                            cfg.head_dim, cfg.rope_theta)
    lengths = torch.full((x.shape[0],), min(pos + 1, k_all.shape[3]),
                         dtype=torch.int32, device=dev)
    for l, lp in enumerate(params.layers):
        x, _ = layer_decode(lp, cfg, x, pos, (k_all[l], v_all[l]), rope_cs,
                            lengths)
    x = L.rms_norm(x, params.final_norm, cfg.rms_eps)
    return logits_from_hidden(params, cfg, x), caches
