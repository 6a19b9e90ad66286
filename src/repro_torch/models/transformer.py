"""Decoder-only LM assembly, dense and SSM families.

Port of the dense and SSM branches of ``repro/models/transformer.py``.
The reference stacks its layers on a leading L axis and runs them with
``lax.scan``; here the layers are an ``nn.ModuleList`` run by a Python
loop. Caches stay stacked as in the reference's pytree
``{"layers": ...}``: ``(k, v)``, each ``(L, B, Hkv, S, D)``, for a
dense stack; ``(conv, h)``, ``(L, B, ck-1, conv_dim)`` in the compute
dtype and ``(L, B, H, N, P)`` float32, for an SSM stack. Decode writes
into them in place.

MoE and hybrid layers, the gemma3 local/global groups, sliding window
caches and ``remat`` raise ``NotImplementedError`` (ROADMAP A11).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import DENSE, SSM, ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import ssm as M


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def require_ported(cfg: ModelConfig) -> None:
    """Raise for what the port's model substrate does not build yet."""
    if cfg.family not in (DENSE, SSM):
        raise NotImplementedError(
            f"{cfg.family} layers are not ported (ROADMAP A11); the port "
            "builds the dense and SSM families")
    if cfg.local_global_pattern is not None:
        raise NotImplementedError("gemma3 local/global layer groups are not "
                                  "ported (ROADMAP A11)")
    if cfg.sliding_window is not None:
        raise NotImplementedError("sliding-window ring caches are not ported "
                                  "(ROADMAP A11)")


class Layer(nn.Module):
    """One layer's weights: ``ln1`` and ``attn`` (dense) or ``ssm``;
    ``ln2`` and ``mlp`` where ``d_ff > 0``."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig):
        super().__init__()
        require_ported(cfg)
        dtype, dev = compute_dtype(cfg), gen.device
        self.ln1 = L.zeros_f32(cfg.d_model, dev)
        if cfg.family == SSM:
            self.ssm = M.init_ssm(gen, cfg, dtype)
        else:
            self.attn = A.init_attn(gen, cfg, dtype)
        if cfg.d_ff > 0:
            self.ln2 = L.zeros_f32(cfg.d_model, dev)
            self.mlp = L.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype)


class Params(nn.Module):
    """The reference's ``init_params`` pytree as a module: ``embed``
    (``tok``, ``unembed``), ``final_norm`` and ``layers``."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig):
        super().__init__()
        require_ported(cfg)
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
    the positions, None for an SSM layer). Returns (x, cache or ()): the
    cache is (k, v) for a dense layer, (conv_state, h_state) for an SSM
    layer."""
    h = L.rms_norm(x, lp.ln1, cfg.rms_eps)
    if cfg.family != SSM:
        out, cache = A.attn_full(lp.attn, cfg, h, rope_cs)
    elif collect_cache:
        out, cache = M.ssm_full(lp.ssm, cfg, h, return_state=True)
    else:
        out, cache = M.ssm_full(lp.ssm, cfg, h), ()
    x = x + out
    if cfg.d_ff > 0:
        x = x + L.mlp(lp.mlp, L.rms_norm(x, lp.ln2, cfg.rms_eps))
    return x, (cache if collect_cache else ())


def layer_decode(lp: Layer, cfg: ModelConfig, x: torch.Tensor,
                 pos: torch.Tensor | int, cache: tuple, rope_cs,
                 lengths: torch.Tensor):
    """One layer, one token at ``pos`` (a one-element int64 tensor on
    x's device; unread by an SSM layer). ``cache`` is this layer's slice
    of the stacked caches ((k, v), or (conv_state, h_state) for an SSM
    layer), updated in place and returned; ``rope_cs`` and ``lengths``
    (min(pos + 1, cache slots) per row) are built once per step by
    ``decode_step`` (None for an SSM stack)."""
    h = L.rms_norm(x, lp.ln1, cfg.rms_eps)
    if cfg.family == SSM:
        conv_st, h_st = cache
        out, conv_new, h_new = M.ssm_decode(lp.ssm, cfg, h, conv_st, h_st)
        conv_st.copy_(conv_new)
        h_st.copy_(h_new)
        cache = (conv_st, h_st)
    else:
        k_cache, v_cache = cache
        out, k_cache, v_cache = A.attn_decode(lp.attn, cfg, h, rope_cs,
                                              k_cache, v_cache, lengths, pos)
        cache = (k_cache, v_cache)
    x = x + out
    if cfg.d_ff > 0:
        x = x + L.mlp(lp.mlp, L.rms_norm(x, lp.ln2, cfg.rms_eps))
    return x, cache


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill) and decode
# ---------------------------------------------------------------------------

def forward(params: Params, cfg: ModelConfig, x_embed: torch.Tensor,
            collect_cache: bool = False, remat: bool = False):
    """Embedded inputs -> (final hidden, aux loss, caches or None); the
    caches are ``{"layers": (a, b)}``, each layer's two cache tensors
    stacked on a leading L axis. The aux loss is the reference's MoE
    balance term, 0 for dense and SSM layers."""
    if remat:
        raise NotImplementedError("remat belongs to the training slice "
                                  "(ROADMAP A11)")
    rope_cs = None
    if cfg.family != SSM:
        positions = torch.arange(x_embed.shape[1], device=x_embed.device)
        rope_cs = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    x, firsts, seconds = x_embed, [], []
    for lp in params.layers:
        x, cache = layer_full(lp, cfg, x, rope_cs, collect_cache)
        if collect_cache:
            firsts.append(cache[0])
            seconds.append(cache[1])
    x = L.rms_norm(x, params.final_norm, cfg.rms_eps)
    caches = ({"layers": (torch.stack(firsts), torch.stack(seconds))}
              if collect_cache else None)
    return x, 0.0, caches


def logits_from_hidden(params: Params, cfg: ModelConfig,
                       x: torch.Tensor) -> torch.Tensor:
    return L.unembed(params.embed, x)


def decode_step(params: Params, cfg: ModelConfig, caches: dict,
                token: torch.Tensor, pos: int | torch.Tensor):
    """token (B, 1) at absolute position pos -> (logits (B, 1, V),
    caches), the caches updated in place.

    ``pos`` is an int or a one-element int64 tensor on the token's
    device. The step reads no host value: the rotary tables, the lengths
    (min(pos + 1, cache slots)) and the cache slot written all come from
    that tensor on the device, so a CUDA graph captures the step once
    for every position (``model_zoo.Model.decode``). A dense cache must
    have a slot at pos (0 <= pos < slots)."""
    x = L.embed_tokens(params.embed, token)
    first, second = caches["layers"]
    rope_cs = lengths = None
    if cfg.family != SSM:
        if not isinstance(pos, torch.Tensor):
            pos = torch.full((1,), pos, dtype=torch.int64, device=x.device)
        pos = pos.reshape(1)
        rope_cs = L.rope_tables(pos, cfg.head_dim, cfg.rope_theta)
        lengths = torch.clamp(pos + 1, max=first.shape[3]).to(
            torch.int32).repeat(x.shape[0])
    for l, lp in enumerate(params.layers):
        x, _ = layer_decode(lp, cfg, x, pos, (first[l], second[l]), rope_cs,
                            lengths)
    x = L.rms_norm(x, params.final_norm, cfg.rms_eps)
    return logits_from_hidden(params, cfg, x), caches
