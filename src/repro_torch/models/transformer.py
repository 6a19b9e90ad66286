"""Decoder-only LM assembly for every uniform-stack family (dense, MoE,
SSM, hybrid, and the VLM's language backbone) and the gemma3 grouped
local:global stack.

Port of ``repro/models/transformer.py``. The reference stacks its layers
on a leading L axis and runs them with ``lax.scan``; here the layers are
``nn.ModuleList``s run by a Python loop. Caches stay stacked as in the
reference's pytree: ``{"layers": ...}`` for a uniform stack, each cache
tensor with a leading L axis: ``(k, v)``, each ``(L, B, Hkv, S, D)``,
for attention layers; ``(conv, h)``, ``(L, B, ck-1, conv_dim)`` in the
compute dtype and ``(L, B, H, N, P)`` float32, for SSM layers;
``(k, v, conv, h)`` for hybrid layers. The gemma3 stack keeps
``{"group_local": (G, nl, ...), "group_global": (G, ...),
"tail_local": (n_tail, ...)}``. Decode writes into them in place.

A layer with a sliding window (``cfg.sliding_window``: every layer of a
uniform stack, the local layers of a gemma3 stack) attends over the last
``window`` positions in prefill, and in decode keeps a ring cache: the
token's K and V go to slot ``pos % W`` of a W-slot cache, which attends
over its first ``min(pos + 1, W)`` slots.

``remat`` (training) checkpoints each layer of a uniform stack and each
local layer of a gemma3 group (``torch.utils.checkpoint``, non
reentrant): the layer's activations are dropped after the forward and
recomputed in the backward, as the reference's ``jax.checkpoint`` with
``nothing_saveable`` does per scan step; gemma3's global layers run
plainly, as in the reference. The encoder-decoder (audio) family is
``whisper.py``'s.

On a mesh of ranks a layer gathers its FSDP-split weights first
(``sharding.collectives.gathered``), inside the remat region, so a
step holds one layer's whole weights at a time and remat gathers them
again. ``param_axes`` gives each weight's logical axes as the
reference's does, without its stacking axes (``layers``, ``groups``):
the port keeps one module a layer; ``cache_axes`` gives the caches',
which stay stacked.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (DENSE, HYBRID, MOE, SSM, VLM,
                                      ModelConfig)
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as E
from repro_torch.models import ssm as M
from repro_torch.sharding.collectives import gathered


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def groups(cfg: ModelConfig) -> tuple[int, int, int]:
    """A gemma3 stack's (groups G, local layers a group nl, trailing local
    layers): G groups of nl local layers and one global layer, then the
    trailing local layers (``cfg.layer_kinds()``)."""
    n_local, n_global = cfg.local_global_pattern
    period = n_local + n_global
    n_groups = cfg.num_layers // period
    return n_groups, n_local, cfg.num_layers - n_groups * period


# what a decode step writes in a cache tensor: slot pos % W of a ring,
# slot pos of a full cache, or the whole of an SSM state
RING, FULL, STATE = "ring", "full", "state"


def cache_layout(cfg: ModelConfig) -> dict:
    """The cache dict's keys and, for each tensor under a key, what a
    decode step writes in it (``RING``, ``FULL`` or ``STATE``), as the
    reference lays its caches out (the module docstring)."""
    if cfg.local_global_pattern is not None:
        layout = {"group_local": (RING, RING), "group_global": (FULL, FULL)}
        if groups(cfg)[2]:
            layout["tail_local"] = (RING, RING)
        return layout
    if cfg.family == SSM:
        return {"layers": (STATE, STATE)}
    kv = (RING, RING) if cfg.sliding_window is not None else (FULL, FULL)
    return {"layers": kv + ((STATE, STATE) if cfg.family == HYBRID else ())}


class Layer(nn.Module):
    """One layer's weights, as the reference's ``init_layer``: ``ln1``;
    ``attn`` (dense, MoE, hybrid, VLM); ``ssm`` (SSM, hybrid); ``attn_norm``
    and ``ssm_norm`` (hybrid); ``ln2`` and ``moe`` (MoE) or ``ln2`` and
    ``mlp`` where ``d_ff > 0``."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig):
        super().__init__()
        dtype, dev, fam = compute_dtype(cfg), gen.device, cfg.family
        self.ln1 = L.zeros_f32(cfg.d_model, dev)
        if fam in (DENSE, MOE, HYBRID, VLM):
            self.attn = A.init_attn(gen, cfg, dtype)
        if fam in (SSM, HYBRID):
            self.ssm = M.init_ssm(gen, cfg, dtype)
        if fam == HYBRID:
            self.attn_norm = L.zeros_f32(cfg.d_model, dev)
            self.ssm_norm = L.zeros_f32(cfg.d_model, dev)
        if fam == MOE:
            self.ln2 = L.zeros_f32(cfg.d_model, dev)
            self.moe = E.init_moe(gen, cfg, dtype)
        elif cfg.d_ff > 0:
            self.ln2 = L.zeros_f32(cfg.d_model, dev)
            self.mlp = L.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype)


def axes_layer(cfg: ModelConfig) -> dict:
    """A layer's logical axes, laid out as ``Layer``'s weights."""
    a: dict = {"ln1": (None,)}
    fam = cfg.family
    if fam in (DENSE, MOE, HYBRID, VLM):
        a["attn"] = A.axes_attn(cfg)
    if fam in (SSM, HYBRID):
        a["ssm"] = M.axes_ssm()
    if fam == HYBRID:
        a["attn_norm"] = (None,)
        a["ssm_norm"] = (None,)
    if fam == MOE:
        a["ln2"] = (None,)
        a["moe"] = E.axes_moe()
    elif cfg.d_ff > 0:
        a["ln2"] = (None,)
        a["mlp"] = L.axes_mlp()
    return a


def param_axes(cfg: ModelConfig) -> dict:
    """The reference's ``param_axes`` tree without its stacking axes: one
    layer's axes under each stack (``layers``, or ``group_local``,
    ``group_global`` and ``tail_local``)."""
    axes: dict = {"embed": L.axes_embed(cfg.tie_embeddings),
                  "final_norm": (None,)}
    la = axes_layer(cfg)
    if cfg.local_global_pattern is None:
        axes["layers"] = la
        return axes
    axes["group_local"] = axes["group_global"] = la
    if groups(cfg)[2]:
        axes["tail_local"] = la
    return axes


def _kv_axes(stack: tuple) -> tuple:
    ax = (*stack, "kv_batch", "kv_heads", "ctx", None)
    return (ax, ax)


def _ssm_axes(stack: tuple) -> tuple:
    return ((*stack, "batch", None, "heads"),
            (*stack, "batch", "heads", None, None))


def cache_axes(cfg: ModelConfig) -> dict:
    """The caches' logical axes, as the reference's ``cache_axes``: the
    cache dict's keys and, per tensor, its stacking axes first."""
    if cfg.local_global_pattern is not None:
        c = {"group_local": _kv_axes(("groups", "layers")),
             "group_global": _kv_axes(("groups",))}
        if groups(cfg)[2]:
            c["tail_local"] = _kv_axes(("layers",))
        return c
    if cfg.family == SSM:
        return {"layers": _ssm_axes(("layers",))}
    if cfg.family == HYBRID:
        return {"layers": _kv_axes(("layers",)) + _ssm_axes(("layers",))}
    return {"layers": _kv_axes(("layers",))}


def _stack(gen: torch.Generator, cfg: ModelConfig, n: int) -> nn.ModuleList:
    return nn.ModuleList(init_layer(gen, cfg) for _ in range(n))


class Params(nn.Module):
    """The reference's ``init_params`` pytree as a module: ``embed``
    (``tok``, ``unembed``), ``final_norm``, and ``layers`` for a uniform
    stack, or ``group_local`` (G lists of nl layers), ``group_global`` (G
    layers) and ``tail_local`` (if any) for a gemma3 stack."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig):
        super().__init__()
        self.embed = L.init_embed(gen, cfg.vocab_size, cfg.d_model,
                                  cfg.tie_embeddings, compute_dtype(cfg))
        self.final_norm = L.zeros_f32(cfg.d_model, gen.device)
        if cfg.local_global_pattern is None:
            self.layers = _stack(gen, cfg, cfg.num_layers)
            return
        n_groups, n_local, n_tail = groups(cfg)
        self.group_local = nn.ModuleList(_stack(gen, cfg, n_local)
                                         for _ in range(n_groups))
        self.group_global = _stack(gen, cfg, n_groups)
        if n_tail:
            self.tail_local = _stack(gen, cfg, n_tail)


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
               window: int | None, collect_cache: bool):
    """One layer, full sequence (``rope_cs``: ``layers.rope_tables`` of
    the positions, None for an SSM stack; ``window``: the attention's
    sliding window or None). Returns (x, cache or (), aux): the cache is
    (k, v), (conv_state, h_state) or (k, v, conv_state, h_state) by
    family; aux is the MoE layer's balance loss, 0.0 for other
    layers. On a mesh, the layer's FSDP-split weights are gathered
    first."""
    lp = gathered(lp)
    fam = cfg.family
    aux = 0.0
    h = L.rms_norm(x, lp.ln1, cfg.rms_eps)
    cache = ()
    if fam in (DENSE, MOE, HYBRID, VLM):
        a_out, cache = A.attn_full(lp.attn, cfg, h, rope_cs, window=window)
    if fam in (SSM, HYBRID):
        if collect_cache:
            s_out, state = M.ssm_full(lp.ssm, cfg, h, return_state=True)
            cache = cache + state
        else:
            s_out = M.ssm_full(lp.ssm, cfg, h)
    if fam == HYBRID:
        a_out = L.rms_norm(a_out, lp.attn_norm, cfg.rms_eps)
        s_out = L.rms_norm(s_out, lp.ssm_norm, cfg.rms_eps)
        x = x + 0.5 * (a_out + s_out)
    else:
        x = x + (s_out if fam == SSM else a_out)
    if fam == MOE:
        m_out, aux = E.moe(lp.moe, cfg, L.rms_norm(x, lp.ln2, cfg.rms_eps))
        x = x + m_out
    elif cfg.d_ff > 0:
        x = x + L.mlp(lp.mlp, L.rms_norm(x, lp.ln2, cfg.rms_eps))
    return x, (cache if collect_cache else ()), aux


def layer_decode(lp: Layer, cfg: ModelConfig, x: torch.Tensor, cache: tuple,
                 rope_cs, slot):
    """One layer, one token. ``cache`` is this layer's slice of the
    stacked caches ((k, v), (conv_state, h_state) or (k, v, conv_state,
    h_state)), updated in place and returned; ``rope_cs`` and ``slot``
    (``decode_slot``'s (write index, lengths) of this layer's K/V cache,
    None for an SSM stack) are built once per step by ``decode_step``."""
    fam = cfg.family
    h = L.rms_norm(x, lp.ln1, cfg.rms_eps)
    if fam in (DENSE, MOE, HYBRID, VLM):
        write_idx, lengths = slot
        a_out, _, _ = A.attn_decode(lp.attn, cfg, h, rope_cs, cache[0],
                                    cache[1], lengths, write_idx)
    if fam in (SSM, HYBRID):
        conv_st, h_st = cache[-2], cache[-1]
        s_out, conv_new, h_new = M.ssm_decode(lp.ssm, cfg, h, conv_st, h_st)
        conv_st.copy_(conv_new)
        h_st.copy_(h_new)
    if fam == HYBRID:
        a_out = L.rms_norm(a_out, lp.attn_norm, cfg.rms_eps)
        s_out = L.rms_norm(s_out, lp.ssm_norm, cfg.rms_eps)
        x = x + 0.5 * (a_out + s_out)
    else:
        x = x + (s_out if fam == SSM else a_out)
    if fam == MOE:
        x = x + E.moe(lp.moe, cfg, L.rms_norm(x, lp.ln2, cfg.rms_eps))[0]
    elif cfg.d_ff > 0:
        x = x + L.mlp(lp.mlp, L.rms_norm(x, lp.ln2, cfg.rms_eps))
    return x, cache


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill) and decode
# ---------------------------------------------------------------------------

def _run_stack(layers, cfg: ModelConfig, x: torch.Tensor, rope_cs,
               window: int | None, collect: bool, aux, remat: bool = False):
    """Layers in turn -> (x, aux summed, each cache tensor stacked on a
    leading axis, or None); ``remat``: each layer under a checkpoint."""
    per_layer = []
    for lp in layers:
        if remat:
            x, cache, a = checkpoint(layer_full, lp, cfg, x, rope_cs, window,
                                     collect, use_reentrant=False)
        else:
            x, cache, a = layer_full(lp, cfg, x, rope_cs, window, collect)
        aux = aux + a
        per_layer.append(cache)
    stacked = (tuple(torch.stack(parts) for parts in zip(*per_layer))
               if collect else None)
    return x, aux, stacked


def forward(params: Params, cfg: ModelConfig, x_embed: torch.Tensor,
            collect_cache: bool = False, remat: bool = False):
    """Embedded inputs -> (final hidden, aux loss, caches or None); the
    caches are the module docstring's dict, each cache tensor of a
    layer stacked on the leading axes. The aux loss is the MoE layers'
    balance terms summed, a float32 tensor, 0.0 for a stack without MoE
    layers. ``remat``: activation checkpointing (the module
    docstring)."""
    rope_cs = None
    if cfg.family != SSM:
        positions = torch.arange(x_embed.shape[1], device=x_embed.device)
        rope_cs = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    x, aux, caches = x_embed, 0.0, {}
    if cfg.local_global_pattern is None:
        x, aux, caches["layers"] = _run_stack(
            params.layers, cfg, x, rope_cs, cfg.sliding_window,
            collect_cache, aux, remat)
    else:
        local, glob = [], []
        for loc, gl in zip(params.group_local, params.group_global):
            x, aux, c = _run_stack(loc, cfg, x, rope_cs, cfg.sliding_window,
                                   collect_cache, aux, remat)
            local.append(c)
            x, c, a = layer_full(gl, cfg, x, rope_cs, None, collect_cache)
            aux = aux + a
            glob.append(c)
        if collect_cache:
            caches["group_local"] = tuple(torch.stack(parts)
                                          for parts in zip(*local))
            caches["group_global"] = tuple(torch.stack(parts)
                                           for parts in zip(*glob))
        if hasattr(params, "tail_local"):
            x, aux, caches["tail_local"] = _run_stack(
                params.tail_local, cfg, x, rope_cs, cfg.sliding_window,
                collect_cache, aux, remat)
    x = L.rms_norm(x, params.final_norm, cfg.rms_eps)
    return x, aux, (caches if collect_cache else None)


def logits_from_hidden(params: Params, cfg: ModelConfig,
                       x: torch.Tensor) -> torch.Tensor:
    return L.unembed(params.embed, x)


def decode_slot(pos: torch.Tensor, k_cache: torch.Tensor, ring: bool,
                B: int):
    """The K/V slot a token at ``pos`` writes (``pos % W`` in a W-slot
    ring, ``pos`` in a full cache) and the (B,) int32 lengths it attends
    over (``min(pos + 1, W)``), both computed on pos's device."""
    W = k_cache.shape[-2]
    write_idx = torch.remainder(pos, W) if ring else pos
    lengths = torch.clamp(pos + 1, max=W).to(torch.int32).repeat(B)
    return write_idx, lengths


def _decode_stack(layers, cfg: ModelConfig, x: torch.Tensor, cache: tuple,
                  rope_cs, slot) -> torch.Tensor:
    """Layers in turn, one token; layer l reads and writes ``t[l]`` of
    each stacked cache tensor."""
    for l, lp in enumerate(layers):
        x, _ = layer_decode(lp, cfg, x, tuple(t[l] for t in cache), rope_cs,
                            slot)
    return x


def decode_step(params: Params, cfg: ModelConfig, caches: dict,
                token: torch.Tensor, pos: int | torch.Tensor):
    """token (B, 1) at absolute position pos -> (logits (B, 1, V),
    caches), the caches updated in place.

    ``pos`` is an int or a one-element int64 tensor on the token's
    device. The step reads no host value: the rotary tables, the lengths,
    and the cache slot written (``pos``, or ``pos % W`` in a ring) all
    come from that tensor on the device, so a CUDA graph captures the
    step once for every position (``model_zoo.Model.decode``). A full
    (windowless) cache must have a slot at pos (0 <= pos < slots)."""
    x = L.embed_tokens(params.embed, token)
    B = x.shape[0]
    rope_cs = None
    if cfg.family != SSM:
        if not isinstance(pos, torch.Tensor):
            pos = torch.full((1,), pos, dtype=torch.int64, device=x.device)
        pos = pos.reshape(1)
        rope_cs = L.rope_tables(pos, cfg.head_dim, cfg.rope_theta)
    layout = cache_layout(cfg)

    def slot(key: str):
        return (None if layout[key][0] == STATE else
                decode_slot(pos, caches[key][0], layout[key][0] == RING, B))

    if cfg.local_global_pattern is None:
        x = _decode_stack(params.layers, cfg, x, caches["layers"], rope_cs,
                          slot("layers"))
    else:
        local, glob = caches["group_local"], caches["group_global"]
        s_loc, s_glob = slot("group_local"), slot("group_global")
        for g, (loc, gl) in enumerate(zip(params.group_local,
                                          params.group_global)):
            x = _decode_stack(loc, cfg, x, tuple(t[g] for t in local),
                              rope_cs, s_loc)
            x, _ = layer_decode(gl, cfg, x, tuple(t[g] for t in glob),
                                rope_cs, s_glob)
        if hasattr(params, "tail_local"):
            x = _decode_stack(params.tail_local, cfg, x, caches["tail_local"],
                              rope_cs, slot("tail_local"))
    x = L.rms_norm(x, params.final_norm, cfg.rms_eps)
    return logits_from_hidden(params, cfg, x), caches
