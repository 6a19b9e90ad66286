"""Mixture-of-Experts layer: top-k routing with capacity-bounded,
sort-based dispatch and the Switch load-balance loss.

Port of ``repro/models/moe.py``. Token-expert pairs are sorted by expert
(a stable sort), ranked within their expert, and gathered into
per-expert capacity buffers of ``cap`` slots; pairs past ``cap`` are
dropped (GShard/Switch semantics) and their share of the residual
stream falls through the skip connection. The expert products run over
every expert's buffer, as the reference's do, so compute follows the
buffers, not the active experts.

On a mesh (``sharding``'s rules) the routing keeps the reference's
global semantics, which GSPMD gives it over the whole batch: the
capacity comes from the global token count, a pair's rank within its
expert counts the pairs of the batch's earlier ranks first (their
counts are all-gathered), and the balance loss takes the global mean
probabilities and counts. The router is gathered whole on every rank
of the experts' axis, which routes alike; a rank runs its own experts
(expert parallel, the ``experts`` rule) on its tokens and the outputs
are summed over the experts' ranks (the reference's ``constrain`` of
the output).

Nothing here reads a value on the host: counts are a ``scatter_add_``
into ``zeros(E)`` (``torch.bincount`` syncs on CUDA to size its
output), the reference's ``.at[e, slot].set(..., mode="drop")`` is a
scatter into ``(E, cap + 1)`` whose last column takes the dropped pairs
and is sliced off, and ``cap`` is a host int from the shapes. So a
decode step with a MoE layer still captures as one CUDA graph.

Weights: ``router`` stays float32 (the reference computes the logits as
``x.astype(float32) @ router.astype(float32)``); ``wi``, ``wg`` and
``wo`` are held in the compute dtype (the reference casts at every use,
which rounds the same way).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.sharding.collectives import (all_gather, axis_of, enter,
                                              gather, reduce)


def init_moe(gen: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype) -> nn.ParameterDict:
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    return nn.ParameterDict({
        "router": L._dense_init(gen, (d, E), torch.float32),
        "wi": L._dense_init(gen, (E, d, f), dtype),
        "wg": L._dense_init(gen, (E, d, f), dtype),
        "wo": L._dense_init(gen, (E, f, d), dtype),
    })


def axes_moe() -> dict:
    # experts take the whole TP ("model") axis, so the per-expert ffn dim
    # must not also map to it (one mesh axis per spec); d_model rows get
    # the FSDP ("data") shard instead
    return {
        "router": ("embed", "experts"),
        "wi": ("experts", "embed_fsdp", None),
        "wg": ("experts", "embed_fsdp", None),
        "wo": ("experts", None, "embed_fsdp"),
    }


def capacity(T: int, k: int, E: int, capacity_factor: float) -> int:
    """Slots per expert: ``ceil(T k cf / E)`` rounded up to a multiple of
    8, at least 8."""
    cap = int(-(-T * k * capacity_factor // E))
    return max(8, -(-cap // 8) * 8)


class Routing(NamedTuple):
    """Where each token-expert pair goes. Flat pairs are token-major
    (pair ``t * k + j`` is token t's j-th choice); ``order`` sorts them by
    expert, stably, and ``slot``/``keep`` are in that sorted order."""
    topv: torch.Tensor    # (T, k) float32 gate weights, normalised
    topi: torch.Tensor    # (T, k) int64 experts, best first
    aux: torch.Tensor     # () float32 Switch load-balance loss
    order: torch.Tensor   # (T*k,) int64 stable argsort of the experts
    slot: torch.Tensor    # (T*k,) int64 rank of the pair within its expert
    keep: torch.Tensor    # (T*k,) bool slot < cap
    cap: int


def route(p, cfg: ModelConfig, xt: torch.Tensor, capacity_factor: float,
          batch=None) -> Routing:
    """Route tokens ``xt`` (T, d) with the whole ``p["router"]`` (d, E):
    softmax of the float32 logits, top-k normalised by ``max(sum,
    1e-9)``, the aux loss, and each pair's rank within its expert after
    a stable sort by expert. ``batch`` (a mesh axis that splits the
    tokens) makes the capacity, the ranks and the aux loss those of the
    whole batch (the module docstring)."""
    T = xt.shape[0]
    E, k = cfg.num_experts, cfg.experts_per_token
    logits = xt.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)                       # (T, E)
    topv, topi = torch.topk(probs, k, dim=-1)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)

    flat_e = topi.reshape(-1)
    counts = torch.zeros(E, dtype=torch.int64, device=xt.device)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(T * k, device=xt.device) - starts[se]
    # Switch-style load balance: E * sum(mean prob * share of assignments)
    if batch is None:
        me = probs.mean(0)
        ce = counts.float() / T / k
        cap = capacity(T, k, E, capacity_factor)
        return Routing(topv, topi, E * torch.sum(me * ce), order, slot,
                       slot < cap, cap)
    Tg = T * batch.size
    every = all_gather(counts.float()[None], batch, 0).long()  # (D, E)
    before = every[:batch.index].sum(0)
    me = reduce(probs.sum(0), batch) / Tg
    ce = every.sum(0).float() / Tg / k
    cap = capacity(Tg, k, E, capacity_factor)
    return Routing(topv, topi, E * torch.sum(me * ce), order, slot,
                   before[se] + slot < cap, cap)


def moe(p, cfg: ModelConfig, x: torch.Tensor,
        capacity_factor: float | None = None):
    """x: (B, S, d) -> (out (B, S, d) in x's dtype, aux loss () float32).
    On a mesh, this rank's tokens and experts (the module docstring)."""
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity_factor
    B, S, d = x.shape
    k = cfg.experts_per_token
    T = B * S
    ax = axis_of("experts")
    xt = x.reshape(T, d)
    r = route({"router": gather(p["router"], ax, 1)}, cfg, xt,
              capacity_factor, axis_of("batch"))
    cap = r.cap
    se = r.topi.reshape(-1)[r.order]
    st = r.order // k                          # the token of each sorted pair
    sw = r.topv.reshape(-1)[r.order]
    keep = r.keep
    E = p["wi"].shape[0]                       # this rank's experts
    if ax is not None:                         # the pairs of other experts
        se = se - ax.index * E                 # go nowhere
        keep = keep & (se >= 0) & (se < E)
        se = se.clamp(0, E - 1)
        xt, sw = enter(xt, ax), enter(sw, ax)

    # dispatch: the slot -> token map and its occupancy, the dropped pairs
    # written to the spare column ``cap``, then gather the tokens
    dest = se * (cap + 1) + torch.where(keep, r.slot, cap)
    tok_of_slot = torch.zeros(E * (cap + 1), dtype=torch.int64,
                              device=x.device).scatter_(0, dest, st)
    has_tok = torch.zeros(E * (cap + 1), dtype=x.dtype,
                          device=x.device).scatter_(
                              0, dest, torch.ones_like(sw, dtype=x.dtype))
    tok_of_slot = tok_of_slot.view(E, cap + 1)[:, :cap].reshape(-1)
    has_tok = has_tok.view(E, cap + 1)[:, :cap]
    buf = xt.index_select(0, tok_of_slot).view(E, cap, d) * has_tok[..., None]

    # the expert products over every expert's buffer
    h = torch.bmm(buf, p["wi"])
    g = torch.bmm(buf, p["wg"])
    y = torch.bmm(F.silu(g) * h, p["wo"])                     # (E, cap, d)

    # combine: gather each sorted pair's output, weight it, un-permute,
    # sum a token's k outputs
    gathered = y.reshape(E * cap, d).index_select(
        0, se * cap + torch.clamp(r.slot, max=cap - 1))
    contrib = gathered * (sw * keep).to(x.dtype)[:, None]
    inv = torch.argsort(r.order)
    out = contrib.index_select(0, inv).view(T, k, d).sum(1)
    return reduce(out.view(B, S, d), ax), r.aux
