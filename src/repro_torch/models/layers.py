"""Shared model building blocks.

Port of ``repro/models/layers.py``: RMSNorm, rotary embedding, Whisper's
sinusoidal positions, token embedding and unembedding, the SwiGLU MLP,
and their ``init_*`` functions. Weights keep the reference's layouts
(``(in, out)`` matrices, ``x @ w``) so converted JAX weights load as
they are. The reference casts each float32 weight to the compute dtype
at every use; the port holds matrices in that dtype from the start (a
cast once at load, which rounds the same way) and keeps norm weights in
float32.

Every ``init_*`` has a mirrored ``axes_*`` giving each weight's logical
axes (``Model.param_axes``). On a mesh of ranks (``launch/mesh.py``) a
rank holds its blocks of the weights: the embedding and unembedding its
share of the vocabulary, the MLP its share of the FFN columns. The
collectives sit at the reference's ``constrain`` points
(``sharding.collectives``): the embedding's rows summed over the
vocabulary's ranks, the MLP's output over the FFN's; off a mesh they are
the identity.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import fmath
from repro_torch.sharding.collectives import (axis_of, enter, gathered,
                                              reduce)


def _dense_init(gen: torch.Generator, shape: tuple, dtype: torch.dtype,
                scale: float | None = None) -> nn.Parameter:
    """Normal(0, 1) * scale (default ``shape[0] ** -0.5``), drawn in
    float32 on the generator's device and stored in ``dtype``; like every
    weight of the port, without ``requires_grad`` until the trainer
    switches the model on (``Model.trainable``)."""
    scale = scale if scale is not None else shape[0] ** -0.5
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device) * scale
    return nn.Parameter(w.to(dtype), requires_grad=False)


def zeros_f32(n: int, device) -> nn.Parameter:
    """A float32 norm weight (``(1 + w)`` scaling, so zeros are identity)."""
    return nn.Parameter(torch.zeros(n, dtype=torch.float32, device=device),
                        requires_grad=False)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + w)`` in float32, cast back.
    ``F.rms_norm`` computes the reference's expression in that order
    (one fused op on the card, fewer host launches)."""
    y = F.rms_norm(x.float(), x.shape[-1:], weight=1.0 + weight.float(),
                   eps=eps)
    return y.to(x.dtype)


def rope_tables(positions: torch.Tensor, D: int, theta: float):
    """(cos, sin) for ``apply_rope``: (S, D) float32 from positions (S,),
    or (B, 1, S, D) from positions (B, S), so they broadcast over the
    heads of (B, H, S, D). Built once per forward or decode step and
    shared by every layer's q and k."""
    half = D // 2
    freq = torch.pow(theta, -torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half)
    angles = positions[..., :, None].float() * freq            # (..., S, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    if positions.ndim == 2:                                    # over heads
        cos, sin = cos[:, None], sin[:, None]
    return torch.cat([cos, cos], dim=-1), torch.cat([-sin, sin], dim=-1)


def apply_rope(x: torch.Tensor, tables) -> torch.Tensor:
    """Rotary embedding of x (B, H, S, D) in float32, cast back. With
    the signed table, ``x*cos + rotate_half(x)*sin`` rounds exactly as
    the reference's ``[x1*cos - x2*sin, x2*cos + x1*sin]``."""
    cos, sin = tables
    half = x.shape[-1] // 2
    xf = x.float()
    rot = torch.cat([xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos + rot * sin).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., S, D) with D even; positions: (S,) or
    (B, S). The two halves of D rotate as a pair, in float32."""
    return apply_rope(x, rope_tables(positions, x.shape[-1], theta))


def sinusoidal_positions(num: int, dim: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings (num, dim) in float32, in
    the reference's order: ``exp(-log(1e4) * i / (half - 1))``, then the
    products with the positions, then ``sin`` and ``cos`` concatenated."""
    half = dim // 2
    i = torch.arange(half, dtype=torch.float32, device=device)
    # XLA:CPU's exp (fmath): torch's lands an ULP away in some entries,
    # ~1e-4 at position 1,500
    freq = fmath.exp(-math.log(10000.0) * i / (half - 1))
    args = torch.arange(num, dtype=torch.float32, device=device)[:, None] \
        * freq[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def init_embed(gen: torch.Generator, vocab: int, d: int, tie: bool,
               dtype: torch.dtype) -> nn.ParameterDict:
    # tied: the table is also the unembedding, so keep logits O(1)
    p = {"tok": _dense_init(gen, (vocab, d), dtype,
                            scale=d ** -0.5 if tie else 1.0)}
    if not tie:
        p["unembed"] = _dense_init(gen, (d, vocab), dtype)
    return nn.ParameterDict(p)


def axes_embed(tie: bool) -> dict:
    a = {"tok": ("vocab", "embed")}
    if not tie:
        a["unembed"] = ("embed", "vocab")
    return a


def embed_tokens(p, tokens: torch.Tensor) -> torch.Tensor:
    """The tokens' rows of the table. On a mesh that splits the
    vocabulary each rank looks up the tokens in its share (zeros for
    the others') and the rows are summed over the vocabulary's ranks."""
    p, ax = gathered(p), axis_of("vocab")
    if ax is None:
        return F.embedding(tokens, p["tok"])
    V = p["tok"].shape[0]
    local = tokens - ax.index * V
    inside = (local >= 0) & (local < V)
    rows = F.embedding(torch.where(inside, local, 0), p["tok"])
    return reduce(rows * inside[..., None], ax)


def unembed(p, x: torch.Tensor) -> torch.Tensor:
    """The logits; on a mesh that splits the vocabulary, this rank's
    share of their last dim (``model_zoo._xent`` takes them so)."""
    p = gathered(p)
    w = p["unembed"] if "unembed" in p else p["tok"].T
    return enter(x, axis_of("vocab")) @ w


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d: int, f: int,
             dtype: torch.dtype) -> nn.ParameterDict:
    return nn.ParameterDict({
        "wi": _dense_init(gen, (d, f), dtype),
        "wg": _dense_init(gen, (d, f), dtype),
        "wo": _dense_init(gen, (f, d), dtype),
    })


def axes_mlp() -> dict:
    return {"wi": ("embed_fsdp", "ffn"), "wg": ("embed_fsdp", "ffn"),
            "wo": ("ffn", "embed_fsdp")}


def mlp(p, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: ``silu(g)`` in float32, cast back, times ``h``, as the
    reference casts. PyTorch's ``silu`` on a bfloat16 tensor computes in
    float32 and rounds once, the same numbers without the two casts.
    On a mesh that splits the FFN a rank's columns give a partial
    output, summed over the FFN's ranks."""
    ax = axis_of("ffn")
    x = enter(x, ax)
    h = x @ p["wi"]
    g = x @ p["wg"]
    return reduce((F.silu(g) * h) @ p["wo"], ax)
