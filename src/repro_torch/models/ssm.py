"""Mamba-2 (SSD) mixer block [arXiv:2405.21060], ngroups=1.

Port of ``repro/models/ssm.py``. The full path runs the chunked SSD scan
through ``kernels.ops.ssd`` (the CUDA kernel on the card, its plain
version on the CPU); decode is the O(1)-state recurrence
(``ops.ssd_decode_step``, a rank-1 update with no kernel). The block also
returns its final conv and SSM states so serving can hand prefill over
to decode.

Weights: the reference casts ``in_proj``, ``out_proj``, ``conv_w`` and
``conv_b`` to the compute dtype at every use; the port holds them in
that dtype (one cast at load rounds the same way). ``A_log``,
``dt_bias`` and ``norm`` are read in float32 and stay float32.

On a mesh that splits the heads (``model``) a rank holds its heads'
share of every packed column group: of ``in_proj``'s z, x, B, C and dt
columns, of ``conv_w``'s and ``conv_b``'s x, B and C columns (and so of
the conv cache), ``norm``'s and ``out_proj``'s inner rows, the SSD
state of its heads (``head_order`` gives the whole tensors' columns in
that order, ``Model.shard`` cuts the blocks from it). The conv is
depthwise, so a rank convolves its own columns; B and C (ngroups = 1,
shared by every head) are then gathered whole, the gated RMSNorm's sum
of squares is summed over the heads' ranks, and the output projection
is a partial sum, as the attention's is. ``A_log`` and ``dt_bias`` stay
whole on every rank, which takes its heads' entries. Where the heads or
B/C do not split so (hymba's 25 heads over 16 ranks), the weights are
split as ``fit_spec`` cuts their dims and gathered whole at use
(``usable``), as the reference's GSPMD gathers them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.sharding.collectives import (_gather_summed, dim_axis,
                                              enter, reduce)


def _dims(cfg: ModelConfig):
    inner = cfg.ssm_inner
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    conv_dim = inner + 2 * N
    return inner, H, P, N, conv_dim


def init_ssm(gen: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype) -> nn.ParameterDict:
    d = cfg.d_model
    inner, H, P, N, conv_dim = _dims(cfg)
    dev = gen.device

    def f32(t: torch.Tensor) -> nn.Parameter:
        return nn.Parameter(t.to(device=dev, dtype=torch.float32),
                            requires_grad=False)

    return nn.ParameterDict({
        "in_proj": L._dense_init(gen, (d, 2 * inner + 2 * N + H), dtype),
        "conv_w": L._dense_init(gen, (cfg.ssm_conv, conv_dim), dtype,
                                scale=0.3),
        "conv_b": nn.Parameter(torch.zeros(conv_dim, dtype=dtype, device=dev),
                               requires_grad=False),
        "A_log": f32(torch.log(torch.linspace(1.0, 16.0, H))),
        "dt_bias": f32(torch.full((H,), -2.0)),
        "norm": f32(torch.zeros(inner)),
        "out_proj": L._dense_init(gen, (inner, d), dtype),
    })


def axes_ssm() -> dict:
    return {
        "in_proj": ("embed_fsdp", "heads"),
        "conv_w": ("conv", "heads"),
        "conv_b": ("heads",),
        "A_log": (None,),
        "dt_bias": (None,),
        "norm": ("heads",),
        "out_proj": ("heads", "embed_fsdp"),
    }


def head_order(cfg: ModelConfig, ways: int, packed: str) -> tuple:
    """The whole ``in_proj`` columns (``packed="in_proj"``) or conv
    columns (``"conv"``) in the order whose ``ways`` contiguous blocks
    are each rank's heads' share of every group (the module
    docstring)."""
    inner, H, P, N, _ = _dims(cfg)
    sizes = ((inner, inner, N, N, H) if packed == "in_proj"
             else (inner, N, N))
    starts = [sum(sizes[:i]) for i in range(len(sizes))]
    out = []
    for r in range(ways):
        for a, n in zip(starts, sizes):
            out.extend(range(a + r * n // ways, a + (r + 1) * n // ways))
    return tuple(out)


def can_split(cfg: ModelConfig, ways: int) -> bool:
    """Whether the heads, the inner width and B/C split ``ways`` ways."""
    inner, H, P, N, _ = _dims(cfg)
    return H % ways == 0 and N % ways == 0


_PACKED = {"in_proj": 1, "conv_w": 1, "conv_b": 0, "norm": 0, "out_proj": 0}


def usable(p, cfg: ModelConfig):
    """The block's weights as the rank computes with them: ``p`` itself,
    or, where their split is not by head group (``can_split``), each
    split weight gathered whole."""
    ax = dim_axis(p["in_proj"], 1) or dim_axis(p["out_proj"], 0)
    if ax is None or (dim_axis(p["in_proj"], 1) is not None
                      and can_split(cfg, ax.size)):
        return p
    out = {k: p[k] for k in ("A_log", "dt_bias")}
    for k, dim in _PACKED.items():
        a = dim_axis(p[k], dim)
        out[k] = p[k] if a is None else _gather_summed(p[k], a, dim)
    return out


def _local(cfg: ModelConfig, ax):
    """(inner, H, N) of this rank's share (the whole off a split)."""
    inner, H, P, N, _ = _dims(cfg)
    m = 1 if ax is None else ax.size
    return inner // m, H // m, N // m


def _split_proj(cfg: ModelConfig, proj: torch.Tensor, ax=None):
    inner, H, N = _local(cfg, ax)
    z = proj[..., :inner]
    xin = proj[..., inner:2 * inner]
    Bc = proj[..., 2 * inner:2 * inner + N]
    Cc = proj[..., 2 * inner + N:2 * inner + 2 * N]
    dt = proj[..., 2 * inner + 2 * N:]
    return z, xin, Bc, Cc, dt


def _heads_slice(w: torch.Tensor, ax) -> torch.Tensor:
    """This rank's heads' entries of a whole per-head weight."""
    if ax is None:
        return w
    n = w.shape[0] // ax.size
    return enter(w, ax).narrow(0, ax.index * n, n)


def _whole_bc(t: torch.Tensor, ax) -> torch.Tensor:
    """B or C columns of the rank gathered whole over the heads' ranks."""
    return t if ax is None else _gather_summed(t, ax, -1)


def _gated_out(p, cfg: ModelConfig, y: torch.Tensor, z: torch.Tensor,
               ax=None):
    """Gated RMSNorm then the output projection. ``F.silu`` on a
    bfloat16 gate computes in float32 and rounds once, as the
    reference's cast, silu, cast. Split over ``ax``, the norm's mean
    square is the whole inner width's and the product a partial sum."""
    g = y * F.silu(z)
    if ax is None:
        return L.rms_norm(g, p["norm"], cfg.rms_eps) @ p["out_proj"]
    gf = g.float()
    # every rank's columns read the sum: its gradient summed back (enter)
    ms = enter(reduce(gf.square().sum(-1, keepdim=True), ax),
               ax) / cfg.ssm_inner
    y = (gf * torch.rsqrt(ms + cfg.rms_eps)
         * (1.0 + p["norm"].float())).to(g.dtype)
    return reduce(y @ p["out_proj"], ax)


def ssm_full(p, cfg: ModelConfig, x: torch.Tensor,
             return_state: bool = False):
    """x: (B, S, d) in the compute dtype -> out (B, S, d)
    [, (conv_state (B, ck-1, conv_dim), h_state (B, H, N, P) float32)]."""
    B, S, _ = x.shape
    p = usable(p, cfg)
    ax = dim_axis(p["in_proj"], 1)
    inner, H, N = _local(cfg, ax)
    P = cfg.ssm_head_dim
    proj = enter(x, ax) @ p["in_proj"]
    z, xin, Bc, Cc, dt_raw = _split_proj(cfg, proj, ax)

    # causal depthwise conv over (x, B, C): the reference's sum, term by
    # term in the compute dtype, then silu in float32
    conv_in = torch.cat([xin, Bc, Cc], dim=-1)                 # (B,S,conv_dim)
    ck = cfg.ssm_conv
    padded = F.pad(conv_in, (0, 0, ck - 1, 0))
    w = p["conv_w"]
    conv = padded[:, 0:S] * w[0]
    for i in range(1, ck):
        conv = conv + padded[:, i:i + S] * w[i]
    conv = F.silu(conv + p["conv_b"])
    xin = conv[..., :inner]
    Bc = _whole_bc(conv[..., inner:inner + N], ax).float().contiguous()
    Cc = _whole_bc(conv[..., inner + N:], ax).float().contiguous()
    N = Bc.shape[-1]

    dt = F.softplus(dt_raw.float() + _heads_slice(p["dt_bias"], ax))
    A = -torch.exp(_heads_slice(p["A_log"], ax))              # (H,)
    xh = xin.reshape(B, S, H, P).contiguous()
    y = ops.ssd(xh, dt, A, Bc, Cc, chunk=cfg.ssm_chunk)
    out = _gated_out(p, cfg, y.reshape(B, S, inner), z, ax)
    if not return_state:
        return out

    # final states for the prefill -> decode hand-off: the reference's
    # einsum "bsh,bsn,bshp->bhnp" with w folded into x first and s
    # contracted as one batched product (B, N, S) @ (B, S, H*P), so no
    # (B, S, H, N, P) intermediate is formed
    cum = torch.cumsum(A * dt, dim=1)                         # (B,S,H)
    wt = torch.exp(cum[:, -1:, :] - cum) * dt
    xw = (xh.float() * wt[..., None]).reshape(B, S, H * P)
    h = torch.bmm(Bc.transpose(1, 2), xw)                     # (B,N,H*P)
    h = h.reshape(B, N, H, P).permute(0, 2, 1, 3).contiguous()
    conv_state = F.pad(conv_in, (0, 0, ck - 1, 0))[:, -(ck - 1):]
    return out, (conv_state.contiguous(), h)


def ssm_decode(p, cfg: ModelConfig, x: torch.Tensor,
               conv_state: torch.Tensor, h_state: torch.Tensor):
    """x: (B, 1, d). Returns (out (B, 1, d), conv_state', h_state'), the
    states as new tensors."""
    B = x.shape[0]
    dtype = x.dtype
    p = usable(p, cfg)
    ax = dim_axis(p["in_proj"], 1)
    inner, H, N = _local(cfg, ax)
    P = cfg.ssm_head_dim
    proj = (enter(x, ax) @ p["in_proj"])[:, 0]
    z, xin, Bc, Cc, dt_raw = _split_proj(cfg, proj, ax)

    conv_in = torch.cat([xin, Bc, Cc], dim=-1)                # (B, conv_dim)
    window = torch.cat([conv_state, conv_in[:, None]], dim=1)  # (B, ck, C)
    # the reference's einsum "bkc,kc->bc": exact products, a float32 sum,
    # one rounding to the compute dtype
    conv = (window.float() * p["conv_w"].float()).sum(1).to(dtype)
    conv = F.silu(conv + p["conv_b"])
    xin = conv[..., :inner]
    Bc = _whole_bc(conv[..., inner:inner + N], ax)
    Cc = _whole_bc(conv[..., inner + N:], ax)

    dt = F.softplus(dt_raw.float() + _heads_slice(p["dt_bias"], ax))
    A = -torch.exp(_heads_slice(p["A_log"], ax))
    h_state, y = ops.ssd_decode_step(
        h_state, xin.reshape(B, H, P).float(), dt, A, Bc.float(), Cc.float())
    out = _gated_out(p, cfg, y.reshape(B, inner).to(dtype), z, ax)
    return out[:, None], window[:, 1:], h_state
