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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L


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


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    inner, H, P, N, _ = _dims(cfg)
    z = proj[..., :inner]
    xin = proj[..., inner:2 * inner]
    Bc = proj[..., 2 * inner:2 * inner + N]
    Cc = proj[..., 2 * inner + N:2 * inner + 2 * N]
    dt = proj[..., 2 * inner + 2 * N:]
    return z, xin, Bc, Cc, dt


def _gated_out(p, cfg: ModelConfig, y: torch.Tensor, z: torch.Tensor):
    """Gated RMSNorm then the output projection. ``F.silu`` on a
    bfloat16 gate computes in float32 and rounds once, as the
    reference's cast, silu, cast."""
    y = L.rms_norm(y * F.silu(z), p["norm"], cfg.rms_eps)
    return y @ p["out_proj"]


def ssm_full(p, cfg: ModelConfig, x: torch.Tensor,
             return_state: bool = False):
    """x: (B, S, d) in the compute dtype -> out (B, S, d)
    [, (conv_state (B, ck-1, conv_dim), h_state (B, H, N, P) float32)]."""
    B, S, _ = x.shape
    inner, H, P, N, _ = _dims(cfg)
    proj = x @ p["in_proj"]
    z, xin, Bc, Cc, dt_raw = _split_proj(cfg, proj)

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
    Bc = conv[..., inner:inner + N].float().contiguous()
    Cc = conv[..., inner + N:].float().contiguous()

    dt = F.softplus(dt_raw.float() + p["dt_bias"])            # (B,S,H)
    A = -torch.exp(p["A_log"])                                # (H,)
    xh = xin.reshape(B, S, H, P).contiguous()
    y = ops.ssd(xh, dt, A, Bc, Cc, chunk=cfg.ssm_chunk)
    out = _gated_out(p, cfg, y.reshape(B, S, inner), z)
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
    inner, H, P, N, _ = _dims(cfg)
    proj = (x @ p["in_proj"])[:, 0]
    z, xin, Bc, Cc, dt_raw = _split_proj(cfg, proj)

    conv_in = torch.cat([xin, Bc, Cc], dim=-1)                # (B, conv_dim)
    window = torch.cat([conv_state, conv_in[:, None]], dim=1)  # (B, ck, C)
    # the reference's einsum "bkc,kc->bc": exact products, a float32 sum,
    # one rounding to the compute dtype
    conv = (window.float() * p["conv_w"].float()).sum(1).to(dtype)
    conv = F.silu(conv + p["conv_b"])
    xin = conv[..., :inner]
    Bc = conv[..., inner:inner + N]
    Cc = conv[..., inner + N:]

    dt = F.softplus(dt_raw.float() + p["dt_bias"])            # (B,H)
    A = -torch.exp(p["A_log"])
    h_state, y = ops.ssd_decode_step(
        h_state, xin.reshape(B, H, P).float(), dt, A, Bc.float(), Cc.float())
    out = _gated_out(p, cfg, y.reshape(B, inner).to(dtype), z)
    return out[:, None], window[:, 1:], h_state
