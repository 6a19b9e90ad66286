"""Device dispatch for the port's kernels.

A tensor on the CPU goes to the plain PyTorch version in ``ref.py``;
any other tensor goes to the CUDA kernel, which launches or raises (a
missing ``nvcc``, a failed build, a tensor the kernel does not take, a
refused launch). There is no mode switch and no fallback.

Gradients. On the CPU the plain versions carry PyTorch's autograd. On
the card two kernels have a backward, each paired with it in an autograd
Function: ``attention`` runs as ``FlashAttention`` (the flash kernel,
then ``flash_attention_bwd``: bfloat16 at head dims 64 and 128 on the
tensor cores, float32 and the other head dims on the CUDA cores), and
``ssd`` as ``SSDScan`` (the SSD kernels, then ``ssd_bwd`` on the CUDA
cores). Where no input requires grad, as in serving, or under
``torch.no_grad()``, a Function records nothing and launches the forward
alone. The other kernels (decode attention, the maintenance and KDE
kernels, the round kernel) have no backward, and their wrappers raise on
an input that requires grad rather than cut the graph
(``_build.refuse_grad``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import kde as _kde
from repro_torch.kernels import ref
from repro_torch.kernels import round_fused as _round
from repro_torch.kernels import ssd as _ssd


# every kernel wrapper of the port; each counts its launches in ``launches``
WRAPPERS = (_round.round_step_swrr, _kde.fused_maintenance,
            _kde.kde_success_prob, _fa.flash_attention,
            _fa.flash_attention_bwd, _dec.decode_attention, _ssd.ssd,
            _ssd.ssd_bwd)


def _on_host(x: torch.Tensor) -> bool:
    return x.device.type == "cpu"


def bandit_maintenance_stats(lat, mask, rtt, tau, rho, min_bandwidth=1e-4):
    """Fused Alg-1 window stats per (player, arm) row: Silverman
    bandwidth + Gaussian-CDF success prob at tau + masked rho-quantile
    of ``max(lat - rtt, 0)``. (rows, R) -> ((rows,), (rows,))."""
    if _on_host(lat):
        return ref.bandit_maintenance_stats(lat, mask, rtt, tau, rho,
                                            min_bandwidth)
    return _kde.fused_maintenance(lat, mask, rtt, tau, rho, min_bandwidth)


def round_step(weights, cw, err, cooldown_until, in_pool, active,
               lat_buf, ts_buf, ptr, r_buf, rts_buf, rptr,
               q, nc, z, rtt_t, s_m, served_per_round, t,
               tau: float, err_thresh: int, cooldown: float,
               cooldown_at=None):
    """Fused simulator round: all C SWRR rounds of one step (selection,
    shared-queue recursion, feedback control, ring writes). Returns a
    ``ref.RoundStepOut``; the inputs are left untouched.
    ``cooldown_at`` is a tripped arm's deadline (default ``t +
    cooldown``)."""
    fn = ref.round_step_swrr if _on_host(weights) else _round.round_step_swrr
    return fn(weights, cw, err, cooldown_until, in_pool, active,
              lat_buf, ts_buf, ptr, r_buf, rts_buf, rptr,
              q, nc, z, rtt_t, s_m, served_per_round, t,
              tau=tau, err_thresh=err_thresh, cooldown=cooldown,
              cooldown_at=cooldown_at)


def round_step_gumbel(weights, q, nc, z, gum, rtt_t, s_m, served_per_round):
    """Fused proxy-mity round: all C Gumbel-categorical rounds of one
    step. No kernel: selection is queue-independent, so the batched
    PyTorch form is the fused form on every device. Returns ``(q,
    arrivals, choices, lats, procs)``."""
    return ref.round_step_gumbel(weights, q, nc, z, gum, rtt_t, s_m,
                                 served_per_round)


class FlashAttention(torch.autograd.Function):
    """The flash kernel with its backward kernel: saves q, k and v (the
    backward recomputes the probabilities from them) and returns dq, dk,
    dv from ``flash_attention_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, scale)
        return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale)

    @staticmethod
    def backward(ctx, dout):
        causal, window, scale = ctx.args
        grads = _fa.flash_attention_bwd(*ctx.saved_tensors, dout,
                                        causal=causal, window=window,
                                        scale=scale)
        return (*grads, None, None, None)


def attention(q, k, v, causal: bool = True, window: int | None = None,
              scale: float | None = None):
    """Causal GQA attention (prefill), optional sliding window.
    (B,Hq,S,D) x (B,Hkv,S,D) -> (B,Hq,S,D) in q's dtype; differentiable
    on every device."""
    if _on_host(q):
        return ref.attention(q, k, v, causal=causal, window=window,
                             scale=scale)
    return FlashAttention.apply(q, k, v, causal, window, scale)


def decode_attention(q, k, v, length, scale: float | None = None,
                     with_lse: bool = False):
    """One-token GQA attention against a KV cache, each batch row masked
    to its first ``length[b]`` slots. (B,Hq,D) -> (B,Hq,D); ``with_lse``
    also gives each row's (B,Hq) float32 log-sum-exp: ``(out, lse)``."""
    fn = ref.decode_attention if _on_host(q) else _dec.decode_attention
    return fn(q, k, v, length, scale=scale, with_lse=with_lse)


class SSDScan(torch.autograd.Function):
    """The SSD kernels with their backward kernel: saves x, dt, A, Bm and
    Cm (the backward recomputes the states from them) and returns dx,
    ddt, dA, dB, dC from ``ssd_bwd``."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        return _ssd.ssd(x, dt, A, Bm, Cm, chunk=chunk)

    @staticmethod
    def backward(ctx, dy):
        return (*_ssd.ssd_bwd(*ctx.saved_tensors, dy), None)


def ssd(x, dt, A, Bm, Cm, chunk: int = 128):
    """Mamba-2 SSD over a sequence. (B,S,H,P) -> (B,S,H,P) in x's dtype;
    differentiable on every device."""
    if _on_host(x):
        return ref.ssd(x, dt, A, Bm, Cm)
    return SSDScan.apply(x, dt, A, Bm, Cm, chunk)


def ssd_decode_step(h, x, dt, A, Bm, Cm):
    """O(1)-state single-token SSD update, on every device (no kernel:
    a rank-1 update). Returns (h', y)."""
    return ref.ssd_decode_step(h, x, dt, A, Bm, Cm)


def kde_success_prob(lat, mask, tau, bandwidth):
    """Batched windowed KDE P(l <= tau) with given bandwidths.
    (rows,R) -> (rows,)."""
    fn = ref.kde_success_prob if _on_host(lat) else _kde.kde_success_prob
    return fn(lat, mask, tau, bandwidth)
