"""Plain PyTorch versions of the port's CUDA kernels.

Port of the oracles in ``repro/kernels/ref.py`` for the kernels the
port has: the simulator's maintenance statistics and fused round, the
KDE success probability, prefill and decode attention, and the Mamba-2
SSD scan (with its single-token update, which has no kernel). They are
what the CPU runs for the
kernels (``kernels/ops.py`` sends a CPU tensor here), and what
``chip_smoke.py`` holds each CUDA kernel against on the card. On the
card nothing on the main path calls them.

Kept self-contained (no ``repro_torch.core`` imports) for the reason
the reference gives: ``core -> kernels -> core`` would cycle.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

_INV_SQRT2 = 0.7071067811865476
_F32_MAX = torch.finfo(torch.float32).max
_NEG = -1e30


# ---------------------------------------------------------------------------
# Attention (kernels/flash_attention.py::flash_attention and
# kernels/decode_attention.py::decode_attention). Both compute in
# float32 (q scaled by ``scale`` before the product, masked logits set
# to -1e30, softmax) and cast the result to q's dtype.
# ---------------------------------------------------------------------------

def attention(
    q: torch.Tensor,            # (B, Hq, S, D)
    k: torch.Tensor,            # (B, Hkv, S, D)
    v: torch.Tensor,            # (B, Hkv, S, D)
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Causal GQA attention with an optional sliding window; query head
    ``h`` reads kv head ``h // (Hq / Hkv)``. (B, Hq, S, D) in q's dtype."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qg = (q.float() * scale).reshape(B, Hkv, G, S, D)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float())
    idx = torch.arange(S, device=q.device)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device)
    if causal:
        mask &= idx[:, None] >= idx[None, :]
    if window is not None:
        mask &= idx[:, None] - idx[None, :] < window
    p = torch.softmax(torch.where(mask, logits, _NEG), dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return out.reshape(B, Hq, S, D).to(q.dtype)


def decode_attention(
    q: torch.Tensor,            # (B, Hq, D)
    k: torch.Tensor,            # (B, Hkv, S, D) cache
    v: torch.Tensor,            # (B, Hkv, S, D)
    length: torch.Tensor,       # (B,) valid cache entries
    scale: float | None = None,
) -> torch.Tensor:
    """One query token per head against the first ``length[b]`` cache
    slots of batch row b. (B, Hq, D) in q's dtype; a row with length 0
    gets a uniform average over its S slots, as the reference's softmax
    over all-masked logits does (the kernel returns zeros there)."""
    B, Hq, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qf = (q.float() * scale).reshape(B, Hkv, G, D)
    logits = torch.einsum("bhgd,bhkd->bhgk", qf, k.float())
    valid = torch.arange(S, device=q.device)[None, :] < length[:, None]
    p = torch.softmax(torch.where(valid[:, None, None, :], logits, _NEG),
                      dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", p, v.float())
    return out.reshape(B, Hq, D).to(q.dtype)


# ---------------------------------------------------------------------------
# Mamba-2 SSD (kernels/ssd.py::ssd): the exact sequential recurrence, the
# semantic definition the chunked kernel is held to. ngroups=1: B and C
# are shared across heads.
# ---------------------------------------------------------------------------

def ssd(
    x: torch.Tensor,            # (B, S, H, P) inputs per head
    dt: torch.Tensor,           # (B, S, H) softplus'd step sizes (> 0)
    A: torch.Tensor,            # (H,) negative state decay rates
    Bm: torch.Tensor,           # (B, S, N) input projections
    Cm: torch.Tensor,           # (B, S, N) output projections
) -> torch.Tensor:
    """``h_t = exp(A dt_t) h_{t-1} + dt_t B_t x_t^T``, ``y_t = C_t^T h_t``
    in float32, the state (H, N, P) per batch row starting at zero.
    Returns (B, S, H, P) in x's dtype. A loop over S: slow on the card,
    it is only the plain version."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bf, Cf = Bm.float(), Cm.float()
    h = torch.zeros(Bsz, H, N, P, dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(Af * dtf[:, t])                     # (B, H)
        h = h * decay[..., None, None] + (
            dtf[:, t, :, None, None] * Bf[:, t, None, :, None]
            * xf[:, t, :, None, :])
        ys.append(torch.einsum("bn,bhnp->bhp", Cf[:, t], h))
    return torch.stack(ys, dim=1).to(x.dtype)


def ssd_decode_step(
    h: torch.Tensor,            # (B, H, N, P) carried state
    x: torch.Tensor,            # (B, H, P) current token input
    dt: torch.Tensor,           # (B, H)
    A: torch.Tensor,            # (H,)
    Bm: torch.Tensor,           # (B, N)
    Cm: torch.Tensor,           # (B, N)
):
    """Single-token SSD update (serving decode): a rank-1 update of the
    state, no kernel. Returns (h' (B, H, N, P), y (B, H, P) in x's
    dtype)."""
    decay = torch.exp(A[None, :] * dt)                        # (B, H)
    h = h * decay[..., None, None] + (
        dt[..., None, None] * Bm[:, None, :, None] * x[:, :, None, :])
    y = torch.einsum("bn,bhnp->bhp", Cm, h)
    return h, y.to(x.dtype)


# ---------------------------------------------------------------------------
# KDE success probability (kernels/kde.py::kde_success_prob): the middle
# stage of the fused maintenance, with the bandwidths given.
# ---------------------------------------------------------------------------

def kde_success_prob(
    lat: torch.Tensor,          # (rows, R) latency windows
    mask: torch.Tensor,         # (rows, R) validity
    tau: float,
    bandwidth: torch.Tensor,    # (rows,)
) -> torch.Tensor:
    """Masked mean Gaussian CDF at tau per row, 0 for an empty row."""
    m = mask.to(torch.float32)
    n = m.sum(-1)
    z = (tau - lat.to(torch.float32)) / bandwidth[:, None]
    cdf = 0.5 * (1.0 + torch.erf(z * _INV_SQRT2))
    s = (cdf * m).sum(-1)
    return torch.where(n > 0, s / torch.clamp_min(n, 1.0), 0.0)


# ---------------------------------------------------------------------------
# Fused Alg-1 maintenance statistics (kernels/kde.py::fused_maintenance).
# ---------------------------------------------------------------------------

def bandit_maintenance_stats(
    lat: torch.Tensor,          # (rows, R) latency windows
    mask: torch.Tensor,         # (rows, R) validity (bool)
    rtt: torch.Tensor,          # (rows,) network RTT per row
    tau: float,
    rho: float,
    min_bandwidth: float = 1e-4,
):
    """Silverman bandwidth -> Gaussian-CDF success probability at tau,
    plus the masked rho-quantile of the processing component
    ``max(lat - rtt, 0)``; returns ``(mu (rows,), q (rows,))``.

    The quantile sorts with ``torch.sort`` (the reference's bitonic
    network only works around XLA:CPU's scalar sort). Its index
    ``int(rho * (n - 1))`` is taken in float32, as the reference and
    the kernel take it, so ``q`` selects the same sample bit for bit.
    """
    latf = lat.to(torch.float32)
    m = mask.to(torch.float32)

    nc = torch.clamp_min(m.sum(-1), 1.0)
    mean = (latf * m).sum(-1) / nc
    d = latf - mean[..., None]
    var = (d * d * m).sum(-1) / nc
    sigma = torch.sqrt(torch.clamp_min(var, 0.0))
    h = torch.clamp_min(1.06 * sigma * nc ** (-0.2), min_bandwidth)

    n = m.sum(-1)
    z = (tau - latf) / h[..., None]
    cdf = 0.5 * (1.0 + torch.erf(z * _INV_SQRT2))
    contrib = (cdf * m).sum(-1)
    mu = torch.where(n > 0, contrib / torch.clamp_min(n, 1.0), 0.0)

    proc = torch.clamp_min(latf - rtt[..., None], 0.0)
    xs = torch.sort(torch.where(mask, proc, _F32_MAX), dim=-1)[0]
    R = lat.shape[-1]
    idx = torch.clamp((rho * (n - 1.0)).to(torch.int64), 0, R - 1)
    val = torch.gather(xs, -1, idx[..., None])[..., 0]
    q = torch.where(n > 0, val, _F32_MAX)
    return mu, q


# ---------------------------------------------------------------------------
# Fused simulator round (kernels/round_fused.py::round_step_swrr).
#
# One call covers all C request rounds of one step: SWRR selection, the
# shared (M,)-queue recursion, the per-round feedback control and the
# deferred ring scatter, op for op as the reference oracle. Two row
# sums differ from it on purpose: the SWRR total and the renormalising
# ``wsum`` add the M columns left to right (``_row_sum``), the order
# the CUDA kernel adds them in, so kernel and plain version agree bit
# for bit on the card. XLA reduces a row in its own order; the two
# orders differ by at most a few float32 ULP of a weight row's sum.
# The latency is one fused multiply-add, as XLA:CPU compiles it.
# ---------------------------------------------------------------------------


class RoundStepOut(NamedTuple):
    """Everything one fused round produces: the updated bandit tensors,
    the shared queue, and the per-request outputs the metric
    accumulator consumes."""
    weights: torch.Tensor          # (K, M)
    cw: torch.Tensor               # (K, M)
    err: torch.Tensor              # (K, M) i32
    cooldown_until: torch.Tensor   # (K, M)
    in_pool: torch.Tensor          # (K, M) bool
    lat_buf: torch.Tensor          # (K, M, R)
    ts_buf: torch.Tensor           # (K, M, R)
    ptr: torch.Tensor              # (K, M) i32
    r_buf: torch.Tensor            # (K, Rq)
    rts_buf: torch.Tensor          # (K, Rq)
    rptr: torch.Tensor             # (K,) i32
    q: torch.Tensor                # (M,) queue after all C rounds
    arrivals: torch.Tensor         # (M,) requests per instance this step
    choices: torch.Tensor          # (K, C) i32
    lats: torch.Tensor             # (K, C)
    procs: torch.Tensor            # (K, C)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once (``core.fmath.fma``, kept local for the
    import-cycle reason above): the float32 product is exact in
    float64, and for the latency's operands (within a factor 32 of each
    other) so is the float64 sum, which leaves one rounding."""
    return (a.double() * b.double() + c.double()).float()


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """(K, M) -> (K, 1): columns added left to right."""
    s = x[:, 0]
    for m in range(1, x.shape[1]):
        s = s + x[:, m]
    return s[:, None]


def _ring_scatter(lat_buf, ts_buf, ptr, r_buf, rts_buf, rptr,
                  choices, lats, t, mask, tau):
    """``core.bandit.record_rings_batch`` mirrored op for op. Writes the
    reference drops with ``mode="drop"`` are filtered out instead."""
    K, M, R = lat_buf.shape
    C = choices.shape[1]
    Rq = r_buf.shape[1]
    ch = choices.to(torch.int64)
    kk = torch.arange(K, device=ch.device)[:, None].expand(K, C)
    t_arr = t.expand(K, C)
    reward = (lats <= tau).to(torch.float32)
    maski = mask.to(torch.int64)

    onehot = ((ch[..., None] == torch.arange(M, device=ch.device))
              & mask[..., None]).to(torch.int64)
    cnt = torch.cumsum(onehot, dim=1)
    total = cnt[:, -1, :]
    rank = torch.gather(cnt - onehot, 2, ch[..., None])[..., 0]
    p0 = torch.gather(ptr.to(torch.int64), 1, ch)
    slot = (p0 + rank) % R
    tot_c = torch.gather(total, 1, ch)
    keep = mask & (rank >= tot_c - R)
    idx = (kk[keep], ch[keep], slot[keep])
    lat_buf = lat_buf.index_put(idx, lats[keep])
    ts_buf = ts_buf.index_put(idx, t_arr[keep])
    ptr = ((ptr + total) % R).to(torch.int32)

    crank = torch.cumsum(maski, dim=1) - maski
    totk = maski.sum(1)
    rslot = (rptr.to(torch.int64)[:, None] + crank) % Rq
    keep_r = mask & (crank >= totk[:, None] - Rq)
    ridx = (kk[keep_r], rslot[keep_r])
    r_buf = r_buf.index_put(ridx, reward[keep_r])
    rts_buf = rts_buf.index_put(ridx, t_arr[keep_r])
    rptr = ((rptr + totk) % Rq).to(torch.int32)
    return lat_buf, ts_buf, ptr, r_buf, rts_buf, rptr


def round_step_swrr(
    weights, cw, err, cooldown_until, in_pool, active,
    lat_buf, ts_buf, ptr, r_buf, rts_buf, rptr,
    q, nc, z, rtt_t, s_m, served_per_round, t,
    tau: float, err_thresh: int, cooldown: float,
) -> RoundStepOut:
    """All C SWRR rounds of one step (plain PyTorch); same arguments,
    shapes and dtypes as ``repro.kernels.ref.round_step_swrr``. The
    inputs are left untouched; every output is a new tensor."""
    K, M, R = lat_buf.shape
    C = z.shape[0]
    dev = weights.device
    kidx = torch.arange(K, device=dev)
    t = torch.as_tensor(t, dtype=torch.float32, device=dev)
    w, cw_c, err_c, cd, pool, qc = weights, cw, err, cooldown_until, in_pool, q
    ch_r, lat_r, proc_r = [], [], []
    arrivals = torch.zeros(M, dtype=torch.float32, device=dev)
    for r in range(C):
        mask = r < nc
        # --- core.swrr.swrr_select ---
        total = _row_sum(w)
        cw_c = cw_c + w
        choice = torch.argmax(cw_c, dim=-1)
        onehot = torch.nn.functional.one_hot(choice, M).to(torch.bool)
        cw_c = cw_c - onehot.to(torch.float32) * total
        # --- latency (simulator round_body); the reference's compiler
        # fuses rtt + (q+1)s * z into one FMA, so the sum rounds once ---
        q1s = (qc[choice] + 1.0) * s_m[choice]
        proc = q1s * z[r]
        lat = _fma(q1s, z[r], rtt_t[kidx, choice])
        # --- core.bandit._record_control ---
        reward = (lat <= tau).to(torch.float32)
        old_err = err_c[kidx, choice]
        new_err = torch.where(reward > 0, 0, old_err + 1).to(torch.int32)
        trip = mask & (new_err >= err_thresh)
        err_c = err_c.index_put(
            (kidx, choice),
            torch.where(mask, torch.where(trip, 0, new_err), old_err)
            .to(torch.int32))
        cd = cd.index_put(
            (kidx, choice), torch.where(trip, t + cooldown, cd[kidx, choice]))
        tripped = onehot & trip[:, None]
        pool = pool & ~tripped
        w2 = torch.where(tripped, 0.0, w)
        wsum = _row_sum(w2)
        remaining = pool & active[None, :]
        rem_any = remaining.any(-1, keepdim=True)
        fallback = torch.where(rem_any, remaining,
                               active[None, :] & ~tripped).to(torch.float32)
        fallback = fallback / torch.clamp_min(
            fallback.sum(-1, keepdim=True), 1.0)
        w = torch.where(wsum > 0, w2 / torch.clamp_min(wsum, 1e-30), fallback)
        cw_c = torch.where(tripped, 0.0, cw_c)
        # --- shared-queue recursion ---
        arr_r = torch.zeros(M, dtype=torch.float32, device=dev).index_add_(
            0, choice, mask.to(torch.float32))
        qc = torch.clamp_min(qc + arr_r - served_per_round, 0.0)
        arrivals = arrivals + arr_r          # integer-valued: order-free
        ch_r.append(choice)
        lat_r.append(lat)
        proc_r.append(proc)

    choices = torch.stack(ch_r, dim=1).to(torch.int32)
    lats = torch.stack(lat_r, dim=1)
    procs = torch.stack(proc_r, dim=1)
    mask_kc = torch.arange(C, device=dev)[None, :] < nc[:, None]
    lat_buf, ts_buf, ptr, r_buf, rts_buf, rptr = _ring_scatter(
        lat_buf, ts_buf, ptr, r_buf, rts_buf, rptr,
        choices, lats, t, mask_kc, tau)
    return RoundStepOut(w, cw_c, err_c, cd, pool,
                        lat_buf, ts_buf, ptr, r_buf, rts_buf, rptr,
                        qc, arrivals, choices, lats, procs)
