"""Plain PyTorch versions of the port's CUDA kernels.

Port of the oracles in ``repro/kernels/ref.py`` for the kernels the
port has: the simulator's maintenance statistics and fused round, the
KDE success probability, prefill and decode attention, and the Mamba-2
SSD scan. They are what the CPU runs for the kernels
(``kernels/ops.py`` sends a CPU tensor here), and what
``chip_smoke.py`` holds each CUDA kernel against on the card. Two have
no kernel and run here on every device: the SSD single-token update
and the proxy-mity round (``round_step_gumbel``). ``attention_grads``
and ``ssd_grads`` are the plain versions of the attention and SSD
backwards, kernels of the port alone (the reference differentiates its
plain attention and scan).

Kept free of module-level ``repro_torch.core`` imports for the reason
the reference gives: ``core -> kernels -> core`` would cycle.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
from typing import NamedTuple

import numpy as np
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


def attention_grads(q, k, v, do, causal: bool = True,
                    window: int | None = None, scale: float | None = None):
    """The plain version of ``flash_attention_bwd``: ``(dq, dk, dv)`` of
    ``attention(q, k, v, causal, window, scale)`` against the output
    gradient ``do``, by ``torch.autograd.grad`` through ``attention`` on
    float32 copies of the inputs; float32 gradients whatever the inputs'
    dtype. The tests and ``chip_smoke.py`` hold the kernel to it; no
    training path runs it on the card."""
    with torch.enable_grad():
        qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
        out = attention(qf, kf, vf, causal=causal, window=window,
                        scale=scale)
        return torch.autograd.grad(out, (qf, kf, vf), do.float())


def decode_attention(
    q: torch.Tensor,            # (B, Hq, D)
    k: torch.Tensor,            # (B, Hkv, S, D) cache
    v: torch.Tensor,            # (B, Hkv, S, D)
    length: torch.Tensor,       # (B,) valid cache entries
    scale: float | None = None,
    with_lse: bool = False,
):
    """One query token per head against the first ``length[b]`` cache
    slots of batch row b. (B, Hq, D) in q's dtype; a row with length 0
    is zeros, as the TPU kernel and the CUDA kernel give (a softmax over
    all-masked logits would average V). ``with_lse``: also the (B, Hq)
    float32 log-sum-exp of the row's scaled logits over its live slots
    (-inf at length 0), returned as ``(out, lse)``."""
    B, Hq, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qf = (q.float() * scale).reshape(B, Hkv, G, D)
    logits = torch.einsum("bhgd,bhkd->bhgk", qf, k.float())
    valid = torch.arange(S, device=q.device)[None, :] < length[:, None]
    masked = torch.where(valid[:, None, None, :], logits, _NEG)
    p = torch.softmax(masked, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", p, v.float())
    live = (length > 0)[:, None, None, None]
    out = torch.where(live, out, 0.0).reshape(B, Hq, D).to(q.dtype)
    if not with_lse:
        return out
    lse = torch.where(live[..., 0], torch.logsumexp(masked, dim=-1),
                      float("-inf")).reshape(B, Hq)
    return out, lse


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
    in float32 (float64 inputs stay float64), the state (H, N, P) per
    batch row starting at zero. Returns (B, S, H, P) in x's dtype. A loop
    over S: slow on the card, it is only the plain version."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    wide = torch.promote_types(x.dtype, torch.float32)
    xf, dtf, Af, Bf, Cf = (t.to(wide) for t in (x, dt, A, Bm, Cm))
    h = torch.zeros(Bsz, H, N, P, dtype=wide, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(Af * dtf[:, t])                     # (B, H)
        h = h * decay[..., None, None] + (
            dtf[:, t, :, None, None] * Bf[:, t, None, :, None]
            * xf[:, t, :, None, :])
        ys.append(torch.einsum("bn,bhnp->bhp", Cf[:, t], h))
    return torch.stack(ys, dim=1).to(x.dtype)


def ssd_grads(x, dt, A, Bm, Cm, dy):
    """The plain version of ``ssd_bwd``: ``(dx, ddt, dA, dB, dC)`` of
    ``ssd(x, dt, A, Bm, Cm)`` against the output gradient ``dy``, by
    ``torch.autograd.grad`` through ``ssd`` on float32 copies of the
    inputs; float32 gradients whatever x's dtype (float64 inputs stay
    float64). The tests and ``chip_smoke.py`` hold the kernel to it; no
    training path runs it on the card."""
    wide = torch.promote_types(x.dtype, torch.float32)
    with torch.enable_grad():
        leaves = [t.detach().to(wide).requires_grad_()
                  for t in (x, dt, A, Bm, Cm)]
        y = ssd(*leaves)
        return torch.autograd.grad(y, leaves, dy.to(wide))


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
    """Masked mean Gaussian CDF at tau per row, 0 for an empty row
    (``erf`` and the row sums as ``bandit_maintenance_stats`` takes
    them)."""
    from repro_torch.core import fmath      # see the top: import cycle
    m = mask.to(torch.float32)
    n = m.sum(-1)
    z = (tau - lat.to(torch.float32)) / bandwidth[:, None]
    cdf = 0.5 * (1.0 + fmath.erf(z * _INV_SQRT2))
    s = _xla_kde_sum(cdf * m)
    return torch.where(n > 0, s / torch.clamp_min(n, 1.0), 0.0)


# ---------------------------------------------------------------------------
# Fused Alg-1 maintenance statistics (kernels/kde.py::fused_maintenance).
#
# Rounded as XLA:CPU rounds the reference, so that ``mu`` and ``q`` are
# its bits on the CPU: the row sums in XLA's order (``_xla_row_sum``,
# ``_xla_kde_sum``),
# ``n ** -0.2`` as glibc's ``powf`` (``_pow_neg_fifth``), the square
# root correctly rounded and ``erf`` as ``core.fmath.erf``. Each is
# elementwise or row-local, so a row's statistics do not depend on the
# rows around it (lanes, subsets).
# ---------------------------------------------------------------------------

def _blocks(x: torch.Tensor, centered: bool = False) -> torch.Tensor:
    """(..., R) as (..., ceil(R/32), min(R, 32)): blocks of 32 columns,
    the last padded with zeros (a sum plus +0.0 is the sum); ``centered``:
    the padding split between the two ends, the smaller half first."""
    R = x.shape[-1]
    if R <= 32:
        return x[..., None, :]
    pad = (-R) % 32
    lo = pad // 2 if centered else 0
    x = torch.nn.functional.pad(x, (lo, pad - lo))
    return x.reshape(*x.shape[:-1], -1, 32)


def _xla_row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in XLA:CPU's order for a float32 row: a
    row of at most 32 left to right; a longer one as XLA's reduce-window
    rewrite cuts it, windows of 32 over the row padded with zeros at both
    ends (``(-R) % 32`` of them, the smaller half first), each window
    added left to right, then the window sums in order."""
    cols = _blocks(x, centered=True).unbind(-1)
    acc = cols[0]
    for c in cols[1:]:                   # every block at once, in order
        acc = acc + c
    parts = acc.unbind(-1)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def _halve(acc: torch.Tensor) -> torch.Tensor:
    """A vector's lanes summed as LLVM reduces them: the upper half
    onto the lower, until one lane is left."""
    while acc.shape[-1] > 1:
        h = acc.shape[-1] // 2
        acc = acc[..., :h] + acc[..., h:]
    return acc[..., 0]


def _vec4x4_sum(x: torch.Tensor) -> torch.Tensor:
    """The row sum of LLVM's loop vectorised by 4 lanes and interleaved
    by 4 (XLA:CPU's KDE sum at R = 20..23): the first 16 columns as four
    4-lane accumulators (columns 4k..4k+3), added last first onto the
    first (``a3 + (a2 + (a1 + a0))``) and halved; then the next 4
    columns in a 4-lane epilogue whose lane 0 carries that sum, halved;
    then the columns past them left to right."""
    acc = [x[..., 4 * k:4 * k + 4] for k in range(4)]
    r = acc[0]
    for a in acc[1:]:
        r = a + r
    total = _halve(r)
    tail = x[..., 16:20].clone()
    tail[..., 0] = total + tail[..., 0]
    total = _halve(tail)
    for c in x[..., 20:].unbind(-1):
        total = total + c
    return total


def _xla_kde_sum(x: torch.Tensor) -> torch.Tensor:
    """The KDE's sum of a row's masked CDFs in XLA:CPU's order inside
    the maintenance program. A row of more than 32 or at most 10 takes
    ``_xla_row_sum``'s order. Between, the loop is vectorised by eight:
    eight accumulators, column j into ``j % 8``, then halved three times
    (``a[:4] + a[4:]``, ...). At R = 11..16 the tail rides in the
    vector, padded with zeros (a sum plus +0.0 is the sum); at R =
    17..19 and 24..32 the whole eights are vectorised and the rest added
    left to right after them. At R = 20..23 LLVM vectorises by four with
    four accumulators (``_vec4x4_sum``). These are the loops of XLA's
    optimised LLVM IR (``--xla_dump_to``) at each R; the maintenance's
    ``mu`` equals the reference's bits at every R checked, 1..64 and
    past it."""
    R = x.shape[-1]
    if 20 <= R <= 23:
        return _vec4x4_sum(x)
    if R <= 10 or R > 32:
        return _xla_row_sum(x)
    if R <= 16:
        x, rest = torch.nn.functional.pad(x, (0, 16 - R)), ()
    else:
        cut = R - R % 8
        x, rest = x[..., :cut], x[..., cut:].unbind(-1)
    cols = x.split(8, -1)
    acc = cols[0]
    for c in cols[1:]:
        acc = acc + c
    while acc.shape[-1] > 1:             # 8 -> 4 -> 2 -> 1
        h = acc.shape[-1] // 2
        acc = acc[..., :h] + acc[..., h:]
    total = acc[..., 0]
    for c in rest:
        total = total + c
    return total


def _xla_row_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(a * b).sum(-1)`` as XLA:CPU fuses it: in ``_xla_row_sum``'s
    blocks, each an FMA chain ``acc = fma(a_j, b_j, acc)`` (a float32
    product is exact in float64, so one rounding to float64 and one to
    float32 replay the FMA: the add runs in float64 and stores into the
    float32 ``acc``, one launch a column), then the block sums in
    order."""
    prods = (_blocks(a).double() * _blocks(b)).unbind(-1)
    acc = prods[0].float()
    for p in prods[1:]:
        torch.add(p, acc, out=acc)
    parts = acc.unbind(-1)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


@functools.cache
def _powf_table(R: int) -> np.ndarray:
    """(R + 1,) float32: glibc's ``powf(n, -0.2)`` for n = 0..R, the
    reference compiler's float32 pow, built once on the host."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.powf.restype = ctypes.c_float
    libm.powf.argtypes = (ctypes.c_float, ctypes.c_float)
    return np.array([libm.powf(float(n), -0.2) for n in range(R + 1)],
                    np.float32)


@functools.cache
def _powf_on(R: int, device) -> torch.Tensor:
    return torch.from_numpy(_powf_table(R)).to(device)


def _pow_neg_fifth(nc: torch.Tensor, R: int) -> torch.Tensor:
    """``nc ** -0.2`` for whole numbers ``nc`` in [1, R], by table."""
    return _powf_on(R, nc.device)[nc.to(torch.int64)]


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
    from repro_torch.core import fmath      # see the top: import cycle
    latf = lat.to(torch.float32)
    m = mask.to(torch.float32)
    R = lat.shape[-1]

    n = m.sum(-1)                            # whole numbers: order-free
    nc = torch.clamp_min(n, 1.0)
    mean = _xla_row_sum(latf * m) / nc
    d = latf - mean[..., None]
    var = _xla_row_sum(d * d * m) / nc
    sigma = fmath.sqrt(torch.clamp_min(var, 0.0))
    h = torch.clamp_min(1.06 * sigma * _pow_neg_fifth(nc, R), min_bandwidth)

    z = (tau - latf) / h[..., None]
    cdf = 0.5 * (1.0 + fmath.erf(z * _INV_SQRT2))
    contrib = _xla_kde_sum(cdf * m)
    mu = torch.where(n > 0, contrib / torch.clamp_min(n, 1.0), 0.0)

    proc = torch.clamp_min(latf - rtt[..., None], 0.0)
    xs = torch.sort(torch.where(mask, proc, _F32_MAX), dim=-1)[0]
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
#
# Lanes. A call may carry S independent simulations ("lanes", the
# reference's vmapped grid axis) side by side: the players are S·K rows
# and lane s owns rows [s·K, (s+1)·K); the per-instance rows ``q``,
# ``active``, ``s_m`` and ``served_per_round`` are (S, M), one row a
# lane, and so are the outputs ``q`` and ``arrivals``. A 1-D (M,) row
# is one lane, the reference's own layout. Every lane computes exactly
# what it computes alone.
# ---------------------------------------------------------------------------


def cooldown_deadline(t, cooldown: float, cooldown_at=None) -> float:
    """A tripped arm's cooldown deadline as a host float32 value: the
    caller's ``cooldown_at``, else ``t + cooldown`` rounded once (``t``
    a host number or a 0-dim tensor)."""
    if cooldown_at is not None:
        return float(np.float32(cooldown_at))
    if isinstance(t, torch.Tensor):
        t = t.item()
    return float(np.float32(t) + np.float32(cooldown))


class RoundStepOut(NamedTuple):
    """Everything one fused round produces: the updated bandit tensors,
    the shared queue, and the per-request outputs the metric
    accumulator consumes. With S lanes, K counts the players of all of
    them and ``q``/``arrivals`` are (S, M)."""
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
    q: torch.Tensor                # (M,) or (S, M): queue after all C rounds
    arrivals: torch.Tensor         # (M,) or (S, M): requests this step
    choices: torch.Tensor          # (K, C) i32
    lats: torch.Tensor             # (K, C)
    procs: torch.Tensor            # (K, C)


def lane_rows(x: torch.Tensor, players: int) -> torch.Tensor:
    """A per-lane row as rows against the (players, M) player axis: an
    (M,) row (one lane) as (1, M), an (S, M) tensor as (players, M),
    row s repeated for lane s's players/S players."""
    if x.dim() == 1:
        return x[None, :]
    return x.repeat_interleave(players // x.shape[0], dim=0)


def lane_of(players: int, lanes: int, device) -> torch.Tensor:
    """(players,) int64: the lane each player row belongs to."""
    return torch.div(torch.arange(players, device=device), players // lanes,
                     rounding_mode="floor")


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once (``core.fmath.fma``, kept local for the
    import-cycle reason above): the float32 product is exact in
    float64, and for the latency's operands (within a factor 32 of each
    other) so is the float64 sum, which leaves one rounding."""
    return (a.double() * b.double() + c.double()).float()


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """(K, M) -> (K, 1): columns added left to right."""
    cols = x.unbind(1)
    s = cols[0]
    for c in cols[1:]:
        s = s + c
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


def _lanes(q, s_m, served_per_round):
    """The per-lane rows as (S, M), and whether the caller gave lanes."""
    lanes = q.dim() == 2
    S, M = (q.shape if lanes else (1, q.shape[0]))
    return (lanes, S, q.reshape(S, M), s_m.reshape(S, M),
            served_per_round.reshape(S, M))


def round_step_swrr(
    weights, cw, err, cooldown_until, in_pool, active,
    lat_buf, ts_buf, ptr, r_buf, rts_buf, rptr,
    q, nc, z, rtt_t, s_m, served_per_round, t,
    tau: float, err_thresh: int, cooldown: float, cooldown_at=None,
) -> RoundStepOut:
    """All C SWRR rounds of one step (plain PyTorch); the arguments,
    shapes and dtypes of ``repro.kernels.ref.round_step_swrr``, with the
    lane axis above. The inputs are left untouched; every output is a
    new tensor. ``cooldown_at`` (a host number) is a tripped arm's
    deadline, by default ``t + cooldown`` rounded to float32 once."""
    K, M, R = lat_buf.shape
    C = z.shape[0]
    dev = weights.device
    lanes, S, qc, s2, srv2 = _lanes(q, s_m, served_per_round)
    lane = lane_of(K, S, dev)
    act = lane_rows(active, K)
    kidx = torch.arange(K, device=dev)
    t_cd = torch.as_tensor(cooldown_deadline(t, cooldown, cooldown_at),
                           dtype=torch.float32, device=dev)
    t = torch.as_tensor(t, dtype=torch.float32, device=dev)
    w, cw_c, err_c, cd, pool = weights, cw, err, cooldown_until, in_pool
    ch_r, lat_r, proc_r = [], [], []
    arrivals = torch.zeros(S, M, dtype=torch.float32, device=dev)
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
        q1s = (qc[lane, choice] + 1.0) * s2[lane, choice]
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
            (kidx, choice), torch.where(trip, t_cd, cd[kidx, choice]))
        tripped = onehot & trip[:, None]
        pool = pool & ~tripped
        w2 = torch.where(tripped, 0.0, w)
        wsum = _row_sum(w2)
        remaining = pool & act
        rem_any = remaining.any(-1, keepdim=True)
        fallback = torch.where(rem_any, remaining,
                               act & ~tripped).to(torch.float32)
        fallback = fallback / torch.clamp_min(
            fallback.sum(-1, keepdim=True), 1.0)
        w = torch.where(wsum > 0, w2 / torch.clamp_min(wsum, 1e-30), fallback)
        cw_c = torch.where(tripped, 0.0, cw_c)
        # --- shared-queue recursion, each lane on its own row ---
        arr_r = torch.zeros(S * M, dtype=torch.float32, device=dev).index_add_(
            0, lane * M + choice, mask.to(torch.float32)).reshape(S, M)
        qc = torch.clamp_min(qc + arr_r - srv2, 0.0)
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
    if not lanes:
        qc, arrivals = qc[0], arrivals[0]
    return RoundStepOut(w, cw_c, err_c, cd, pool,
                        lat_buf, ts_buf, ptr, r_buf, rts_buf, rptr,
                        qc, arrivals, choices, lats, procs)


def round_step_gumbel(weights, q, nc, z, gum, rtt_t, s_m, served_per_round):
    """All C Gumbel-categorical rounds of one step (plain PyTorch, on
    every device; ``repro.kernels.ref.round_step_gumbel``), with the
    lane axis of ``round_step_swrr``.

    Stateless strategies (proxy-mity) pick arms from fixed weights, so
    every round's argmax happens at once and only the queue recursion
    runs round by round. ``gum`` is (C, K, M), ``z`` (C, K). Returns
    ``(q, arrivals, choices (K, C) i32, lats, procs)``."""
    # imported here: ``core`` imports this module (see the top)
    from repro_torch.core import fmath
    C, K, M = gum.shape
    dev = weights.device
    lanes, S, q, s2, srv2 = _lanes(q, s_m, served_per_round)
    lane = lane_of(K, S, dev)
    logits = fmath.log(weights + 1e-30)
    choices = torch.argmax(logits[None] + gum, dim=-1)           # (C, K)
    mask = torch.arange(C, device=dev)[:, None] < nc[None, :]
    rows = (torch.arange(C, device=dev)[:, None] * S + lane) * M + choices
    arr = torch.zeros(C * S * M, dtype=torch.float32, device=dev).index_add_(
        0, rows.reshape(-1), mask.to(torch.float32).reshape(-1)
    ).reshape(C, S, M)
    q_seen = []
    for r in range(C):
        q_seen.append(q[lane, choices[r]])
        q = torch.clamp_min(q + arr[r] - srv2, 0.0)
    q1s = (torch.stack(q_seen) + 1.0) * s2[lane, choices]
    procs = q1s * z
    # rtt + (q+1)s * z rounds once, as in round_step_swrr
    lats = _fma(q1s, z, rtt_t[torch.arange(K, device=dev)[None, :], choices])
    arrivals = arr.sum(0)                    # integer-valued: order-free
    if not lanes:
        q, arrivals = q[0], arrivals[0]
    return (q, arrivals, choices.T.to(torch.int32).contiguous(),
            lats.T.contiguous(), procs.T.contiguous())
