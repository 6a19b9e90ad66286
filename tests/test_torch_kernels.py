"""The port's kernels on the CPU: their plain PyTorch versions against the
JAX package's oracles and its Pallas kernel bodies (``interpret=True``),
and the device dispatch in ``repro_torch.kernels.ops``.

The CUDA kernels themselves run only on the card (``chip_smoke.py``
holds each against the plain version there); here the plain versions
carry their arithmetic. Selections and counters must match exactly:
the maintenance quantile ``q``, the round step's choices, error
counters, ring pointers, pool bits and queue. Other floats match to
``rtol=1e-5``: XLA sums a row in its own order (the plain round step
adds the M columns left to right, as the CUDA kernel does) and
contracts ``a * b + c`` into FMAs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import kde as jkde_kernel
from repro.kernels import ref as jref
from repro.kernels import round_fused as jround
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import kde as tkde_kernel
from repro_torch.kernels import round_fused as tround

EXACT = ("err", "in_pool", "ptr", "rptr", "q", "arrivals", "choices")
RTOL, ATOL = 1e-5, 1e-7


def T(x) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(x), copy=True))


def maint_inputs(rows: int, R: int, seed: int):
    rng = np.random.default_rng(seed)
    lat = rng.uniform(0.005, 0.15, (rows, R)).astype(np.float32)
    lat[rng.uniform(size=(rows, R)) < 0.3] = np.float32(0.05)      # ties
    mask = rng.uniform(size=(rows, R)) < rng.uniform(size=(rows, 1))
    mask[0::5], mask[1::5] = False, True                          # empty, full
    rtt = rng.uniform(0.002, 0.04, rows).astype(np.float32)
    rtt[2::5] = np.float32(0.06)                                  # proc ties at 0
    return lat, mask, rtt


def round_inputs(K=70, M=10, C=8, R=16, Rq=32, seed=0):
    """A mid-run state: arms cooling down, an inactive instance, error
    counters near the threshold, rows that issue nothing, queues deep
    enough that latencies straddle tau."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    active = np.arange(M) != 3
    cooling = rng.uniform(size=(K, M)) < 0.1
    pool = (rng.uniform(size=(K, M)) < 0.8) & ~cooling & active
    w = rng.uniform(size=(K, M)).astype(f32) * pool
    w[::11] = 0.0                                        # fallback rows
    w = (w / np.maximum(w.sum(-1, keepdims=True), f32(1e-30))).astype(f32)
    nc = rng.integers(0, C + 1, K).astype(np.int32)
    nc[:2] = 0
    return dict(
        weights=w, cw=rng.uniform(-0.5, 0.5, (K, M)).astype(f32),
        err=rng.integers(0, 3, (K, M)).astype(np.int32),
        cooldown_until=np.where(cooling, f32(12.0), f32(-1e30)).astype(f32),
        in_pool=pool, active=active,
        lat_buf=rng.uniform(0.005, 0.15, (K, M, R)).astype(f32),
        ts_buf=rng.uniform(0.0, 9.9, (K, M, R)).astype(f32),
        ptr=rng.integers(0, R, (K, M)).astype(np.int32),
        r_buf=(rng.uniform(size=(K, Rq)) < 0.9).astype(f32),
        rts_buf=rng.uniform(0.0, 9.9, (K, Rq)).astype(f32),
        rptr=rng.integers(0, Rq, K).astype(np.int32),
        q=rng.uniform(0.0, 12.0, M).astype(f32), nc=nc,
        z=np.exp(0.25 * rng.standard_normal((C, K))).astype(f32),
        rtt_t=rng.uniform(0.002, 0.045, (K, M)).astype(f32),
        s_m=np.full(M, 0.0055, f32),
        served_per_round=(f32(0.1) / (f32(C) * np.full(M, 0.0055, f32))),
        t=np.float32(10.0))


STATICS = dict(tau=0.08, err_thresh=3, cooldown=2.0)


def assert_round_out(want, got):
    for name in ref.RoundStepOut._fields:
        a, b = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert a.shape == b.shape, name
        if name in EXACT or a.dtype.kind in "biu":
            np.testing.assert_array_equal(b.astype(a.dtype), a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL, err_msg=name)


# ---------------------------------------------------------------------------
# Maintenance statistics.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,R", [(37, 16), (20, 64)])
def test_maintenance_plain_vs_reference_oracle(rows, R):
    lat, mask, rtt = maint_inputs(rows, R, rows)
    mu, q = jax.jit(lambda a, b, c: jref.bandit_maintenance_stats(
        a, b, c, 0.08, 0.9))(lat, mask, rtt)
    tmu, tq = ref.bandit_maintenance_stats(T(lat), T(mask), T(rtt), 0.08, 0.9)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
    np.testing.assert_allclose(tmu.numpy(), np.asarray(mu), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("rows,R", [(37, 16), (20, 64)])
def test_maintenance_plain_vs_pallas_body(rows, R):
    lat, mask, rtt = maint_inputs(rows, R, rows + 1)
    mu, q = jkde_kernel.fused_maintenance(
        jnp.asarray(lat), jnp.asarray(mask), jnp.asarray(rtt), 0.08, 0.9,
        interpret=True)
    tmu, tq = ops.bandit_maintenance_stats(T(lat), T(mask), T(rtt), 0.08, 0.9)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
    np.testing.assert_allclose(tmu.numpy(), np.asarray(mu), rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# The maintenance kernel's quantile (csrc/maintenance.cu), replayed in numpy:
# a row on row_geometry's lanes, order-preserving keys sorted by the
# kernel's bitonic network across the lanes, the float32 target rank, and
# the zero a sort of (key, index) takes where that rank falls on the zeros.
# ---------------------------------------------------------------------------

def adversarial_maint_rows(R: int, seed: int):
    """Rows that select at ties: repeated values; -0.0 against +0.0 (lat
    -0.0 or +0.0 with rtt 0, so max(lat - rtt, 0) keeps each sign);
    negative latencies clamped to 0; every sample masked; one sample;
    then random rows with random masks."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    rows = 12
    lat = rng.uniform(0.005, 0.15, (rows, R)).astype(f32)
    mask = rng.uniform(size=(rows, R)) < rng.uniform(0.2, 1.0, (rows, 1))
    rtt = rng.uniform(0.002, 0.04, rows).astype(f32)
    lat[0] = rng.choice(np.array([0.01, 0.05, 0.05, 0.07], f32), R)  # ties
    mask[0] = True
    for r in (1, 2):                                   # signed zeros
        lat[r] = np.where(rng.uniform(size=R) < 0.5, f32(-0.0), f32(0.0))
        lat[r, rng.uniform(size=R) < 0.05] = f32(0.03)
        rtt[r] = f32(0.0)
    mask[1], mask[2] = True, rng.uniform(size=R) < 0.8
    lat[3, ::2] = -lat[3, ::2]                         # clamped to +0.0
    lat[4] = f32(0.05)                                 # one value, masked
    mask[5] = False                                    # every sample masked
    mask[6] = False
    mask[6, rng.integers(R)] = True                    # one sample
    mask[7] = True
    rtt[7] = f32(0.2)                                  # every proc 0.0
    return lat, mask, rtt


def _order_key(x: np.ndarray) -> np.ndarray:
    u = np.where(x == 0, np.float32(0.0), x).astype(np.float32).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def _bitonic(a: np.ndarray, V: int) -> np.ndarray:
    """The kernel's network on slots p = l * V + v: pairs j >= V apart by
    shuffle, closer ones inside a lane."""
    a = a.copy()
    N = a.size
    p = np.arange(N)
    for lk in range(1, N.bit_length()):
        for lj in range(lk - 1, -1, -1):
            k, j = 1 << lk, 1 << lj
            if j >= V:
                o = a[p ^ j]
                take_min = ((p & j) == 0) == ((p & k) == 0)
                a = np.where(take_min, np.minimum(a, o), np.maximum(a, o))
            else:
                lo_p = p[(p & j) == 0]
                lo, hi = a[lo_p], a[lo_p ^ j]
                up = (lo_p & k) == 0
                swap = np.where(up, lo > hi, lo < hi)
                a[lo_p], a[lo_p ^ j] = (np.where(swap, hi, lo),
                                        np.where(swap, lo, hi))
    return a


def kernel_quantile(lat, mask, rtt, rho: float) -> np.ndarray:
    """q as csrc/maintenance.cu's maintenance_kernel selects it."""
    f32 = np.float32
    rows, R = lat.shape
    L, CH = tkde_kernel.row_geometry(R)
    V = 4 * CH
    l, v = np.divmod(np.arange(L * V), V)              # slot p = l * V + v
    idx = (v // 4) * 4 * L + 4 * l + v % 4
    # the zeros' slots in index order: chunk, then lane, then slot
    index_order = np.lexsort((v % 4, l, v // 4))
    q = np.empty(rows, f32)
    for r in range(rows):
        d = lat[r] - rtt[r]
        proc = np.where(d < 0, f32(0.0), d)            # keeps -0.0
        key = _order_key(np.where(mask[r], proc, np.finfo(f32).max))
        slots = np.full(L * V, 0xFFFFFFFF, np.uint32)
        slots[idx < R] = key[idx[idx < R]]
        s = _bitonic(slots, V)
        assert np.all(s[:-1] <= s[1:]) and np.array_equal(s, np.sort(slots))
        n = f32(mask[r].sum())
        tgt = min(max(int(f32(rho) * (n - f32(1.0))), 0), R - 1)
        if s[tgt] != 0x80000000:
            q[r] = (s[tgt] ^ np.uint32(0x80000000)).view(f32)
            continue
        rank = tgt - int((s < 0x80000000).sum())
        zeros = [i for i in idx[index_order]
                 if i < R and mask[r, i] and proc[i] == 0]
        q[r] = proc[zeros[rank]]                       # its own sign
    return q


def stable_quantile(lat, mask, rtt, rho: float) -> np.ndarray:
    """The sample a stable sort of (key, index) puts at the target rank."""
    f32 = np.float32
    rows, R = lat.shape
    q = np.empty(rows, f32)
    for r in range(rows):
        d = lat[r] - rtt[r]
        proc = np.where(mask[r], np.where(d < 0, f32(0.0), d),
                        np.finfo(f32).max)
        order = np.lexsort((np.arange(R), _order_key(proc)))
        n = f32(mask[r].sum())
        q[r] = proc[order[min(max(int(f32(rho) * (n - f32(1.0))), 0), R - 1)]]
    return q


@pytest.mark.parametrize("R", [1, 33, 64, 1024])
def test_maintenance_kernel_selection_is_bit_exact(R):
    # the kernel takes the sample a stable sort of (key, index) takes, bit
    # for bit; the plain version sorts with torch.sort, which orders -0.0
    # and +0.0 as equal but in no defined order among themselves: where the
    # selected sample is a zero both give a zero (its sign may differ);
    # every other q matches bit for bit
    lat, mask, rtt = adversarial_maint_rows(R, R)
    want = ref.bandit_maintenance_stats(T(lat), T(mask), T(rtt), 0.08,
                                        0.9)[1].numpy()
    got = kernel_quantile(lat, mask, rtt, 0.9)
    np.testing.assert_array_equal(
        got.view(np.uint32), stable_quantile(lat, mask, rtt, 0.9).view(np.uint32))
    zero = want == 0
    np.testing.assert_array_equal(got.view(np.uint32)[~zero],
                                  want.view(np.uint32)[~zero])
    np.testing.assert_array_equal(got[zero], want[zero])
    assert got[5] == np.finfo(np.float32).max           # every sample masked
    if R > 1:
        assert zero[1] and np.signbit(lat[1][mask[1]]).any()
    lanes, chunks = tkde_kernel.row_geometry(R)
    assert 4 * lanes * chunks >= R and (lanes == 32 or chunks == 1)


# The maintenance kernel's mu (csrc/maintenance.cu), replayed in numpy: its
# row sums as the kernel orders them (xla_row_sum: lane b adds block b of
# 32, then the block sums; xla_kde_sum: eight accumulators between R 11 and
# 32), its erf's float64 Horner steps, n ** -0.2 from the table the wrapper
# passes. The card holds the kernel to the plain version at a few R
# (chip_smoke.py); this holds the kernel's order at every R.

def _kernel_row_sum(v: np.ndarray, R: int) -> np.float32:
    f32 = np.float32
    width = R if R <= 32 else 32
    parts = []
    for b in range(-(-R // width)):
        acc = v[b * width]
        for c in range(b * width + 1, (b + 1) * width):
            acc = f32(acc + (v[c] if c < R else f32(0.0)))
        parts.append(acc)
    total = parts[0]
    for part in parts[1:]:
        total = f32(total + part)
    return total


def _kernel_kde_sum(v: np.ndarray, R: int) -> np.float32:
    f32 = np.float32
    if R <= 10 or R > 32:
        return _kernel_row_sum(v, R)
    eights = 2 if R <= 16 else R // 8
    acc = list(v[:8])
    for i in range(8):
        for c in range(1, eights):
            acc[i] = f32(acc[i] + (v[8 * c + i] if 8 * c + i < R else f32(0)))
    for h in (4, 2, 1):
        for i in range(h):
            acc[i] = f32(acc[i] + acc[i + h])
    total = acc[0]
    for j in range(8 * eights, R):
        total = f32(total + v[j])
    return total


def _kernel_erf(x: np.ndarray) -> np.ndarray:
    from repro_torch.core import fmath
    f32 = np.float32
    x = np.where(np.abs(x) < np.finfo(f32).tiny, f32(0.0) * x, x)
    x = np.clip(x, -fmath._ERF_CLAMP, fmath._ERF_CLAMP).astype(f32)
    x2 = (x * x).astype(np.float64)
    p = np.full_like(x, fmath._ERF_P[0])
    for c in fmath._ERF_P[1:]:
        p = (p.astype(np.float64) * x2 + c).astype(f32)
    q = np.full_like(x, fmath._ERF_Q[0])
    for c in fmath._ERF_Q[1:]:
        q = (q.astype(np.float64) * x2 + c).astype(f32)
    return (x * p / q).astype(f32)


def kernel_mu(lat, mask, tau: float, min_bw: float = 1e-4) -> np.ndarray:
    """mu as csrc/maintenance.cu's maintenance_kernel computes it."""
    f32 = np.float32
    rows, R = lat.shape
    table = ref._powf_table(R)
    mu = np.empty(rows, f32)
    for r in range(rows):
        m, x = mask[r].astype(f32), lat[r]
        n = f32(m.sum())
        nc = max(n, f32(1.0))
        mean = f32(_kernel_row_sum(x * m, R) / nc)
        d = x - mean
        var = f32(_kernel_row_sum(d * d * m, R) / nc)
        h = max(f32(f32(f32(1.06) * np.sqrt(max(var, f32(0.0))))
                    * table[int(nc)]), f32(min_bw))
        z = (f32(tau) - x) / h
        cdf = f32(0.5) * (f32(1.0) + _kernel_erf(z * f32(0.7071067811865476)))
        kde = _kernel_kde_sum((cdf * m).astype(f32), R)
        mu[r] = f32(kde / nc) if n > 0 else f32(0.0)
    return mu


@pytest.mark.parametrize("R", [*range(1, 41), 48, 63, 64, 65, 100, 1024])
def test_maintenance_kernel_mu_order_is_the_plain_versions(R):
    lat, mask, rtt = adversarial_maint_rows(R, 7 + R)
    want = ref.bandit_maintenance_stats(T(lat), T(mask), T(rtt), 0.08,
                                        0.9)[0].numpy()
    np.testing.assert_array_equal(kernel_mu(lat, mask, 0.08).view(np.uint32),
                                  want.view(np.uint32))


def test_row_geometry():
    assert tkde_kernel.row_geometry(64) == (16, 1)       # two rows a warp
    assert tkde_kernel.row_geometry(1) == (1, 1)
    assert tkde_kernel.row_geometry(33) == (16, 1)
    assert tkde_kernel.row_geometry(129) == (32, 2)
    assert tkde_kernel.row_geometry(1024) == (32, 8)
    # the KDE kernel: 4 quads a lane, 8 rows a warp at R = 64; past 512
    # samples a row runs in segments
    assert tkde_kernel.kde_geometry(64) == (4, 4)
    assert tkde_kernel.kde_geometry(1) == (1, 1)
    assert tkde_kernel.kde_geometry(33) == (4, 4)
    assert tkde_kernel.kde_geometry(1027) == (32, 4)
    for R in range(1, 600):
        lanes, chunks = tkde_kernel.kde_geometry(R)
        assert (lanes == 1 or chunks == 4) and lanes in (1, 2, 4, 8, 16, 32)
        assert 4 * lanes * chunks >= min(R, 512)


# ---------------------------------------------------------------------------
# KDE success probability (the maintenance's middle stage, bandwidths given).
# tests/test_kernels.py's sweep and tolerance.
# ---------------------------------------------------------------------------

def kde_inputs(rows: int, R: int, seed: int):
    rng = np.random.default_rng(seed)
    lat = rng.exponential(0.03, (rows, R)).astype(np.float32)
    mask = rng.random((rows, R)) < 0.7
    mask[0] = False                                               # empty row
    bw = rng.uniform(1e-3, 1e-2, rows).astype(np.float32)
    return lat, mask, bw


@pytest.mark.parametrize("oracle", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("rows,R", [(8, 16), (300, 64), (1024, 128)])
def test_kde_success_prob_plain_vs_reference(rows, R, oracle):
    lat, mask, bw = kde_inputs(rows, R, rows + R)
    if oracle == "ref":
        want = jax.jit(lambda a, b, c: jref.kde_success_prob(a, b, 0.08, c))(
            lat, mask, bw)
    else:
        want = jkde_kernel.kde_success_prob(
            jnp.asarray(lat), jnp.asarray(mask), 0.08, jnp.asarray(bw),
            interpret=True)
    got = ops.kde_success_prob(T(lat), T(mask), 0.08, T(bw))
    assert got.shape == (rows,) and got[0].item() == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-6)


def test_kde_dispatch_raises_without_a_kernel_library(monkeypatch, tmp_path):
    _no_nvcc(monkeypatch, tmp_path)
    tkde_kernel._kde_launcher.cache_clear()
    monkeypatch.setattr(ops, "_on_host", lambda x: False)
    lat, mask, bw = kde_inputs(10, 16, 0)
    with pytest.raises(RuntimeError, match="nvcc"):
        ops.kde_success_prob(T(lat), T(mask), 0.08, T(bw))
    assert tkde_kernel.kde_success_prob.launches == 0


def test_kde_wrapper_refuses_host_tensors(monkeypatch):
    monkeypatch.setattr(tkde_kernel, "_kde_launcher", lambda: None)
    lat, mask, bw = kde_inputs(10, 16, 0)
    with pytest.raises(ValueError, match="CUDA"):
        tkde_kernel.kde_success_prob(T(lat), T(mask), 0.08, T(bw))


# ---------------------------------------------------------------------------
# Round step.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def round_case():
    args = round_inputs()
    got = ops.round_step(*(T(v) for v in args.values()), **STATICS)
    return args, got


def test_round_step_plain_vs_reference_oracle(round_case):
    args, got = round_case
    want = jax.jit(lambda a: jref.round_step_swrr(**a, **STATICS))(args)
    assert_round_out(want, got)
    # the state really moved: trips, ring writes, queue arrivals
    assert (got.cooldown_until.numpy() != args["cooldown_until"]).any()
    assert (got.ptr.numpy() != args["ptr"]).any()
    assert got.arrivals.sum().item() == args["nc"].sum()


def test_round_step_plain_vs_pallas_body(round_case):
    # K = 70 is not a multiple of the Pallas kernel's 64-player block
    args, got = round_case
    want = jround.round_step_swrr(
        **{k: jnp.asarray(v) for k, v in args.items()}, **STATICS,
        interpret=True)
    assert_round_out(want, got)


def test_round_step_leaves_inputs_untouched(round_case):
    args, _ = round_case
    ins = {k: T(v) for k, v in args.items()}
    before = {k: v.clone() for k, v in ins.items()}
    ops.round_step(*ins.values(), **STATICS)
    for k in ins:
        assert torch.equal(ins[k], before[k]), k


def test_round_step_idle_rows_issue_nothing():
    args = round_inputs(K=9, seed=3)
    args["nc"][:] = 0
    out = ops.round_step(*(T(v) for v in args.values()), **STATICS)
    assert out.arrivals.sum().item() == 0.0
    for name in ("lat_buf", "ts_buf", "ptr", "r_buf", "rts_buf", "rptr",
                 "err", "cooldown_until", "in_pool"):
        np.testing.assert_array_equal(getattr(out, name).numpy(), args[name],
                                      err_msg=name)


# ---------------------------------------------------------------------------
# Round kernel's launch geometry and blocked schedule (csrc/round_fused.cu),
# through the wrapper's Python mirrors; the kernel itself runs on the card.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K,ctas_per_sm,sms", [
    (1, 3, 132), (30, 3, 132), (1000, 3, 132), (5003, 3, 132),
    (1000, 1, 4), (5003, 2, 16)])
def test_round_every_player_owned_by_one_warp(K, ctas_per_sm, sms):
    warps = tround.WARPS
    grid, ppw = tround._grid(K, warps, ctas_per_sm, sms)
    assert 1 <= grid <= ctas_per_sm * sms          # every CTA resident
    W = grid * warps
    owned = [tround._players(w, K, W) for w in range(W)]
    flat = [k for ks in owned for k in ks]
    assert sorted(flat) == list(range(K))          # each player once
    assert max(len(ks) for ks in owned) == ppw
    if ppw == 1:                                   # no idle CTA
        assert grid == -(-K // warps)


def test_round_workspace_and_shared_memory_sizes():
    # the barrier counter on its own 128-byte line, then (C, M) arrivals
    assert tround._workspace_words(8, 50) == 32 + 8 * 50
    assert tround.WORKSPACE_HEAD * 4 == 128
    # the fleet's shape, as the card reported it; 16-byte aligned rows
    assert tround._smem_bytes(50, 8, 8) == 11776
    for M in (1, 10, 50, 130, 1000):
        assert tround._smem_bytes(M, 8, 1) % 16 == 0
    assert tround._warps(50, 8) == tround.WARPS
    assert tround._warps(2000, 8) < tround.WARPS   # fewer warps fit
    assert tround._smem_bytes(2000, 8, tround._warps(2000, 8)) \
        <= tround.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        tround._warps(20000, 8)
    with pytest.raises(ValueError, match="no CTA"):
        tround._grid(10, 8, 0, 132)


def _ordered(f: np.float32) -> int:
    """The kernel's argmax key: an unsigned int in the float's order."""
    u = int(np.float32(0.0 if f == 0 else f).view(np.uint32))
    return (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)


def _row_sum(x, skip=-1) -> np.float32:
    s = np.float32(0.0) if skip == 0 else x[0]
    for m in range(1, len(x)):
        s = s + (np.float32(0.0) if m == skip else x[m])
    return np.float32(s)


def _select(w, cw) -> tuple[int, np.float32]:
    """SWRR pick as the kernel's warp makes it: lane-local first maximum
    over arms lane, lane + 32, ..., then the largest key and the lowest
    arm holding it."""
    total = _row_sum(w)
    cw += w
    keys = {}
    for lane in range(32):
        arms = range(lane, len(w), 32)
        best = None
        for m in arms:
            if best is None or cw[m] > cw[best]:
                best = m
        if best is not None:
            keys[best] = _ordered(cw[best])
    top = max(keys.values())
    choice = min(m for m, key in keys.items() if key == top)
    cw[choice] = cw[choice] - total
    return choice, total


def _blocked_round_step(a: dict, tau, err_thresh, cooldown, warps,
                        ctas_per_sm, sms):
    """numpy emulation of csrc/round_fused.cu's schedule: players in CTA
    blocks, each block's round arrivals summed in its shared memory and
    then onto the round's workspace row (blocks in reverse order), every
    block recomputing the queue itself; one-pass fallback counts, one
    division per weight, the ring slots written after the last round."""
    f32 = np.float32
    K, M, R = a["lat_buf"].shape
    C, Rq = a["z"].shape[0], a["r_buf"].shape[1]
    grid, _ = tround._grid(K, warps, ctas_per_sm, sms)
    W = grid * warps
    w, cw = a["weights"].copy(), a["cw"].copy()
    err, cd = a["err"].copy(), a["cooldown_until"].copy()
    pool, act = a["in_pool"].copy(), a["active"]
    t, t_cd = f32(a["t"]), f32(f32(a["t"]) + f32(cooldown))
    q_blocks = [a["q"].copy() for _ in range(grid)]
    choices = np.zeros((K, C), np.int32)
    lats, procs = np.zeros((K, C), f32), np.zeros((K, C), f32)
    ws = np.zeros((C, M), f32)
    for r in range(C):
        partial = np.zeros((grid, M), f32)
        for b in range(grid):
            q = q_blocks[b]
            for gw in range(b * warps, (b + 1) * warps):
                for k in tround._players(gw, K, W):
                    choice, total = _select(w[k], cw[k])
                    q1s = f32((q[choice] + f32(1.0)) * a["s_m"][choice])
                    z = a["z"][r, k]
                    lat = f32(np.float64(q1s) * np.float64(z)
                              + np.float64(a["rtt_t"][k, choice]))
                    mask = r < a["nc"][k]
                    new_err = 0 if lat <= f32(tau) else err[k, choice] + 1
                    trip = bool(mask and new_err >= err_thresh)
                    if mask:
                        err[k, choice] = 0 if trip else new_err
                    if trip:
                        cd[k, choice], pool[k, choice] = t_cd, False
                    wsum = _row_sum(w[k], choice) if trip else total
                    tripped = (np.arange(M) == choice) & trip
                    n_rem = int((act & pool[k]).sum())
                    n_act = int((act & ~tripped).sum())
                    if wsum > 0:
                        num = np.where(tripped, f32(0.0), w[k])
                        den = max(wsum, f32(1e-30))
                    else:
                        fb = act & pool[k] if n_rem else act & ~tripped
                        num = fb.astype(f32)
                        den = f32(max(n_rem if n_rem else n_act, 1))
                    w[k] = np.where(num == 0, num, num / den).astype(f32)
                    cw[k][tripped] = f32(0.0)
                    choices[k, r], lats[k, r] = choice, lat
                    procs[k, r] = f32(q1s * z)
                    if mask:
                        partial[b, choice] += f32(1.0)
        for b in reversed(range(grid)):
            ws[r] += partial[b]
        for b in range(grid):
            q_blocks[b] = np.maximum((q_blocks[b] + ws[r]) - a["served_per_round"],
                                     f32(0.0)).astype(f32)
        for q in q_blocks[1:]:
            np.testing.assert_array_equal(q, q_blocks[0])
    lat_buf, ts_buf = a["lat_buf"].copy(), a["ts_buf"].copy()
    r_buf, rts_buf = a["r_buf"].copy(), a["rts_buf"].copy()
    ptr, rptr = a["ptr"].copy(), a["rptr"].copy()
    for k in range(K):
        for r in range(min(C, int(a["nc"][k]))):
            ch = choices[k, r]
            lat_buf[k, ch, ptr[k, ch]], ts_buf[k, ch, ptr[k, ch]] = lats[k, r], t
            ptr[k, ch] = (ptr[k, ch] + 1) % R
            r_buf[k, rptr[k]] = f32(1.0) if lats[k, r] <= f32(tau) else f32(0.0)
            rts_buf[k, rptr[k]] = t
            rptr[k] = (rptr[k] + 1) % Rq
    arrivals = np.zeros(M, f32)
    for r in range(C):
        arrivals = arrivals + ws[r]
    return ref.RoundStepOut(w, cw, err, cd, pool, lat_buf, ts_buf, ptr, r_buf,
                            rts_buf, rptr, q_blocks[0], arrivals, choices,
                            lats, procs)


@pytest.mark.parametrize("K,ctas_per_sm,sms", [(70, 3, 132), (1000, 2, 8)])
def test_round_blocked_schedule_is_bit_exact(K, ctas_per_sm, sms):
    # K = 70: a warp for each player in 9 CTAs; K = 1000 on 16 CTAs:
    # every warp loops over 8 players. M = 40 gives lanes two arms.
    args = round_inputs(K=K, M=40, seed=K)
    assert (args["nc"] == 0).sum() >= 2                 # rows that issue nothing
    # rows of equal credits and weights: the pick is a tie, to the lowest arm
    args["cw"][1::9] = 0.0
    args["weights"][1::9] = np.float32(1.0 / 40)
    want = ref.round_step_swrr(*(T(v) for v in args.values()), **STATICS)
    got = _blocked_round_step(args, warps=tround.WARPS,
                              ctas_per_sm=ctas_per_sm, sms=sms, **STATICS)
    for name in ref.RoundStepOut._fields:
        a = getattr(want, name).numpy()
        b = np.asarray(getattr(got, name))
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(b.view(np.uint8), a.view(np.uint8),
                                      err_msg=name)
    assert (got.cooldown_until != args["cooldown_until"]).any()   # trips


# ---------------------------------------------------------------------------
# Dispatch: a tensor off the CPU goes to the kernel or raises.
# ---------------------------------------------------------------------------

def test_build_flags_target_hopper_and_forbid_fma():
    assert "arch=compute_90a,code=sm_90a" in _build.COMPILE_FLAGS
    assert "--fmad=false" in _build.COMPILE_FLAGS
    assert [s.name for s in _build.sources()] == [
        "decode_attention.cu", "flash_attention.cu", "flash_attention_bwd.cu",
        "maintenance.cu", "round_fused.cu", "ssd.cu"]


def _no_nvcc(monkeypatch, tmp_path):
    def missing():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(_build, "nvcc", missing)
    monkeypatch.setattr(_build, "LIBRARY", tmp_path / "libreprotorch.so")
    monkeypatch.setattr(_build, "_lib", None)
    tkde_kernel._launcher.cache_clear()
    tround._launcher.cache_clear()


def test_dispatch_raises_without_a_kernel_library(monkeypatch, tmp_path):
    # a tensor the dispatch takes for a card's: the call must try the
    # kernel and raise, never fall back to the plain version
    _no_nvcc(monkeypatch, tmp_path)
    monkeypatch.setattr(ops, "_on_host", lambda x: False)
    lat, mask, rtt = maint_inputs(10, 16, 0)
    with pytest.raises(RuntimeError, match="nvcc"):
        ops.bandit_maintenance_stats(T(lat), T(mask), T(rtt), 0.08, 0.9)
    args = round_inputs(K=5)
    with pytest.raises(RuntimeError, match="nvcc"):
        ops.round_step(*(T(v) for v in args.values()), **STATICS)
    assert tkde_kernel.fused_maintenance.launches == 0


def test_kernel_wrappers_refuse_host_tensors(monkeypatch, tmp_path):
    # with a library present the wrappers still check the device first
    monkeypatch.setattr(tkde_kernel, "_launcher", lambda: None)
    monkeypatch.setattr(tround, "_launcher", lambda: None)
    lat, mask, rtt = maint_inputs(10, 16, 0)
    with pytest.raises(ValueError, match="CUDA"):
        tkde_kernel.fused_maintenance(T(lat), T(mask), T(rtt), 0.08, 0.9)
    args = round_inputs(K=5)
    with pytest.raises(ValueError, match="CUDA"):
        tround.round_step_swrr(*(T(v) for v in args.values()), **STATICS)
