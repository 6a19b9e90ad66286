"""The port's baselines, batched rounds and round scan against the JAX
package's, on the same seeded inputs (live JAX calls on the CPU).

Tolerances:
* ``proxy_mity_weights``, ``decsarsa_init`` / ``_select`` /
  ``_update``, ``round_step_gumbel`` and ``record_batch``: exact, every
  float included (0 ULP). The three Dec-SARSA expressions XLA:CPU
  could contract were found by comparing bits: it fuses ``0.3 *
  latency`` into the EMA's add and ``alpha_r * (reward - rbar)`` into
  the average reward's add, and leaves ``q + beta * td`` unfused; the
  port replays exactly those (``core.fmath.fma``).
* Whole runs in trace mode at K=30 x M=10 from ``PRNGKey(7)``:
  ``choices``, ``issued``, ``arrivals`` and ``rewards`` exact; per-step
  ``latency``, ``queue`` and ``regret`` to ``rtol=1e-5`` with an
  absolute ``M * eps32`` per step for regret (a difference of sums
  below 1: the oracle's ``erf``/``log`` land an ULP away from XLA's).
  proxy-mity runs 5 s; Dec-SARSA runs the paper's whole 180 s, over
  which its choices stay exact at this seed (one processing-noise draw
  in ~10^5 rounds an ULP away moves a latency, never a choice).
* Fused against unfused inside the port: every accumulator field and
  series value bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.continuum import scenarios as jscn
from repro.continuum import simulator as js
from repro.continuum import topology as jtopo
from repro.core import bandit as jb
from repro.core import baselines as jbl
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.continuum import simulator as ts
from repro_torch.core import bandit as tb
from repro_torch.core import baselines as tbl
from repro_torch.kernels import ops as tops

EPS32 = float(np.finfo(np.float32).eps)


def T(x) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(x), copy=True))


def exact(want, got, what=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


def jkey(seed):
    return jax.random.PRNGKey(seed)


def tkey(seed):
    return convert.key_to_torch(np.asarray(jax.random.PRNGKey(seed)), "cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors: one intra-op thread is faster than many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rtt30():
    topo = jtopo.make_topology(jax.random.PRNGKey(7), 30, 10)
    return np.asarray(topo.lb_instance_rtt())


# ---------------------------------------------------------------------------
# proxy-mity
# ---------------------------------------------------------------------------

def _pm_inputs(case):
    rng = np.random.default_rng(3)
    rtt = rng.uniform(0.002, 0.04, (24, 10)).astype(np.float32)
    active = np.ones(10, bool)
    if case in ("down", "down_and_ties"):
        active[[0, 4, 9]] = False
        rtt[:6, 4] = 1e-4           # nearest, but down
    if case in ("ties", "down_and_ties"):
        rtt[:, 2] = rtt[:, 5] = rtt[:, 7] = 1e-3     # three-way tie
        rtt[3, :] = 0.01                             # a whole row tied
    if case == "one_up":
        active[:] = False
        active[6] = True
    return rtt, active


@pytest.mark.parametrize("alpha", [1.0, 0.9])
@pytest.mark.parametrize("case", ["all_up", "down", "ties", "down_and_ties",
                                  "one_up"])
def test_proxy_mity_weights_exact(alpha, case):
    rtt, active = _pm_inputs(case)
    want = jax.jit(lambda r, a: jbl.proxy_mity_weights(r, alpha, a))(
        rtt, active)
    got = tbl.proxy_mity_weights(T(rtt), alpha, T(active))
    exact(want, got.numpy())
    if case == "all_up":
        exact(jbl.proxy_mity_weights(rtt, alpha),
              tbl.proxy_mity_weights(T(rtt), alpha).numpy())


# ---------------------------------------------------------------------------
# Dec-SARSA
# ---------------------------------------------------------------------------

def _ds_state(seed, K=40, M=10):
    """A mid-run DecSarsaState (numpy), varied in every field."""
    rng = np.random.default_rng(seed)
    S = jbl.N_LOAD_BUCKETS
    q = rng.uniform(0.3, 1.0, (K, S, M)).astype(np.float32)
    q[:4, :, 3] = q[:4, :, 6] = 0.9                   # greedy ties
    return jbl.DecSarsaState(
        q=q, rbar=rng.uniform(0, 1, K).astype(np.float32),
        prev_s=rng.integers(0, S, K).astype(np.int32),
        prev_a=rng.integers(0, M, K).astype(np.int32),
        has_prev=rng.uniform(size=K) < 0.5,
        last_lat=rng.uniform(0.0, 0.12, K).astype(np.float32),
        eps=rng.uniform(0.0, 0.6, K).astype(np.float32))


def _to_torch(st):
    return tbl.DecSarsaState(*(T(x) for x in st))


def test_decsarsa_init_exact(rtt30):
    p = jbl.DecSarsaParams()
    want = jax.jit(lambda r: jbl.decsarsa_init(30, 10, r, p))(rtt30)
    got = tbl.decsarsa_init(30, 10, T(rtt30), tbl.DecSarsaParams())
    for f in want._fields:
        exact(getattr(want, f), getattr(got, f).numpy(), f)
    # an explicit global maximum (the player-sharded form)
    want = jbl.decsarsa_init(12, 10, rtt30[:12], p, jnp.float32(0.05))
    got = tbl.decsarsa_init(12, 10, T(rtt30[:12]), tbl.DecSarsaParams(),
                            torch.tensor(0.05))
    exact(want.q, got.q.numpy(), "q")


@pytest.mark.parametrize("with_pids", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_decsarsa_select_exact(with_pids, seed):
    st = _ds_state(seed)
    K, M = st.q.shape[0], st.q.shape[2]
    active = np.ones(M, bool)
    active[[1, 8]] = False
    pids = np.arange(100, 100 + K, dtype=np.int32) if with_pids else None
    p = jbl.DecSarsaParams()
    want_a, want_s = jax.jit(
        lambda s, a, k, i: jbl.decsarsa_select(s, p, a, k, i))(
            st, active, jkey(seed + 11), pids)
    got_a, got_s = tbl.decsarsa_select(
        _to_torch(st), tbl.DecSarsaParams(), T(active), tkey(seed + 11),
        None if pids is None else T(pids))
    exact(want_a, got_a.numpy(), "choice")
    exact(want_s, got_s.numpy(), "bucket")
    assert not np.isin(got_a.numpy(), [1, 8]).any()     # down arms


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decsarsa_update_exact(seed):
    st = _ds_state(seed, K=2000)
    K, S, M = st.q.shape
    rng = np.random.default_rng(seed + 50)
    s = rng.integers(0, S, K).astype(np.int32)
    a = rng.integers(0, M, K).astype(np.int32)
    lat = rng.uniform(0.0, 0.15, K).astype(np.float32)
    reward = (lat <= 0.08).astype(np.float32)
    mask = rng.uniform(size=K) < 0.8
    p = jbl.DecSarsaParams()
    want = jax.jit(lambda *x: jbl.decsarsa_update(x[0], p, *x[1:]))(
        st, s, a, reward, lat, mask)
    got = tbl.decsarsa_update(_to_torch(st), tbl.DecSarsaParams(), T(s),
                              T(a), T(reward), T(lat), T(mask))
    for f in want._fields:             # q, rbar, last_lat, eps: 0 ULP
        exact(getattr(want, f), getattr(got, f).numpy(), f)


# ---------------------------------------------------------------------------
# Batched rounds and record_batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K,M,C", [(30, 10, 8), (7, 3, 5)])
def test_round_step_gumbel_exact(K, M, C):
    rng = np.random.default_rng(K)
    w = rng.uniform(0, 1, (K, M)).astype(np.float32)
    w[:, 0] = 0.0                                   # a zero-weight arm
    w /= w.sum(1, keepdims=True)
    args = dict(
        weights=w, q=rng.uniform(0, 5, M).astype(np.float32),
        nc=rng.integers(0, C + 1, K).astype(np.int32),
        z=np.exp(0.25 * rng.normal(size=(C, K))).astype(np.float32),
        gum=rng.gumbel(size=(C, K, M)).astype(np.float32),
        rtt_t=rng.uniform(0.002, 0.04, (K, M)).astype(np.float32),
        s_m=np.full(M, 0.0055, np.float32),
        served_per_round=np.full(M, 1.5, np.float32))
    want = jax.jit(jref.round_step_gumbel)(**args)
    got = tops.round_step_gumbel(**{k: T(v) for k, v in args.items()})
    for name, a, b in zip(("q", "arrivals", "choices", "lats", "procs"),
                          want, got):
        assert b.is_contiguous()
        exact(a, b.numpy(), name)


@pytest.mark.parametrize("K,M,C,ring,steps", [(5, 4, 6, 8, 12),
                                              (3, 2, 8, 64, 4)])
def test_record_batch_exact(K, M, C, ring, steps):
    rng = np.random.default_rng(K * 100 + C)
    P = jb.BanditParams(err_thresh=2)
    js_ = jb.init_state(K, M, P, ring=ring, reward_ring=16,
                        key=jax.random.PRNGKey(1))
    ts_ = convert.bandit_state_to_torch(jax.tree.map(np.asarray, js_), "cpu")
    fn = jax.jit(lambda s, c, l, t, m: jb.record_batch(s, P, c, l, t, m))
    for i in range(steps):
        ch = rng.integers(0, M, (K, C)).astype(np.int32)
        lat = rng.uniform(0.005, 0.3, (K, C)).astype(np.float32)
        mask = rng.random((K, C)) < 0.7
        t = np.float32(0.1 * i)
        js_ = fn(js_, ch, lat, t, mask)
        ts_ = tb.record_batch(ts_, tb.BanditParams(err_thresh=2), T(ch),
                              T(lat), float(t), T(mask))
    for f in js_._fields:
        exact(getattr(js_, f), getattr(ts_, f).numpy(), f)


# ---------------------------------------------------------------------------
# Whole runs in trace mode
# ---------------------------------------------------------------------------

EXACT = ("choices", "issued", "arrivals", "rewards")


@pytest.mark.parametrize("name,kw,horizon", [
    ("proxy_mity", dict(alpha=1.0), 5.0),
    ("proxy_mity", dict(alpha=0.9), 5.0),
    ("dec_sarsa", {}, 180.0),
], ids=["proxy_mity_1.0", "proxy_mity_0.9", "dec_sarsa"])
def test_trace_run_matches_the_reference(name, kw, horizon, rtt30):
    want = js.run_sim(name, jnp.asarray(rtt30), js.SimConfig(horizon=horizon),
                      jkey(7), **kw)
    want = jax.tree.map(np.asarray, want)
    got = ts.run_sim(name, rtt30, ts.SimConfig(horizon=horizon), tkey(7),
                     device="cpu", **kw)
    assert got._fields == want._fields
    for f in want._fields:
        a, b = getattr(want, f), getattr(got, f).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, f
    for f in EXACT:
        exact(getattr(want, f), getattr(got, f).numpy(), f)
    for f in ("latency", "queue", "proc_lat"):
        np.testing.assert_allclose(getattr(got, f).numpy(), getattr(want, f),
                                   rtol=1e-5, err_msg=f)
    np.testing.assert_allclose(got.regret.numpy(), want.regret, rtol=1e-5,
                               atol=10 * EPS32, err_msg="regret")
    exact(want.eps, got.eps.numpy(), "eps")


def test_trace_run_from_a_mid_run_carry(rtt30):
    """One Dec-SARSA and one proxy-mity step from the reference's own
    mid-run carry (carried across with ``convert``)."""
    for name, kw in (("dec_sarsa", {}), ("proxy_mity", dict(alpha=0.9))):
        cfg = js.SimConfig(horizon=1.2)
        init_fn, step_fn = js.build_sim_parts(name, cfg, 30, 10, **kw)
        drv = jscn.neutral_drivers(cfg, 30, 10)
        rtt = jnp.asarray(rtt30)
        carry, keys = init_fn(rtt, drv.active[0], jkey(5))
        step = jax.jit(lambda c, x: step_fn(rtt, drv.marks, c, x))
        for i in range(cfg.num_steps):
            xs = (jnp.int32(i), *(getattr(drv, f)[i]
                                  for f in jscn.STEP_FIELDS),
                  keys[i], carry[4][i % cfg.maint_every])
            prev = carry
            carry, ys = step(carry, xs)
        as_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
        prev, xs, carry, ys = as_np(prev), as_np(xs), as_np(carry), as_np(ys)
        _, tstep = ts.build_sim_parts(name, ts.SimConfig(horizon=1.2), 30, 10,
                                      **kw)
        t_idx, *fields, key, group = xs
        txs = (int(t_idx), *(T(f) for f in fields),
               convert.key_to_torch(key, "cpu"), T(group))
        tc = convert.carry_to_torch(prev, "cpu")
        back = convert.carry_to_numpy(tc)
        for a, b in zip(jax.tree.leaves(prev), jax.tree.leaves(back)):
            exact(a, b)
        got, tys = tstep(T(rtt30), T(np.full(32, -1, np.int32)), tc, txs,
                         False)
        got = convert.carry_to_numpy(got)
        for a, b in zip(jax.tree.leaves(carry[:3]), jax.tree.leaves(got[:3])):
            exact(a, b, name)
        for f in EXACT:
            exact(getattr(ys, f), getattr(tys, f).numpy(), f"{name} {f}")


# ---------------------------------------------------------------------------
# Fused against unfused, inside the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("structure", ["plain", "sequential"])
@pytest.mark.parametrize("name,kw", [("qedgeproxy", {}),
                                     ("proxy_mity", dict(alpha=0.9))],
                         ids=["qedgeproxy", "proxy_mity"])
def test_port_fused_matches_unfused(name, kw, structure, rtt30):
    """``plain``: ``fused_round=False`` (the round scan); ``sequential``:
    also ``fused=False`` (per-round ``record``, masked maintenance)."""
    fused = ts.run_sim_stream(name, rtt30, ts.SimConfig(horizon=3.0), 7,
                              warmup_steps=5, device="cpu", **kw)
    extra = {} if structure == "plain" else dict(fused=False)
    unfused = ts.run_sim_stream(name, rtt30,
                                ts.SimConfig(horizon=3.0, fused_round=False),
                                7, warmup_steps=5, device="cpu", **kw,
                                **extra)
    for f in fused.acc._fields:
        exact(getattr(fused.acc, f).numpy(), getattr(unfused.acc, f).numpy(),
              f"acc.{f}")
    for f in fused.series._fields:
        exact(getattr(fused.series, f).numpy(),
              getattr(unfused.series, f).numpy(), f"series.{f}")
