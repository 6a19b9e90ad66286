"""The port's request lifecycle (timeouts, retries, circuit breakers)
against the JAX package's, live JAX calls on the CPU.

* The breaker helpers (``breaker_update``, ``breaker_reset_arms``,
  ``breaker_is_open``, ``masked_pick``, ``breaker_veto``,
  ``retry_pick``, ``censored_latency``) equal the reference's exactly on
  seeded random inputs, the all-ejected and only-active-arm fallbacks
  included.
* Whole runs on a compiled ``retry_storm`` at the graceful-degradation
  lane's tau (each ``DEGRADE_POLICIES`` entry under ``qedgeproxy``, the
  bounded policy under ``proxy_mity`` and ``dec_sarsa``): every count
  of the accumulator and the series (attempts, timeouts, drops, open
  breakers, choices, latency bins, QoS) is exact; the float sums of the
  true ``mu`` (regret, the variation budget) hold ``rtol=1e-6`` plus
  ``M * eps32`` a term. No pick moved at this size, so no maintenance
  drift bound is needed.
* A timeout no attempt reaches runs the resilient round scan and equals
  the neutral run (fused round) bit for bit; the neutral config is the
  default one.
* Three lanes with resilience each equal their run alone, and the trace
  readout ``resilience_stats`` equals the stream's.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import scenario_suite as bsuite
from repro.continuum import library as jlib
from repro.continuum import scenarios as jscn
from repro.continuum import simulator as js
from repro.continuum import topology as jtopo
from repro.core import bandit as jb
from repro_torch import convert
from repro_torch.bench import scenarios as tsuite
from repro_torch.continuum import library as tlib
from repro_torch.continuum import metrics as tm
from repro_torch.continuum import scenarios as tscn
from repro_torch.continuum import simulator as ts
from repro_torch.continuum import topology as ttopo
from repro_torch.core import bandit as tb
from repro_torch.core import prand

EPS32 = float(np.finfo(np.float32).eps)
K, M, C, R = 6, 4, 4, 16
HORIZON, WARM = 5.0, 10                 # 50 steps
SMALL = dict(max_clients=C, ring=R, horizon=HORIZON)
FLOATS = ("regret_k", "vb_k", "prev_mu")
BOUNDED = dict(bsuite.DEGRADE_POLICIES)["bounded"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors: one intra-op thread is faster than many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(x) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(x), copy=True))


# ---------------------------------------------------------------------------
# The breaker helpers.
# ---------------------------------------------------------------------------

def breaker_inputs(seed, KK=9, MM=5):
    rng = np.random.default_rng(seed)
    t = np.float32(7.3)
    fails = rng.integers(0, 5, (KK, MM)).astype(np.int32)
    open_until = np.where(rng.uniform(size=(KK, MM)) < 0.4,
                          t + rng.uniform(-1, 1, (KK, MM)), -1e30
                          ).astype(np.float32)
    active = rng.uniform(size=MM) < 0.8
    active[0] = True
    w = rng.uniform(size=(KK, MM)).astype(np.float32) * active
    w[0] = 0.0                                  # a row with no weight mass
    w[1, 1:] = 0.0
    g = rng.gumbel(size=(KK, MM)).astype(np.float32)
    choice = rng.integers(0, MM, KK).astype(np.int32)
    mask = rng.uniform(size=KK) < 0.8
    timed_out = rng.uniform(size=KK) < 0.5
    return dict(t=t, fails=fails, open_until=open_until, active=active, w=w,
                g=g, choice=choice, mask=mask, timed_out=timed_out)


@pytest.mark.parametrize("seed", range(4))
def test_breaker_helpers_match_the_reference(seed):
    x = breaker_inputs(seed)
    jbrk = jb.BreakerState(jnp.asarray(x["fails"]),
                           jnp.asarray(x["open_until"]))
    tbrk = tb.BreakerState(T(x["fails"]), T(x["open_until"]))
    t = x["t"]
    for thr in (1, 3):
        want = jb.breaker_update(jbrk, jnp.asarray(x["choice"]),
                                 jnp.asarray(x["timed_out"]),
                                 jnp.asarray(x["mask"]), jnp.float32(t), thr,
                                 2.0)
        got = tb.breaker_update(tbrk, T(x["choice"]), T(x["timed_out"]),
                                T(x["mask"]), float(t), thr, 2.0)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(
        tb.breaker_is_open(tbrk, float(t)).numpy(),
        np.asarray(jb.breaker_is_open(jbrk, jnp.float32(t))))
    changed = x["active"] ^ (np.arange(len(x["active"])) % 2 == 0)
    for a, b in zip(jb.breaker_reset_arms(jbrk, jnp.asarray(changed)),
                    tb.breaker_reset_arms(tbrk, T(changed))):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    open_now = np.asarray(jb.breaker_is_open(jbrk, jnp.float32(t)))
    ok = x["active"][None, :] & ~open_now
    np.testing.assert_array_equal(
        tb.masked_pick(T(x["w"]), T(ok), T(x["g"])).numpy(),
        np.asarray(jb.masked_pick(jnp.asarray(x["w"]), jnp.asarray(ok),
                                  jnp.asarray(x["g"]))))
    np.testing.assert_array_equal(
        tb.breaker_veto(T(x["choice"]), tbrk, float(t), T(x["w"]),
                        T(x["active"]), T(x["g"]), T(x["mask"])).numpy(),
        np.asarray(jb.breaker_veto(
            jnp.asarray(x["choice"]), jbrk, jnp.float32(t),
            jnp.asarray(x["w"]), jnp.asarray(x["active"]),
            jnp.asarray(x["g"]), jnp.asarray(x["mask"]))))
    for on in (open_now, None):
        np.testing.assert_array_equal(
            tb.retry_pick(T(x["w"]), T(x["active"]), T(x["choice"]),
                          None if on is None else T(on), T(x["g"])).numpy(),
            np.asarray(jb.retry_pick(
                jnp.asarray(x["w"]), jnp.asarray(x["active"]),
                jnp.asarray(x["choice"]),
                None if on is None else jnp.asarray(on),
                jnp.asarray(x["g"]))))


def test_breaker_fallbacks_match_the_reference():
    """Every active arm ejected: the veto picks over all active arms
    (fail-open); the failed arm the only active one: the retry goes back
    to it; nothing closed but the failed arm: the breaker constraint is
    dropped."""
    x = breaker_inputs(9, KK=4, MM=3)
    t = jnp.float32(5.0)
    fails = np.zeros((4, 3), np.int32)
    open_until = np.full((4, 3), 9.0, np.float32)        # all open
    active = np.array([True, False, True])
    only = np.array([False, True, False])
    choice = np.array([0, 2, 1, 0], np.int32)
    jbrk = jb.BreakerState(jnp.asarray(fails), jnp.asarray(open_until))
    tbrk = tb.BreakerState(T(fails), T(open_until))
    mask = np.ones(4, bool)
    want = jb.breaker_veto(jnp.asarray(choice), jbrk, t, jnp.asarray(x["w"]),
                           jnp.asarray(active), jnp.asarray(x["g"]),
                           jnp.asarray(mask))
    got = tb.breaker_veto(T(choice), tbrk, 5.0, T(x["w"]), T(active),
                          T(x["g"]), T(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert active[got.numpy()].all()                    # fail-open
    for act in (active, only):
        open_now = np.asarray(jb.breaker_is_open(jbrk, t))
        want = jb.retry_pick(jnp.asarray(x["w"]), jnp.asarray(act),
                             jnp.asarray(choice), jnp.asarray(open_now),
                             jnp.asarray(x["g"]))
        got = tb.retry_pick(T(x["w"]), T(act), T(choice), T(open_now),
                            T(x["g"]))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() == 1).all()                     # the only active arm
    for timeout, tau in ((0.09, 0.15), (0.2, 0.08)):
        assert tb.censored_latency(timeout, tau) == \
            jb.censored_latency(timeout, tau)


# ---------------------------------------------------------------------------
# Whole runs against the reference.
# ---------------------------------------------------------------------------

def inputs(scenario="retry_storm", topo=1, key=5, tau=bsuite.DEGRADE_TAU):
    jcfg = js.SimConfig(tau=tau, **SMALL)
    sc = jlib.get_library(HORIZON, K, M)[scenario]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jdrv = jscn.compile_scenario(sc, jcfg, jax.random.PRNGKey(600))
    rtt = jtopo.make_topology(jax.random.PRNGKey(topo), K, M).lb_instance_rtt()
    return jcfg, jdrv, rtt, jax.random.PRNGKey(key)


def run_pair(name, knobs, kw):
    jcfg, jdrv, rtt, key = inputs()
    jcfg = dataclasses.replace(jcfg, **knobs)
    tcfg = ts.SimConfig(tau=jcfg.tau, **SMALL, **knobs)
    want = js.run_sim_stream(name, rtt, jcfg, key, drivers=jdrv,
                             warmup_steps=WARM, **kw)
    got = ts.run_sim_stream(
        name, np.asarray(rtt), tcfg,
        convert.key_to_torch(np.asarray(key), "cpu"),
        drivers=convert.drivers_to_torch(jax.tree.map(np.asarray, jdrv),
                                         "cpu"),
        warmup_steps=WARM, device="cpu", **kw)
    return want, got


def assert_run_matches(want, got, steps):
    for f in want.acc._fields:
        a, b = np.asarray(getattr(want.acc, f)), getattr(got.acc, f).numpy()
        assert a.shape == b.shape, f
        if f in FLOATS:
            np.testing.assert_allclose(b, a, rtol=1e-6,
                                       atol=steps * M * EPS32, err_msg=f)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)
    for f in ("succ", "issued", "attempts"):
        np.testing.assert_array_equal(getattr(got.series, f).numpy(),
                                      np.asarray(getattr(want.series, f)),
                                      err_msg=f)
    np.testing.assert_allclose(got.series.regret.numpy(),
                               np.asarray(want.series.regret), rtol=1e-6,
                               atol=K * M * EPS32)


RUNS = [(label, "qedgeproxy", {}) for label, _ in bsuite.DEGRADE_POLICIES] \
    + [("bounded", "proxy_mity", dict(alpha=0.9)),
       ("bounded", "dec_sarsa", {})]


@pytest.mark.parametrize("label,name,kw", RUNS,
                         ids=[f"{label}-{name}" for label, name, _ in RUNS])
def test_policy_runs_match_the_reference(label, name, kw):
    knobs = dict(bsuite.DEGRADE_POLICIES)[label]
    assert dict(tsuite.DEGRADE_POLICIES)[label] == knobs
    want, got = run_pair(name, knobs, kw)
    assert_run_matches(want, got, int(HORIZON / 0.1))
    stats = tm.resilience_stats_stream(got.acc)
    if knobs:
        # the lifecycle is exercised: timeouts and retries happen
        assert stats["timeouts"] > 0 and stats["retries"] > 0, stats
    if knobs.get("breaker_threshold"):
        assert got.acc.open_km.sum() > 0
    if not knobs.get("retry_deadline", True):
        assert stats["drops"] == 0           # naive retries run to the end


def test_unreachable_timeout_is_the_neutral_run():
    """The resilient round scan with a timeout no attempt reaches equals
    the neutral run on the fused round, every field bit for bit; the
    neutral config is the default one."""
    _, jdrv, rtt, key = inputs()
    drv = convert.drivers_to_torch(jax.tree.map(np.asarray, jdrv), "cpu")
    tkey = convert.key_to_torch(np.asarray(key), "cpu")
    base = ts.SimConfig(tau=bsuite.DEGRADE_TAU, **SMALL)
    assert base == dataclasses.replace(base, attempt_timeout=0.0,
                                       max_retries=0, breaker_threshold=0)
    assert not base.resilience_on
    outs = [ts.run_sim_stream("qedgeproxy", np.asarray(rtt), cfg, tkey,
                              drivers=drv, warmup_steps=WARM, device="cpu")
            for cfg in (base, dataclasses.replace(base, attempt_timeout=1e6,
                                                  max_retries=2))]
    for part in ("acc", "series"):
        for f in getattr(outs[0], part)._fields:
            assert torch.equal(getattr(getattr(outs[0], part), f),
                               getattr(getattr(outs[1], part), f)), (part, f)
    with pytest.raises(ValueError, match="attempt_timeout"):
        ts.run_sim_stream("qedgeproxy", np.asarray(rtt),
                          dataclasses.replace(base, max_retries=1), tkey,
                          device="cpu")


def test_resilient_lanes_equal_single_runs_and_trace():
    """Three scenarios as the lanes of one resilient run, each lane equal
    to its run alone; the trace readout equals the stream's."""
    cfg = ts.SimConfig(tau=bsuite.DEGRADE_TAU, **SMALL, **BOUNDED)
    lib = tlib.get_library(HORIZON, K, M)
    names = ("retry_storm", "metastable_overload", "cascade_failure")
    drivers = [tscn.compile_scenario(lib[n], cfg, 600 + i, device="cpu")
               for i, n in enumerate(names)]
    rtts = torch.stack([ttopo.make_topology(s, K, M, device="cpu")
                        .lb_instance_rtt() for s in (1, 2, 3)])
    keys = torch.stack([prand.prng_key(11 + s) for s in range(3)])
    out = ts.run_sim_grid("qedgeproxy", rtts, cfg, keys,
                          drivers=tscn.stack_drivers(drivers),
                          warmup_steps=WARM, device="cpu")
    for s in range(3):
        one = ts.run_sim_stream("qedgeproxy", rtts[s], cfg, keys[s],
                                drivers=drivers[s], warmup_steps=WARM,
                                device="cpu")
        ln = tm.lane(out, s)
        for part in ("acc", "series"):
            for f in getattr(one, part)._fields:
                assert torch.equal(getattr(getattr(ln, part), f),
                                   getattr(getattr(one, part), f)), \
                    (s, part, f)
    assert out.acc.timeout_k.sum() > 0
    trace = ts.run_sim("qedgeproxy", rtts[0], cfg, keys[0],
                       drivers=drivers[0], device="cpu")
    stream = ts.run_sim_stream("qedgeproxy", rtts[0], cfg, keys[0],
                               drivers=drivers[0], warmup_steps=WARM,
                               device="cpu")
    assert tm.resilience_stats(trace, WARM) == \
        tm.resilience_stats_stream(stream.acc)
    assert trace.attempts.sum() > trace.issued.sum()
