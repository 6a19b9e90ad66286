"""The port's multi-tenant engine against the JAX package's, live JAX
calls on the CPU, at the reference test's sizes (K=10 x M=4, a 12 s
horizon, warm-up 30, ``TenancyConfig(taus=(tau, 0.150),
interference=0.3)``, topology key 2, run key 5).

* ``TenancyConfig`` validates as the reference's; a degenerate one-tenant
  config is the ``tenancy=None`` run bit for bit, and one that disagrees
  with the scalar tau or service row is refused.
* ``tenant_drivers``, ``broadcast_tenants`` and the four compiled
  ``get_tenant_library`` scenarios equal the reference's array for array.
* Whole tenant runs of ``qedgeproxy``, ``proxy_mity(alpha=0.9)`` and
  ``dec_sarsa``, with ``fused`` on (batched rings, subset maintenance)
  and off (per-round feedback, masked full-width maintenance): every
  count of every tenant's accumulator and every (T, NT) series but
  regret exactly equal; the true ``mu`` of the last step within 2
  float32 eps, the float sums of it (regret, the variation budget)
  within ``rtol=1e-6`` plus ``M * eps32`` a term. No pick moved at
  this size (``test_torch_tenant_lane.py`` shows where picks move and
  why).
* Every refusal the reference makes, with its type.
* The fairness indices against the reference on seeded vectors, and the
  ``jain_index`` deviation on vectors whose squares underflow.
"""
import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.continuum import library as jlib
from repro.continuum import metrics as jm
from repro.continuum import scenarios as jscn
from repro.continuum import simulator as js
from repro.continuum import tenancy as jt
from repro.continuum import topology as jtopo
from repro_torch import convert
from repro_torch.continuum import library as tlib
from repro_torch.continuum import metrics as tm
from repro_torch.continuum import scenarios as tscn
from repro_torch.continuum import simulator as ts
from repro_torch.continuum import tenancy as tt
from repro_torch.continuum.control import ControlConfig
from repro_torch.core.bandit import BanditParams
from repro_torch.obs import RecorderConfig

EPS32 = float(np.finfo(np.float32).eps)
K, M, WARM, HORIZON = 10, 4, 30, 12.0
STEPS = int(HORIZON / 0.1)
TAUS = (0.080, 0.150)
TN2 = dict(taus=TAUS, interference=0.3)
FLOATS = ("regret_k", "vb_k", "prev_mu")
STRATEGIES = {"qedgeproxy": {}, "proxy_mity": dict(alpha=0.9),
              "dec_sarsa": {}}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors: one intra-op thread is faster than many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(**tn):
    tn = {**TN2, **tn}
    return (js.SimConfig(horizon=HORIZON, tenancy=jt.TenancyConfig(**tn)),
            ts.SimConfig(horizon=HORIZON, tenancy=tt.TenancyConfig(**tn)))


def inputs():
    rtt = jtopo.make_topology(jax.random.PRNGKey(2), K, M).lb_instance_rtt()
    return rtt, jax.random.PRNGKey(5)


def to_torch(jdrv):
    return convert.drivers_to_torch(jax.tree.map(np.asarray, jdrv), "cpu")


def port_inputs():
    rtt, key = inputs()
    return torch.tensor(np.asarray(rtt)), convert.key_to_torch(
        np.asarray(key), "cpu")


def assert_tenant_runs_match(want, got, NT=2):
    assert isinstance(got.acc, tuple) and len(got.acc) == NT
    for s in range(NT):
        for f in want.acc[s]._fields:
            a = np.asarray(getattr(want.acc[s], f))
            b = getattr(got.acc[s], f).numpy()
            assert a.shape == b.shape, (s, f)
            if f == "prev_mu":
                np.testing.assert_allclose(b, a, rtol=0, atol=2 * EPS32,
                                           err_msg=f"tenant {s} {f}")
            elif f in FLOATS:
                np.testing.assert_allclose(b, a, rtol=1e-6,
                                           atol=STEPS * M * EPS32,
                                           err_msg=f"tenant {s} {f}")
            else:
                np.testing.assert_array_equal(b, a, err_msg=f"tenant {s} {f}")
    for f in ("succ", "issued", "attempts"):
        a = np.asarray(getattr(want.series, f))
        assert a.shape == (STEPS, NT)
        np.testing.assert_array_equal(getattr(got.series, f).numpy(), a,
                                      err_msg=f)
    np.testing.assert_allclose(got.series.regret.numpy(),
                               np.asarray(want.series.regret), rtol=1e-6,
                               atol=K * M * EPS32)


# ---------------------------------------------------------------------------
# Config and the degenerate one-tenant path.
# ---------------------------------------------------------------------------

def test_tenancy_config_validation():
    for mod in (jt, tt):
        assert mod.TenancyConfig(taus=(0.08,)).S == 1
        assert not mod.TenancyConfig(taus=(0.08,)).enabled
        assert mod.TenancyConfig(taus=(0.08, 0.15)).enabled
        assert mod.TenancyConfig(taus=(0.08, 0.15)).scales == (1.0, 1.0)
    for args, match in ((dict(taus=()), "at least one"),
                        (dict(taus=(0.08, -0.1)), "positive"),
                        (dict(taus=(0.08, 0.15), service_scale=(1.0,)),
                         "service_scale"),
                        (dict(taus=(0.08, 0.15), service_scale=(1.0, 0.0)),
                         "positive"),
                        (dict(taus=(0.08,), interference=-0.5),
                         "interference")):
        with pytest.raises(ValueError, match=match):
            tt.TenancyConfig(**args)
    base = ts.SimConfig(horizon=HORIZON)
    assert not base.tenancy_on
    assert not dataclasses.replace(
        base, tenancy=tt.TenancyConfig(taus=(base.tau,))).tenancy_on
    assert configs()[1].tenancy_on
    assert tt.tenancy_size(configs()[1]) == 2 and tt.tenancy_size(base) == 0


def test_degenerate_config_is_the_single_service_run():
    """A one-tenant config stays on the single-service path: the run
    equals ``tenancy=None`` bit for bit (one accumulator, (T,) series),
    whole and chunked; one that disagrees with the scalar tau or the
    unscaled service row is refused."""
    rtt, key = port_inputs()
    base = ts.SimConfig(horizon=2.0)
    deg = dataclasses.replace(base, tenancy=tt.TenancyConfig(taus=(base.tau,)))
    for chunk in (None, 10):
        a = ts.run_sim_stream("qedgeproxy", rtt, base, key, warmup_steps=5,
                              chunk_steps=chunk, device="cpu")
        b = ts.run_sim_stream("qedgeproxy", rtt, deg, key, warmup_steps=5,
                              chunk_steps=chunk, device="cpu")
        assert isinstance(b.acc, tm.MetricAccumulator)
        assert b.series.succ.dim() == 1
        for part in ("acc", "series"):
            for f in getattr(a, part)._fields:
                assert torch.equal(getattr(getattr(a, part), f),
                                   getattr(getattr(b, part), f)), (part, f)
    for tn in (tt.TenancyConfig(taus=(0.999,)),
               tt.TenancyConfig(taus=(base.tau,), service_scale=(2.0,))):
        with pytest.raises(ValueError, match="S=1 TenancyConfig"):
            ts.build_sim_parts("qedgeproxy",
                               dataclasses.replace(base, tenancy=tn), K, M,
                               trace=False)


# ---------------------------------------------------------------------------
# Drivers and the tenant library.
# ---------------------------------------------------------------------------

def test_tenant_drivers_match_the_reference():
    """The merge rules (stack the schedules, AND the liveness, the worst
    RTT and service rows, the union of marks) and the broadcast, array
    for array; a merge that kills the fleet and a broadcast of tenant
    drivers are refused."""
    jcfg, tcfg = configs()
    lib = jlib.get_library(HORIZON, K, M, base_clients=1)
    names = ("cascade_failure", "surge", "partition_heal")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jparts = [jscn.compile_scenario(lib[n], jcfg,
                                        jax.random.PRNGKey(30 + i))
                  for i, n in enumerate(names)]
    want = jscn.tenant_drivers(jparts)
    got = tscn.tenant_drivers([to_torch(d) for d in jparts])
    assert got.n_clients.shape == (STEPS, 3, K)
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    base = tscn.neutral_drivers(tcfg, K, M, base_clients=1, device="cpu")
    b = tscn.broadcast_tenants(base, 3)
    jb = jscn.broadcast_tenants(jscn.neutral_drivers(jcfg, K, M,
                                                     base_clients=1), 3)
    np.testing.assert_array_equal(b.n_clients.numpy(),
                                  np.asarray(jb.n_clients))
    with pytest.raises(ValueError, match="tenant"):
        tscn.broadcast_tenants(b, 2)
    dead = base._replace(active=torch.zeros_like(base.active))
    with pytest.raises(ValueError, match="no instance"):
        tscn.tenant_drivers([base, dead])
    with pytest.raises(ValueError, match="one .T, K. n_clients"):
        tscn.tenant_drivers([base, b])
    neutral = tscn.tenant_neutral_drivers(tcfg, 2, K, M, device="cpu")
    jneutral = jscn.tenant_neutral_drivers(jcfg, 2, K, M)
    for f in jneutral._fields:
        np.testing.assert_array_equal(getattr(neutral, f).numpy(),
                                      np.asarray(getattr(jneutral, f)))


@pytest.mark.parametrize("n_tenants", [2, 4])
def test_tenant_library_compiles_as_the_reference(n_tenants):
    jcfg, tcfg = configs()
    jl = jlib.get_tenant_library(HORIZON, K, M, n_tenants=n_tenants)
    tl = tlib.get_tenant_library(HORIZON, K, M, n_tenants=n_tenants)
    assert list(tl) == list(jl) == ["mt_baseline", "mt_tenant_surge",
                                    "mt_noisy_neighbor",
                                    "mt_priority_inversion"]
    for i, name in enumerate(jl):
        assert tl[name].description == jl[name].description
        want = jscn.compile_tenant_scenario(jl[name], jcfg,
                                            jax.random.PRNGKey(800 + i))
        got = tscn.compile_tenant_scenario(tl[name], tcfg, 800 + i,
                                           device="cpu")
        assert got.n_clients.shape == (STEPS, n_tenants, K), name
        for f in want._fields:
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f"{name}.{f}")
    with pytest.raises(ValueError, match="tenants"):
        tlib.get_tenant_library(HORIZON, K, M, n_tenants=1)


# ---------------------------------------------------------------------------
# Whole runs against the reference.
# ---------------------------------------------------------------------------

RUNS = [(name, fused) for name in STRATEGIES for fused in (True, False)]


@pytest.mark.parametrize("name,fused", RUNS,
                         ids=[f"{n}-{'fused' if f else 'perround'}"
                              for n, f in RUNS])
def test_tenant_runs_match_the_reference(name, fused):
    jcfg, tcfg = configs()
    rtt, key = inputs()
    # tenant 1 twice tenant 0's clients, on a noisy-neighbour timeline
    lib = jlib.get_tenant_library(HORIZON, K, M, n_tenants=2,
                                  base_clients=2)
    jdrv = jscn.compile_tenant_scenario(lib["mt_noisy_neighbor"], jcfg,
                                        jax.random.PRNGKey(3))
    want = js.run_sim_stream(name, rtt, jcfg, key, drivers=jdrv,
                             warmup_steps=WARM, fused=fused,
                             **STRATEGIES[name])
    rtt_t, key_t = port_inputs()
    got = ts.run_sim_stream(name, rtt_t, tcfg, key_t, drivers=to_torch(jdrv),
                            warmup_steps=WARM, fused=fused, device="cpu",
                            **STRATEGIES[name])
    assert_tenant_runs_match(want, got)
    assert all(float(a.n_kc.sum()) > 0 for a in got.acc)


# ---------------------------------------------------------------------------
# Refusals.
# ---------------------------------------------------------------------------

def test_tenant_refusals():
    _, cfg = configs()
    rtt, key = port_inputs()
    with pytest.raises(ValueError, match="streaming-only"):
        ts.build_sim_fn("qedgeproxy", cfg, K, M, trace=True)
    with pytest.raises(ValueError, match="streaming-only"):
        ts.run_sim("qedgeproxy", rtt, cfg, key, device="cpu")
    for change, match in (
            (dict(attempt_timeout=0.09, max_retries=2), "resilience"),
            (dict(control=ControlConfig(admit=True)), "control"),
            (dict(recorder=RecorderConfig(capacity=64)), "recorder")):
        with pytest.raises(ValueError, match=match):
            ts.build_sim_fn("qedgeproxy", dataclasses.replace(cfg, **change),
                            K, M, trace=False)
    with pytest.raises(ValueError, match="params"):
        ts.build_sim_fn("qedgeproxy", cfg, K, M, trace=False,
                        params=BanditParams(tau=cfg.tau))
    with pytest.raises(ValueError, match="multiple"):
        ts.build_sim_parts("qedgeproxy", cfg, K, M, trace=False,
                           pshard=ts.PlayerSharding(None, K + 1))
    # tenant configs need tenant-axis drivers, whole and chunked
    single = tscn.neutral_drivers(cfg, K, M, device="cpu")
    for chunk in (None, 40):
        with pytest.raises(ValueError, match="tenant"):
            ts.run_sim_stream("qedgeproxy", rtt, cfg, key, drivers=single,
                              chunk_steps=chunk, device="cpu")


# ---------------------------------------------------------------------------
# Fairness indices.
# ---------------------------------------------------------------------------

def test_fairness_indices_match_the_reference():
    rng = np.random.default_rng(0)
    vectors = [np.zeros(0), np.zeros(4), np.full(5, 3.7), np.eye(6)[0]]
    for i in range(60):
        n = int(rng.integers(1, 40))
        x = (rng.uniform(0.0, 100.0, n), rng.exponential(5.0, n),
             np.where(rng.uniform(size=n) < 0.5, 0.0,
                      rng.uniform(0.0, 10.0, n)))[i % 3]
        vectors.append(x)
    for x in vectors:
        assert tm.gini_index(x) == jm.gini_index(x)
        assert tm.herfindahl_index(x) == jm.herfindahl_index(x)
        # scaled by the maximum first: a few ULP from the reference
        assert tm.jain_index(x) == pytest.approx(jm.jain_index(x),
                                                 rel=1e-14, abs=0)


@pytest.mark.parametrize("x", [[5e-324], [1e-310, 1e-310], [1e-310, 0.0],
                               [3e-200, 1e-200, 2e-200]],
                         ids=["denormal", "two-denormals", "one-hot-denormal",
                              "tiny"])
def test_jain_index_does_not_underflow(x):
    """The reference's unscaled squares flush to 0 on these vectors and
    leave [1/n, 1]; the port's stay inside and equal the index of the
    same vector scaled up."""
    x = np.asarray(x, np.float64)
    n = x.size
    got = tm.jain_index(x)
    assert 1.0 / n - 1e-12 <= got <= 1.0 + 1e-12
    assert got == pytest.approx(tm.jain_index(x / x.max()), rel=1e-12)
    ref = jm.jain_index(x)
    if x[0] < 1e-300:
        assert not (1.0 / n - 1e-9 <= ref <= 1.0 + 1e-9)
