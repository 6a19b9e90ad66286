"""Tenant runs as lanes, and the registry's tenant cells, against the
JAX package on the CPU.

* Two tenant scenarios as the lanes of one run: each lane bit for bit
  its run alone, and equal to the reference's grid (counts exact, the
  true ``mu`` within 2 float32 eps, its sums within ``rtol=1e-6`` plus
  ``M * eps32`` a term). ``collect_tenants`` and ``tenant_cell`` of
  each lane equal the reference's (the Jain indices to 1e-14: the port
  scales by the maximum first).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.continuum import library as jlib
from repro.continuum import scenarios as jscn
from repro.continuum import simulator as js
from repro.continuum import tenancy as jt
from repro.continuum import topology as jtopo
from repro.obs import registry as jreg
from repro_torch import convert
from repro_torch.continuum import metrics as tm
from repro_torch.continuum import scenarios as tscn
from repro_torch.continuum import simulator as ts
from repro_torch.continuum import tenancy as tt
from repro_torch.obs import registry as treg

EPS32 = float(np.finfo(np.float32).eps)
K, M, WARM, HORIZON = 10, 4, 30, 12.0
STEPS = int(HORIZON / 0.1)
TN2 = dict(taus=(0.080, 0.150), interference=0.3)
FLOATS = ("regret_k", "vb_k", "prev_mu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors: one intra-op thread is faster than many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(horizon=HORIZON, **tn):
    tn = {**TN2, **tn}
    return (js.SimConfig(horizon=horizon, tenancy=jt.TenancyConfig(**tn)),
            ts.SimConfig(horizon=horizon, tenancy=tt.TenancyConfig(**tn)))


def to_torch(tree):
    return jax.tree.map(np.asarray, tree)


def port_inputs(topo=2, key=5, K=K, M=M):
    rtt = jtopo.make_topology(jax.random.PRNGKey(topo), K, M).lb_instance_rtt()
    return (torch.tensor(np.asarray(rtt)),
            convert.key_to_torch(np.asarray(jax.random.PRNGKey(key)), "cpu"))


def assert_equal_runs(a, b):
    for s, (x, y) in enumerate(zip(a.acc, b.acc)):
        for f in x._fields:
            assert torch.equal(getattr(x, f), getattr(y, f)), (s, f)
    for f in a.series._fields:
        assert torch.equal(getattr(a.series, f), getattr(b.series, f)), f


def assert_accs_match(want, got):
    for s, (a_acc, b_acc) in enumerate(zip(want, got)):
        for f in a_acc._fields:
            a = np.asarray(getattr(a_acc, f))
            b = getattr(b_acc, f).numpy()
            if f == "prev_mu":
                np.testing.assert_allclose(b, a, rtol=0, atol=2 * EPS32,
                                           err_msg=f"tenant {s} {f}")
            elif f in FLOATS:
                np.testing.assert_allclose(b, a, rtol=1e-6,
                                           atol=STEPS * M * EPS32,
                                           err_msg=f"tenant {s} {f}")
            else:
                np.testing.assert_array_equal(b, a, err_msg=f"tenant {s} {f}")


def assert_cells_match(want: dict, got: dict):
    assert list(got) == list(want)
    for k, v in want.items():
        if k.startswith("jain_"):
            assert got[k] == pytest.approx(v, rel=1e-14, abs=0), k
        else:
            assert got[k] == v, k


# ---------------------------------------------------------------------------
# Lanes against runs alone and against the reference's grid.
# ---------------------------------------------------------------------------

LANES = ("mt_tenant_surge", "mt_noisy_neighbor")


def test_tenant_lanes_equal_runs_alone_and_the_reference_grid():
    jcfg, tcfg = configs()
    lib = jlib.get_tenant_library(HORIZON, K, M, n_tenants=2,
                                  base_clients=2)
    jdrv = jscn.stack_drivers([jscn.compile_tenant_scenario(
        lib[n], jcfg, jax.random.PRNGKey(800 + i))
        for i, n in enumerate(LANES)])
    rtts = jnp.stack([jtopo.make_topology(jax.random.PRNGKey(s), K, M)
                      .lb_instance_rtt() for s in (1, 2)])
    jkeys = jnp.stack([jax.random.PRNGKey(20 + s) for s in range(2)])
    want = js.run_sim_grid("qedgeproxy", rtts, jcfg, jkeys, drivers=jdrv,
                           warmup_steps=WARM)
    drv = convert.drivers_to_torch(to_torch(jdrv), "cpu")
    trtts = torch.tensor(np.asarray(rtts))
    tkeys = convert.key_to_torch(np.asarray(jkeys), "cpu")
    got = ts.run_sim_grid("qedgeproxy", trtts, tcfg, tkeys, drivers=drv,
                          warmup_steps=WARM, device="cpu")
    assert tuple(got.series.succ.shape) == (2, STEPS, 2)
    for s in range(2):
        ln = tm.lane(got, s)
        alone = ts.run_sim_stream(
            "qedgeproxy", trtts[s], tcfg, tkeys[s],
            drivers=tscn.Drivers(*(x[s] for x in drv)), warmup_steps=WARM,
            device="cpu")
        assert_equal_runs(alone, ln)
        wl = jax.tree.map(lambda x: x[s], want)
        assert_accs_match(wl.acc, ln.acc)
        for f in ("succ", "issued", "attempts"):
            np.testing.assert_array_equal(getattr(ln.series, f).numpy(),
                                          np.asarray(getattr(wl.series, f)))
        rho = tcfg.rho
        assert_cells_match(jreg.tenant_cell(wl, rho=rho),
                           treg.tenant_cell(ln, rho=rho))
        jms = jreg.collect_tenants(wl, rho=rho).to_json()
        tms = treg.collect_tenants(ln, rho=rho).to_json()
        def schema(doc):
            return [(m["name"], m["kind"], m.get("help"), m.get("labels"))
                    for m in doc["metrics"]]

        assert schema(tms) == schema(jms)
        for a, b in zip(jms["metrics"], tms["metrics"]):
            assert b["value"] == pytest.approx(a["value"], rel=1e-14,
                                               abs=0), a["name"]
    with pytest.raises(TypeError, match="tenant run"):
        treg.collect_tenants(ts.run_sim_stream(
            "proxy_mity", trtts[0], ts.SimConfig(horizon=0.5), tkeys[0],
            device="cpu"), rho=0.9)
