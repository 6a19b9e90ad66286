"""The suite's ``multi_tenant`` lane against the JAX package's on the
CPU, and where and why the two packages' picks part at its size.

* ``repro_torch.bench.scenarios`` has the reference lane's constants;
  at a 3 s horizon on the lane's 30 x 10 fleet with 4 tenants every
  cell of both policies equals the reference's (the Jain indices to
  1e-14: the port scales by the maximum first), and the payload has
  the reference's keys.
* At the lane's full 24 s the port's picks equal the reference's:
  step by step no state parts (the plain maintenance's KDE ``mu``,
  which used to part by one ULP, now rounds as XLA:CPU does), and the
  reference's maintenance statistics injected change nothing.

Script mode compares the lane's smoke payload of both packages::

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/test_torch_tenant_suite.py [--horizon 24] [--inject]

and prints, per scenario and policy, both packages' cells (the counts
no pick decides, ``tenant_requests``, exact; the ratios and indices as
measured) and the routing counts' L1 distance per tenant; ``--inject``
runs the port on the reference's maintenance statistics. Either way
every count is exact.
"""
import argparse
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import scenario_suite as bsuite
from repro.continuum import library as jlib
from repro.continuum import scenarios as jscn
from repro.continuum import simulator as js
from repro.continuum import tenancy as jt
from repro.continuum import topology as jtopo
from repro.kernels import ref as jref
from repro.obs import registry as jreg
from repro_torch import convert
from repro_torch.bench import scenarios as tsuite
from repro_torch.continuum import simulator as ts
from repro_torch.kernels import ops as tops
from repro_torch.obs import registry as treg

COUNTS = ("succ_kc", "n_kc", "arrivals_m", "choice_counts", "proc_hist",
          "steps_measured", "ev_succ", "ev_n", "att_k", "timeout_k",
          "drop_k", "open_km")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors: one intra-op thread is faster than many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def assert_cells_match(want: dict, got: dict):
    assert list(got) == list(want)
    for k, v in want.items():
        if k.startswith("jain_"):
            assert got[k] == pytest.approx(v, rel=1e-14, abs=0), k
        else:
            assert got[k] == v, k


# ---------------------------------------------------------------------------
# The suite's multi_tenant lane.
# ---------------------------------------------------------------------------

def reference_lane(horizon: float) -> dict:
    """The reference's ``get_multi_tenant_suite`` at ``horizon`` (smoke
    scenarios, warm-up the first third): ``{(name, label):
    StreamOutputs}``."""
    from benchmarks import common
    names = ("SMOKE", "CFG", "WARM", "SCENARIOS")
    saved = {n: getattr(common, n) for n in names}
    common.configure(smoke=True)
    common.CFG = js.SimConfig(horizon=horizon)
    common.WARM = int(horizon / 3 / common.CFG.dt)
    try:
        return dict(bsuite.get_multi_tenant_suite())
    finally:
        for n, v in saved.items():
            setattr(common, n, v)
        bsuite._mt_cache.clear()


def compare_lane(horizon: float, inject: bool = False):
    """Both packages' ``multi_tenant`` cells at ``horizon``: one row per
    (scenario, policy) with each package's cell and the routing counts'
    L1 distance per tenant; and the port's suite."""
    want = reference_lane(horizon)
    if inject:
        tops_stats = tops.bandit_maintenance_stats
        tops.bandit_maintenance_stats = reference_maintenance
    try:
        got = tsuite.get_multi_tenant_suite("cpu", smoke=True,
                                            horizon=horizon)
    finally:
        if inject:
            tops.bandit_maintenance_stats = tops_stats
    rho = got["config"].cfg.rho
    rows = []
    for name in got["names"]:
        for label, _ in tsuite.MT_POLICIES:
            w, g = want[(name, label)], got["runs"][(name, label)]
            rows.append(dict(
                scenario=name, policy=label,
                jax=jreg.tenant_cell(w, rho=rho),
                port=treg.tenant_cell(g, rho=rho),
                choice_l1=[float(np.abs(np.asarray(a.choice_counts)
                                        - b.choice_counts.numpy()).sum())
                           for a, b in zip(w.acc, g.acc)]))
    return rows, got


def test_multi_tenant_lane_matches_the_reference():
    for name in ("MT_TENANTS", "MT_TAUS", "MT_INTERFERENCE",
                 "MT_BASE_CLIENTS", "MT_POLICIES", "SMOKE_MT_SCENARIOS"):
        assert getattr(tsuite, name) == getattr(bsuite, name), name
    rows, suite = compare_lane(3.0)
    assert [(r["scenario"], r["policy"]) for r in rows] == [
        (n, p) for n in bsuite.SMOKE_MT_SCENARIOS
        for p, _ in bsuite.MT_POLICIES]
    for r in rows:
        assert r["choice_l1"] == [0.0] * tsuite.MT_TENANTS
        assert_cells_match(r["jax"], r["port"])
    payload = tsuite.multi_tenant(suite)
    assert list(payload) == ["tenants", "taus", "interference",
                             "grid_steps_per_s", *bsuite.SMOKE_MT_SCENARIOS]
    assert set(payload["grid_steps_per_s"]) == {p for p, _ in
                                                tsuite.MT_POLICIES}


# ---------------------------------------------------------------------------
# Where the picks part at the lane's size, and why.
# ---------------------------------------------------------------------------

_JREF_STATS = jax.jit(jref.bandit_maintenance_stats,
                      static_argnums=(3, 4, 5))


def reference_maintenance(lat, mask, rtt, tau, rho, min_bandwidth=1e-4):
    """``kernels.ops.bandit_maintenance_stats`` computed by the JAX
    package's plain version, on the port's tensors."""
    mu, q = _JREF_STATS(lat.numpy(), mask.numpy(), rtt.numpy(), float(tau),
                        float(rho), float(min_bandwidth))
    return (torch.from_numpy(np.array(mu)), torch.from_numpy(np.array(q)))


LANE_HORIZON = 24.0


@functools.cache
def _reference_steps(steps: int):
    """The reference's drivers and its carry after each of the first
    ``steps`` steps of the lane's ``mt_baseline`` run, as numpy."""
    jcfg = js.SimConfig(horizon=LANE_HORIZON, tenancy=jt.TenancyConfig(
        taus=bsuite.MT_TAUS, interference=bsuite.MT_INTERFERENCE))
    lib = jlib.get_tenant_library(LANE_HORIZON, 30, 10, n_tenants=4,
                                  base_clients=1)
    jdrv = jscn.compile_tenant_scenario(lib["mt_baseline"], jcfg,
                                        jax.random.PRNGKey(800))
    rtt = jtopo.make_topology(jax.random.PRNGKey(1), 30, 10).lb_instance_rtt()
    init_fn, step_fn = js.build_sim_parts("qedgeproxy", jcfg, 30, 10,
                                          trace=False, warmup_steps=80)
    carry, keys = init_fn(rtt, jdrv.active[0], jax.random.PRNGKey(11))
    step = jax.jit(lambda c, x: step_fn(rtt, jdrv.marks, c, x))
    out = []
    for i in range(steps):
        carry, _ = step(carry, (jnp.int32(i),
                                *(getattr(jdrv, f)[i]
                                  for f in jscn.STEP_FIELDS),
                                keys[i], carry[4][i % 10]))
        out.append(to_numpy(carry))
    return jdrv, out


def _lane_steps(steps: int) -> list[dict]:
    """The lane's ``mt_baseline`` run (30 x 10, 4 tenants, topology 1,
    compile key 800, run key 11) stepped in both packages: per step, the
    strategy-state fields, the queue and the accumulators' counts that
    differ, with the largest difference (the float sums of the true
    ``mu`` differ by ULPs from the first step and are left out)."""
    jdrv, carries = _reference_steps(steps)
    tcfg = tsuite.mt_config(ts.SimConfig(horizon=LANE_HORIZON))
    tdrv = convert.drivers_to_torch(to_numpy(jdrv), "cpu")
    rtt = jtopo.make_topology(jax.random.PRNGKey(1), 30, 10).lb_instance_rtt()
    trtt = torch.tensor(np.asarray(rtt))
    tkey = convert.key_to_torch(np.asarray(jax.random.PRNGKey(11)), "cpu")
    t_init, t_step = ts.build_sim_parts("qedgeproxy", tcfg, 30, 10,
                                        trace=False, warmup_steps=80)
    tc, tkeys = t_init(trtt, tdrv.active[0], tkey)
    out = []
    for i, want in enumerate(carries):
        tc, _ = t_step(trtt, tdrv.marks, tc,
                       (i, *(getattr(tdrv, f)[i] for f in jscn.STEP_FIELDS),
                        tkeys[i], tc[4][i % 10]), False)
        got = convert.carry_to_numpy(tc)
        diff = {}
        for s in range(4):
            for f in want[0][s]._fields:
                a, b = np.asarray(getattr(want[0][s], f)), getattr(got[0][s], f)
                if not np.array_equal(a, b):
                    diff[f] = max(diff.get(f, 0.0), float(np.abs(
                        a.astype(np.float64) - b).max()))
            for f in COUNTS:
                if not np.array_equal(getattr(want[3][s], f),
                                      getattr(got[3][s], f)):
                    diff[f] = 1.0
        if not np.array_equal(want[1], got[1]):
            diff["queue"] = 1.0
        out.append(diff)
    return out


def test_the_lanes_drift_starts_in_maintenance_mu(monkeypatch):
    """At the lane's size no state parts from the reference's over the
    first steps: the tenants' maintenance ``mu_hat`` (where the drift
    used to start, by one float32 ULP), the SWRR weights and credits,
    the queues and every count are equal step by step, and running the
    port on the reference's maintenance statistics changes nothing. The
    script mode shows every count exact over the lane's 24 s."""
    own = _lane_steps(5)
    assert not any(own), own
    monkeypatch.setattr(tops, "bandit_maintenance_stats",
                        reference_maintenance)
    injected = _lane_steps(5)
    assert injected == own


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--horizon", type=float, default=24.0)
    ap.add_argument("--inject", action="store_true",
                    help="run the port on the reference's maintenance "
                         "statistics")
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    for r in compare_lane(args.horizon, inject=args.inject)[0]:
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
