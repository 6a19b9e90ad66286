"""The port's scenario compiler, library and event readouts against the
JAX package's (live JAX calls on the CPU).

* ``prand.choice`` equals ``jax.random.choice(replace=False)``.
* ``compile_scenario`` on the same key equals the reference's compile
  field by field and dtype by dtype, exactly: every scenario of
  ``get_library`` at a short horizon at 30 x 10 and at 37 x 13, the two
  legacy events of Figs 10-11, and a ``with_standby`` fleet; the
  dead-fleet and non-positive-scale errors, the overlapping-partition
  and MAX_MARKS warnings fire as in the reference, with its messages.
* ``stack_drivers`` and ``convert.drivers_to_torch`` of a stacked JAX
  batch agree.
* ``event_windows_from_series`` and ``event_recovery`` equal the
  reference's readouts on the same windows, NaN cases included.
* The scenario suite's cell (``bench.scenarios.stream_cell``) equals the
  reference's ``obs.registry.stream_cell`` on the reference's lanes, a
  degenerate event included, and ``get_scenario_suite`` /
  ``scenario_rows`` give the reference's rows for ``proxy_mity_1.0``.
* The graceful-degradation and closed-loop lanes: their constants are
  the reference's; ``graceful_degradation`` / ``closed_loop`` of
  converted reference runs equal the reference's ``stream_cell`` with
  the switches ``benchmarks/scenario_suite.py`` gives each policy (the
  breakers' open share within float32 reassociation), and their key
  sets are the committed reference payload's.
"""
import dataclasses
import json
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import figures as bfigures
from benchmarks import scenario_suite as bsuite
from repro.continuum import library as jlib
from repro.continuum import metrics as jm
from repro.continuum import scenarios as jscn
from repro.continuum import simulator as js
from repro.continuum import topology as jtopo
from repro.obs import registry as jregistry
from repro_torch import convert
from repro_torch.bench import figures as tfigures
from repro_torch.bench import scenarios as tsuite
from repro_torch.continuum import library as tlib
from repro_torch.continuum import metrics as tm
from repro_torch.continuum import scenarios as tscn
from repro_torch.continuum import simulator as ts
from repro_torch.core import prand

SHAPES = ((3.0, 30, 10), (6.0, 37, 13))
NAMES = list(jlib.get_library(3.0))


def tkey(seed):
    return convert.key_to_torch(np.asarray(jax.random.PRNGKey(seed)), "cpu")


def assert_same_drivers(want, got, what):
    assert type(got) is tscn.Drivers and got._fields == want._fields
    for f in want._fields:
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (what, f)
        np.testing.assert_array_equal(b, a, err_msg=f"{what}: {f}")


def compile_both(jscn_obj, tscn_obj, horizon, seed):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jscn.compile_scenario(jscn_obj, js.SimConfig(horizon=horizon),
                                     jax.random.PRNGKey(seed))
        got = tscn.compile_scenario(tscn_obj, ts.SimConfig(horizon=horizon),
                                    tkey(seed), device="cpu")
    return want, got


# ---------------------------------------------------------------------------
# Randomness.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [10, 30])
def test_choice_is_jax_choice_without_replacement(n):
    for seed in range(6):
        for count in (1, n // 3, n // 2, n):
            want = jax.random.choice(jax.random.PRNGKey(seed), n, (count,),
                                     replace=False)
            got = prand.choice(tkey(seed), n, count)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    keys = torch.stack([tkey(s) for s in range(4)])
    batch = prand.choice(keys, n, 5)
    for s in range(4):
        assert torch.equal(batch[s], prand.choice(keys[s], n, 5))
    with pytest.raises(ValueError, match="without replacement"):
        prand.choice(tkey(0), n, n + 1)


# ---------------------------------------------------------------------------
# The compiler.
# ---------------------------------------------------------------------------

def test_library_names_and_specs_match_the_reference():
    for horizon, K, M in SHAPES:
        want = jlib.get_library(horizon, K, M)
        got = tlib.get_library(horizon, K, M)
        assert list(got) == list(want)
        for name in want:
            a, b = want[name], got[name]
            assert (a.name, a.n_nodes, a.n_instances, a.base_clients) == \
                (b.name, b.n_nodes, b.n_instances, b.base_clients)
            assert [type(e).__name__ for e in a.events] == \
                [type(e).__name__ for e in b.events], name
            for ea, eb in zip(a.events, b.events):
                assert dataclasses.asdict(ea) == dataclasses.asdict(eb), name
    assert tlib._frac(10, 1 / 3) == jlib._frac(10, 1 / 3)


@pytest.mark.parametrize("shape", SHAPES, ids=["30x10", "37x13"])
@pytest.mark.parametrize("name", NAMES)
def test_compile_scenario_matches_the_reference(name, shape):
    horizon, K, M = shape
    i = NAMES.index(name)
    want, got = compile_both(jlib.get_library(horizon, K, M)[name],
                             tlib.get_library(horizon, K, M)[name], horizon,
                             500 + i)
    assert_same_drivers(want, got, name)


@pytest.mark.parametrize("event", [0, 1], ids=["surge", "removal"])
def test_legacy_event_scenarios_match_the_reference(event):
    horizon = 24.0
    want_scn = bfigures.legacy_event_scenarios(js.SimConfig(horizon=horizon))
    got_scn = tfigures.legacy_event_scenarios(ts.SimConfig(horizon=horizon))
    assert got_scn[event].events[0] == type(got_scn[event].events[0])(
        **dataclasses.asdict(want_scn[event].events[0]))
    want, got = compile_both(want_scn[event], got_scn[event], horizon, 0)
    assert_same_drivers(want, got, want_scn[event].name)
    assert tfigures.SURGE_LBS == bfigures.SURGE_LBS


def test_with_standby_matches_the_reference():
    base_j = jlib.get_library(3.0)["cascade_failure"]
    base_t = tlib.get_library(3.0)["cascade_failure"]
    want_scn, got_scn = jscn.with_standby(base_j, 4), tscn.with_standby(base_t,
                                                                        4)
    assert (got_scn.n_instances, got_scn.description) == \
        (want_scn.n_instances, want_scn.description)
    assert tscn.with_standby(base_t, 0) == base_t
    with pytest.raises(ValueError, match=">= 0"):
        tscn.with_standby(base_t, -1)
    want, got = compile_both(want_scn, got_scn, 3.0, 9)
    assert_same_drivers(want, got, "with_standby")


def _raised(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def test_compiler_errors_match_the_reference():
    dead = dict(events=(), n_nodes=6, n_instances=3)
    cases = (
        ("dead", lambda m: (m.InstanceKill(start=0.5, instances=(0, 1, 2)),)),
        ("negative", lambda m: (m.RttDrift(start=0.2, stop=1.0,
                                           factor=-1.0),)),
        ("bad_dir", lambda m: (m.Autoscale(start=0.2, instances=(0,),
                                           direction="sideways"),)),
    )
    for name, events in cases:
        msgs = []
        for mod, cfg, key in ((jscn, js.SimConfig(horizon=2.0),
                               jax.random.PRNGKey(1)),
                              (tscn, ts.SimConfig(horizon=2.0), tkey(1))):
            scn = mod.Scenario(name, **dict(dead, events=events(mod)))
            kw = {} if mod is jscn else {"device": "cpu"}
            msgs.append(_raised(lambda: mod.compile_scenario(scn, cfg, key,
                                                             **kw)))
        assert msgs[1] == msgs[0], name


def _warned(mod, scn, cfg, key, **kw) -> list[str]:
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        drv = mod.compile_scenario(scn, cfg, key, **kw)
    return [str(w.message) for w in caught], drv


@pytest.mark.parametrize("case", ["partitions", "max_marks"])
def test_compiler_warnings_match_the_reference(case):
    got = []
    for mod, cfg, key, kw in ((jscn, js.SimConfig(horizon=4.0),
                               jax.random.PRNGKey(2), {}),
                              (tscn, ts.SimConfig(horizon=4.0), tkey(2),
                               {"device": "cpu"})):
        if case == "partitions":
            events = (mod.Partition(start=0.5, stop=2.0, lbs=(0, 1),
                                    instances=(0,)),
                      mod.Partition(start=1.5, stop=3.0, lbs=(2,),
                                    instances=(1,)))
            scn = mod.Scenario("cross", events, n_nodes=5, n_instances=4)
        else:                      # 40 onsets: more than MAX_MARKS
            scn = mod.Scenario("many", tuple(
                mod.InstanceKill(start=0.05 + 0.09 * i, stop=0.1 + 0.09 * i,
                                 instances=(i % 3,)) for i in range(40)),
                n_nodes=4, n_instances=5)
        got.append(_warned(mod, scn, cfg, key, **kw))
    (want_msgs, want), (got_msgs, drv) = got
    assert len(want_msgs) == 1 and got_msgs == want_msgs
    assert_same_drivers(want, drv, case)


def test_stack_drivers_and_batched_conversion():
    cfg_j, cfg_t = js.SimConfig(horizon=2.0), ts.SimConfig(horizon=2.0)
    names = ("surge", "cascade_failure", "churn")
    lib_j, lib_t = jlib.get_library(2.0), tlib.get_library(2.0)
    want = jscn.stack_drivers([jscn.compile_scenario(
        lib_j[n], cfg_j, jax.random.PRNGKey(i)) for i, n in enumerate(names)])
    got = tscn.stack_drivers([tscn.compile_scenario(
        lib_t[n], cfg_t, i, device="cpu") for i, n in enumerate(names)])
    assert_same_drivers(want, got, "stack")
    conv = convert.drivers_to_torch(jax.tree.map(np.asarray, want), "cpu")
    assert_same_drivers(want, conv, "convert")
    keys = np.stack([np.asarray(jax.random.PRNGKey(s)) for s in (3, 4, 5)])
    back = convert.key_to_torch(keys, "cpu")
    assert back.shape == (3, 2)
    assert torch.equal(back, torch.stack([prand.prng_key(s) for s in (3, 4,
                                                                      5)]))


def test_scenario_suite_constants_match_the_reference():
    assert tsuite.SMOKE_SCENARIOS == bsuite.SMOKE_SCENARIOS
    assert tsuite.SUITE_STRATEGIES == bsuite.SUITE_STRATEGIES
    for name in ("DEGRADE_SCENARIOS", "SMOKE_DEGRADE_SCENARIOS",
                 "DEGRADE_POLICIES", "DEGRADE_TAU", "CONTROL_SCENARIOS",
                 "SMOKE_CONTROL_SCENARIOS", "CONTROL_STANDBY", "CONTROL_RES"):
        assert getattr(tsuite, name) == getattr(bsuite, name), name
    assert [label for label, _ in tsuite.CONTROL_POLICIES] == \
        [label for label, _ in bsuite.CONTROL_POLICIES]
    for (_, a), (_, b) in zip(tsuite.CONTROL_POLICIES,
                              bsuite.CONTROL_POLICIES):
        assert (a is None and b is None) or \
            dataclasses.asdict(a) == dataclasses.asdict(b)


# ---------------------------------------------------------------------------
# The readouts.
# ---------------------------------------------------------------------------

def _series(T, seed):
    rng = np.random.default_rng(seed)
    issued = rng.integers(0, 40, T).astype(np.float32)
    succ = np.floor(issued * rng.uniform(0.3, 1.0, T)).astype(np.float32)
    return succ, issued


@pytest.mark.parametrize("marks", [[5, 40, -1, -1], [0, 79, 60, -1],
                                   [-1, -1, -1, -1]])
def test_event_windows_from_series_match_the_reference(marks):
    succ, issued = _series(80, len(marks) + marks[0])
    m = np.asarray(marks, np.int32)
    want = jm.event_windows_from_series(succ, issued, m, 10, 4, 6)
    got = tm.event_windows_from_series(torch.from_numpy(succ),
                                       torch.from_numpy(issued),
                                       torch.from_numpy(m), 10, 4, 6)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)


def _windows():
    """(ev_succ, ev_n) rows: a dip and recovery, a ramped dip buckets
    after onset, a recovery that never comes, no post data with a pre
    window, an all-miss tail (steady 0), no data at all (sentinel),
    post data without a pre window (NaN pre)."""
    B = 6
    s = np.zeros((7, 1 + B))
    n = np.zeros((7, 1 + B))
    n[0], s[0] = 100, [99, 60, 80, 95, 97, 98, 98]
    n[1], s[1] = 100, [100, 100, 90, 40, 70, 99, 100]
    n[2], s[2] = 100, [100, 99, 90, 80, 70, 60, 50]
    n[3, 0], s[3, 0] = 50, 45
    n[4], s[4] = 100, [100, 80, 20, 0, 0, 0, 0]
    n[6, 1:], s[6, 1:] = 10, [5, 8, 9, 9, 10, 10]
    n[0, 4] = 0                       # a bucket without data mid-window
    s[0, 4] = 0
    return s.astype(np.float32), n.astype(np.float32)


def _same_records(want, got):
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert list(a) == list(b)
        for k in a:
            if isinstance(a[k], float) and math.isnan(a[k]):
                assert math.isnan(b[k]), k
            else:
                assert a[k] == b[k] and type(a[k]) is type(b[k]), (k, a, b)


@pytest.mark.parametrize("threshold", [0.95, 0.8])
def test_event_recovery_matches_the_reference(threshold):
    s, n = _windows()
    want = jm.event_recovery((s, n), 2.0, threshold)
    got = tm.event_recovery((torch.from_numpy(s), torch.from_numpy(n)), 2.0,
                            threshold)
    _same_records(want, got)
    assert len(got) == 6                          # the sentinel row skipped
    # still degrading at the window's edge, unless the bar is low
    assert (got[2]["recovery_s"] is None) == (threshold == 0.95)
    assert math.isnan(got[3]["dip"]) and got[3]["recovery_s"] is None
    assert got[4]["recovered"] is False           # all-miss tail
    assert math.isnan(got[5]["pre"])
    # through an accumulator, as the suites read it
    acc_j = jm.init_accumulator(2, 2, 2, n_marks=7, ev_buckets=6)._replace(
        ev_succ=s, ev_n=n)
    acc_t = tm.init_accumulator(2, 2, 2, n_marks=7, ev_buckets=6,
                                device="cpu")._replace(
        ev_succ=torch.from_numpy(s), ev_n=torch.from_numpy(n))
    _same_records(jm.event_recovery(acc_j, 2.0, threshold),
                  tm.event_recovery(acc_t, 2.0, threshold))


# ---------------------------------------------------------------------------
# The scenario suite's cells.
# ---------------------------------------------------------------------------

def _reference_cells(label, scenarios, cfg, warm):
    """``registry.stream_cell(..., jain=True, n_events=True)`` of each lane
    of the reference's grid over ``scenarios``, laid out as the suite
    lays its lanes (topology 1, compile keys 500 + i, run key 11), with
    each lane's run."""
    K, M = tfigures.N_LBS, tfigures.N_INSTANCES
    drv = jscn.stack_drivers([jscn.compile_scenario(
        scn, cfg, jax.random.PRNGKey(500 + i))
        for i, scn in enumerate(scenarios)])
    rtt = jtopo.make_topology(jax.random.PRNGKey(1), K, M).lb_instance_rtt()
    S = len(scenarios)
    rtts = jnp.broadcast_to(rtt[None], (S, K, M))
    keys = jnp.broadcast_to(jax.random.PRNGKey(11)[None], (S, 2))
    name = "qedgeproxy" if label == "qedgeproxy" else "proxy_mity"
    kw = dict(bsuite.SUITE_STRATEGIES)[label]
    out = js.run_sim_grid(name, rtts, cfg, keys, drivers=drv,
                          warmup_steps=warm, **kw)
    runs = [jax.tree.map(lambda x, i=i: np.asarray(x[i]), out)
            for i in range(S)]
    return [jregistry.stream_cell(o, rho=cfg.rho, bucket_s=cfg.ev_bucket,
                                  jain=True, n_events=True) for o in runs], \
        runs


def test_stream_cell_matches_the_registry():
    """The port's cell on each lane's accumulator equals the reference's
    ``obs.registry.stream_cell``: QoS, Jain, the event count and the
    recovery summary, with a degenerate event (every client gone after
    it: no data-bearing post bucket, so unrecovered and no dip)."""
    cfg = js.SimConfig(horizon=6.0)
    lib = jlib.get_library(cfg.horizon, tfigures.N_LBS, tfigures.N_INSTANCES)
    quiet = jscn.Scenario("quiet", (jscn.LoadSurge(
        start=4.0, extra=-cfg.max_clients, fraction=1.0),))
    want, runs = _reference_cells(
        "qedgeproxy", [lib["surge"], lib["cascade_failure"], quiet], cfg, 20)
    for w, o in zip(want, runs):
        got = tsuite.stream_cell(
            tm.StreamOutputs(acc=convert.accumulator_to_torch(o.acc, "cpu"),
                             series=None), cfg.rho, cfg.ev_bucket)
        assert got == w
    assert want[2] == {"qos_sat_pct": want[2]["qos_sat_pct"],
                       "jain": want[2]["jain"], "events": 1,
                       "unrecovered_events": 1}
    assert want[1]["events"] == 3 and "worst_dip" in want[1]


def test_scenario_suite_rows_match_the_reference():
    """``get_scenario_suite`` + ``scenario_rows`` at the smoke scenarios
    on a short horizon: ``proxy_mity_1.0``'s rows (no maintenance, so no
    drift) equal the reference's cells on its grid over the same lanes;
    ``qedgeproxy``'s rows are ``stream_cell`` of each lane's run, with
    the reference's event counts. Each strategy is one run of S lanes."""
    suite = tsuite.get_scenario_suite(device="cpu", smoke=True, horizon=3.0)
    assert suite["names"] == list(bsuite.SMOKE_SCENARIOS)
    conf = suite["config"]
    rows = tsuite.scenario_rows(suite)
    assert list(rows) == suite["names"]
    cfg = js.SimConfig(horizon=conf.cfg.horizon)
    lib = jlib.get_library(cfg.horizon, tfigures.N_LBS, tfigures.N_INSTANCES)
    scns = [lib[n] for n in suite["names"]]
    want, _ = _reference_cells("proxy_mity_1.0", scns, cfg, conf.warm)
    for name, w in zip(suite["names"], want):
        assert rows[name]["proxy_mity_1.0"] == w, name
    want_q, _ = _reference_cells("qedgeproxy", scns, cfg, conf.warm)
    for name, w in zip(suite["names"], want_q):
        cell = rows[name]["qedgeproxy"]
        assert cell == tsuite.stream_cell(suite["runs"][(name, "qedgeproxy")],
                                          cfg.rho, cfg.ev_bucket)
        assert set(cell) == set(w) and cell["events"] == w["events"], name
    for label, _ in tsuite.SUITE_STRATEGIES:
        timing = suite["timings"][label]
        assert timing["lanes"] == len(suite["names"])
        assert timing["grid_steps_per_s"] > 0


# ---------------------------------------------------------------------------
# The graceful-degradation and closed-loop lanes.
# ---------------------------------------------------------------------------

PAYLOAD = "results/benchmarks/scenario_suite.json"
# recovery keys that appear only where an event recovered in the horizon
RECOVERY_KEYS = {"max_recovery_s"}


def _lane_run(knobs, control, standby, key):
    """One reference ``retry_storm`` run at 6 x 4 (+ standby), 3 s."""
    K, M = 6, 4
    cfg = js.SimConfig(horizon=3.0, max_clients=4, ring=16, **knobs,
                       control=control)
    scn = jlib.get_library(cfg.horizon, K, M)["retry_storm"]
    if standby:
        scn = jscn.with_standby(scn, standby)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        drv = jscn.compile_scenario(scn, cfg, jax.random.PRNGKey(key))
    rtt = jtopo.make_topology(jax.random.PRNGKey(1), K,
                              M + standby).lb_instance_rtt()
    out = js.run_sim_stream("qedgeproxy", rtt, cfg, jax.random.PRNGKey(11),
                            drivers=drv, warmup_steps=10)
    return cfg, jax.tree.map(np.asarray, out)


def _port_run(out):
    ctrl = None if out.ctrl is None else convert.control_to_torch(out.ctrl,
                                                                  "cpu")
    return tm.StreamOutputs(acc=convert.accumulator_to_torch(out.acc, "cpu"),
                            series=None, ctrl=ctrl)


def _assert_cells(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if k == "breaker_open_frac":
            assert got[k] == pytest.approx(w, rel=1e-6, abs=1e-9)
        else:
            assert got[k] == w, k


def test_degradation_and_closed_loop_cells_match_the_registry():
    payload = json.load(open(PAYLOAD))
    cfg, deg = _lane_run(dict(bsuite.DEGRADE_POLICIES)["bounded"], None, 0,
                         600)
    assert float(deg.acc.open_km.sum()) > 0
    conf = tfigures.SuiteConfig(ts.SimConfig(horizon=cfg.horizon), 10, (1,),
                                True)
    suite = {"names": ["retry_storm"], "config": conf,
             "runs": {("retry_storm", label): _port_run(deg)
                      for label, _ in tsuite.DEGRADE_POLICIES}}
    rows = tsuite.graceful_degradation(suite)["retry_storm"]
    ref_rows = payload["graceful_degradation"]["retry_storm"]
    for label, knobs in bsuite.DEGRADE_POLICIES:
        want = jregistry.stream_cell(
            deg, rho=cfg.rho, bucket_s=cfg.ev_bucket, resilience=True,
            breaker_frac=bool(knobs.get("breaker_threshold")),
            max_recovery=False)
        _assert_cells(rows[label], want)
        assert set(rows[label]) == set(ref_rows[label]), label

    ctl = dict(bsuite.CONTROL_POLICIES)["autoscale_admit"]
    cfg, cl = _lane_run(bsuite.CONTROL_RES, ctl, bsuite.CONTROL_STANDBY, 700)
    _, pre = _lane_run(bsuite.CONTROL_RES, None, bsuite.CONTROL_STANDBY, 700)
    assert float(cl.ctrl.admit_frac_sum) < float(cl.ctrl.steps)   # it acted
    runs = {("retry_storm", label): _port_run(pre if c is None else cl)
            for label, c in tsuite.CONTROL_POLICIES}
    rows = tsuite.closed_loop(dict(suite, runs=runs))["retry_storm"]
    ref_rows = payload["closed_loop"]["retry_storm"]
    for label, c in bsuite.CONTROL_POLICIES:
        want = jregistry.stream_cell(
            pre if c is None else cl, rho=cfg.rho, bucket_s=cfg.ev_bucket,
            jain=True, tenants=True, drop_rate=True, control=True)
        _assert_cells(rows[label], want)
        assert set(rows[label]) - RECOVERY_KEYS == \
            set(ref_rows[label]) - RECOVERY_KEYS, label

