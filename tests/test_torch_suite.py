"""The port's evaluation suite (``repro_torch.bench.figures``) and
metric readouts against the JAX package's harness.

* Tier 3 (figure statistics over seeds), at the reference harness's
  smoke config (24 s, 8 s warm-up, seeds 1-2), all four strategies:
  the port's Fig 3 clients >= rho (each seed), Fig 4 Jain (each seed)
  and Fig 8 max p90 (seed 1, as the figure reads it) lie within the
  JAX lanes' spread over the seeds (max - min), widened by one client's
  share (100/120 %) for Fig 3, by 0.01 for Jain, and by one bin of the
  latency sketch (its bins are ~9.5 % apart: 10 % of the value) for
  Fig 8. The JAX lanes run the harness's program (``build_sim_fn``,
  streaming, the compiled ``baseline`` scenario) one seed at a time.
* The CLI, ``python -m repro_torch.bench.figures --smoke --device
  cpu``, prints the payloads of the reference's figure functions, key
  for key, run here on the JAX lanes: Figs 3-9, the regret curve, and
  Figs 10-11 (the surge and removal events as the two lanes of one run
  per strategy, smoke's first two strategies). The events' proxy-mity
  payload equals the reference's exactly (its runs are exact);
  ``qedgeproxy``'s QoS ratios agree within ``EVENT_QOS_TOL`` (the KDE
  ``mu`` drift of ROADMAP queue C moves a few picks).
* The suite's drivers, compiled by the port's ``compile_scenario``,
  equal the reference's compiled ``baseline`` scenario, and its configs
  the reference harness's; each strategy's seeds run as the lanes of
  one run.
* Trace against stream inside the port: every readout of the
  accumulator agrees with its trace-mode counterpart (counts exact,
  float sums to float32 tolerance, the latency sketch within its bin
  spacing), as ``tests/test_streaming.py`` checks the reference.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from benchmarks import common as bcommon
from benchmarks import figures as bfigures
from repro.continuum import Scenario, compile_scenario
from repro.continuum import metrics as jm
from repro.continuum import simulator as js
from repro.continuum import topology as jtopo
from repro_torch import convert
from repro_torch.bench import figures as tf
from repro_torch.continuum import metrics as tm
from repro_torch.continuum import scenarios as tscn
from repro_torch.continuum import simulator as ts
from repro_torch.continuum import topology as ttopo

ROOT = Path(__file__).resolve().parents[1]
SMOKE = tf.configure(smoke=True)
FIGS = ("fig3_qos_success", "fig4_fairness", "fig5_per_client",
        "fig6_rolling_qos", "fig7_request_distribution", "fig8_p90_latency",
        "fig9_single_lb", "regret_curve")
EVENT_FIGS = ("fig10_client_surge", "fig11_instance_removal")
EVENT_QOS_TOL = 0.01


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors: one intra-op thread is faster than many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_suite():
    """{(seed, label): StreamOutputs, ("topo", seed): Topology}, the
    reference harness's lanes at its smoke config."""
    cfg = js.SimConfig(horizon=SMOKE.cfg.horizon)
    scn = Scenario("baseline", n_nodes=tf.N_LBS, n_instances=tf.N_INSTANCES)
    suite = {}
    for seed in SMOKE.seeds:
        suite[("topo", seed)] = jtopo.make_topology(
            jax.random.PRNGKey(seed), tf.N_LBS, tf.N_INSTANCES)
    for label, kw in bcommon.STRATEGIES:
        run = jax.jit(js.build_sim_fn(
            bcommon.strategy_name(label), cfg, tf.N_LBS, tf.N_INSTANCES,
            trace=False, warmup_steps=SMOKE.warm, **kw))
        for seed in SMOKE.seeds:
            drv = compile_scenario(scn, cfg, jax.random.PRNGKey(seed))
            suite[(seed, label)] = run(
                suite[("topo", seed)].lb_instance_rtt(), drv,
                jax.random.PRNGKey(100 + seed))
    return cfg, suite


@pytest.fixture(scope="module")
def ref_payloads(jax_suite):
    """The reference's figure functions, run on the JAX lanes."""
    cfg, suite = jax_suite
    got = {}
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(bcommon, "CFG", cfg)
        mp.setattr(bcommon, "WARM", SMOKE.warm)
        mp.setattr(bcommon, "SCENARIOS", SMOKE.seeds)
        mp.setattr(bfigures, "get_suite", lambda: suite)
        mp.setattr(bfigures, "emit",
                   lambda name, us, derived, payload=None:
                   got.__setitem__(name, payload))
        for name in FIGS:
            getattr(bfigures, name)()
    finally:
        mp.undo()
    return got


@pytest.fixture(scope="module")
def ref_event_payloads(jax_suite):
    """The reference's Figs 10-11 on the JAX lanes, at its smoke config
    (both events as lanes of one vmapped run per strategy)."""
    cfg, suite = jax_suite
    got = {}
    mp = pytest.MonkeyPatch()
    bfigures._event_cache.clear()
    try:
        mp.setattr(bcommon, "CFG", cfg)
        mp.setattr(bcommon, "WARM", SMOKE.warm)
        mp.setattr(bcommon, "SMOKE", True)
        mp.setattr(bfigures, "get_suite", lambda: suite)
        mp.setattr(bfigures, "emit",
                   lambda name, us, derived, payload=None:
                   got.__setitem__(name, payload))
        for name in EVENT_FIGS:
            getattr(bfigures, name)()
    finally:
        mp.undo()
        bfigures._event_cache.clear()
    return got


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """``python -m repro_torch.bench.figures --smoke --device cpu``:
    the printed payloads by figure, and the ``--out`` directory."""
    out = tmp_path_factory.mktemp("figures")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.bench.figures", "--smoke",
         "--device", "cpu", "--out", str(out)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    printed = {}
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            payload = json.loads(line)
            printed[payload["provenance"]["benchmark"]] = payload
    return printed, out, proc.stdout


def test_configs_match_the_reference_harness(monkeypatch):
    for name in ("SMOKE", "CFG", "WARM", "SCENARIOS"):
        monkeypatch.setattr(bcommon, name, getattr(bcommon, name))
    for smoke in (True, False):
        bcommon.configure(smoke=smoke)
        conf = tf.configure(smoke)
        assert conf.cfg.horizon == bcommon.CFG.horizon
        assert conf.warm == bcommon.WARM
        assert conf.seeds == tuple(bcommon.SCENARIOS)
    assert [label for label, _ in tf.STRATEGIES] == \
        [label for label, _ in bcommon.STRATEGIES]
    assert [kw for _, kw in tf.STRATEGIES] == \
        [kw for _, kw in bcommon.STRATEGIES]


@pytest.mark.parametrize("seed", [1, 2])
def test_suite_drivers_are_the_baseline_scenario(seed):
    cfg = js.SimConfig(horizon=SMOKE.cfg.horizon)
    want = compile_scenario(
        Scenario("baseline", n_nodes=tf.N_LBS, n_instances=tf.N_INSTANCES),
        cfg, jax.random.PRNGKey(seed))
    want = convert.drivers_to_torch(jax.tree.map(np.asarray, want), "cpu")
    got = tscn.compile_scenario(
        tscn.Scenario("baseline", n_nodes=tf.N_LBS,
                      n_instances=tf.N_INSTANCES),
        SMOKE.cfg, seed, device="cpu")
    for f in want._fields:
        a, b = getattr(want, f), getattr(got, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    # the baseline scenario is the constant fill
    neutral = tscn.neutral_drivers(SMOKE.cfg, tf.N_LBS, tf.N_INSTANCES,
                                   device="cpu")
    for f in want._fields:
        assert torch.equal(getattr(neutral, f), getattr(got, f)), f


def test_cli_prints_the_reference_payloads(cli, ref_payloads):
    printed, out, stdout = cli
    for name in FIGS:
        want, got = ref_payloads[name], printed[name]
        prov = got.pop("provenance")
        assert prov["device"] == "cpu" and prov["smoke"] is True
        assert list(got) == list(want), name
        for label in want:
            assert list(got[label]) == list(want[label]), (name, label)
            for k, v in want[label].items():
                assert np.shape(got[label][k]) == np.shape(v), (name, k)
        saved = json.loads((out / f"{name}.json").read_text())
        assert saved == dict(got, provenance=prov)
    assert len(stdout.splitlines()) == len(printed) == \
        len(FIGS) + len(EVENT_FIGS) + 1


def test_tier3_figure_statistics_within_the_seed_spread(cli, jax_suite):
    printed, _, _ = cli
    cfg, suite = jax_suite
    lo_hi = lambda v, pad: (min(v) - pad, max(v) + pad)  # noqa: E731
    for label, _ in tf.STRATEGIES:
        accs = [suite[(s, label)].acc for s in SMOKE.seeds]
        sat = [jm.client_qos_satisfaction_stream(a, cfg.rho) for a in accs]
        jain = [jm.jain_fairness_stream(a) for a in accs]
        p90 = [1e3 * jm.proc_latency_quantile_stream(a, 0.9).max()
               for a in accs]
        lo, hi = lo_hi(sat, 100.0 / 120)
        for v in printed["fig3_qos_success"][label]["per_scenario"]:
            assert lo <= v <= hi, (label, "fig3", v, sat)
        lo, hi = lo_hi(jain, 0.01)
        for v in printed["fig4_fairness"][label]["per_scenario"]:
            assert lo <= v <= hi, (label, "fig4", v, jain)
        v = printed["fig8_p90_latency"][label]["max_ms"]
        assert 0.9 * min(p90) <= v <= 1.1 * max(p90), (label, "fig8", v, p90)
    fig3 = printed["fig3_qos_success"]
    assert min(fig3["qedgeproxy"]["per_scenario"]) >= 90.0
    for label in ("proxy_mity_1.0", "proxy_mity_0.9", "dec_sarsa"):
        assert fig3["qedgeproxy"]["mean"] > fig3[label]["mean"], label


def test_figs_10_and_11_match_the_reference(cli, ref_event_payloads):
    printed, _, _ = cli
    for name in EVENT_FIGS:
        want, got = ref_event_payloads[name], dict(printed[name])
        got.pop("provenance")
        assert list(got) == list(want) == ["qedgeproxy", "proxy_mity_1.0"]
        for label in want:
            assert list(got[label]) == list(want[label]), (name, label)
            assert list(got[label]["acc_window"]) == \
                list(want[label]["acc_window"])
        # proxy-mity's runs are exact: so is its payload
        assert got["proxy_mity_1.0"] == want["proxy_mity_1.0"], name
        a, b = want["qedgeproxy"], got["qedgeproxy"]
        for key in ("pre", "dip", "post_steady"):
            assert abs(a[key] - b[key]) <= EVENT_QOS_TOL, (name, key)
        for key in ("pre", "dip", "steady"):
            assert abs(a["acc_window"][key] - b["acc_window"][key]) \
                <= EVENT_QOS_TOL, (name, key)
        # the paper's claim at this horizon: QoS holds through the event
        assert b["post_steady"] >= 0.95, name


def test_cli_prints_figs_10_and_11(cli):
    printed, out, _ = cli
    for name in EVENT_FIGS:
        payload = printed[name]
        assert payload["provenance"]["benchmark"] == name
        saved = json.loads((out / f"{name}.json").read_text())
        assert saved == payload
        for label in ("qedgeproxy", "proxy_mity_1.0"):
            cell = payload[label]
            assert 0.0 <= cell["post_steady"] <= 1.0
            assert cell["acc_window"]["recovered"] in (True, False)
    assert printed["suite_build"]["qedgeproxy"]["scenarios"] == 2


def test_suite_lanes_record_their_runs():
    suite = tf.get_suite("cpu", seeds=(3, 4), horizon=1.5)
    assert suite.device == "cpu" and suite.config.warm == 5
    T = suite.config.cfg.num_steps
    for label, _ in tf.STRATEGIES:
        timing = suite.timings[label]
        assert timing["seconds"] > 0 and timing["lanes"] == 2
        assert timing["grid_steps_per_s"] == pytest.approx(
            2 * T / timing["seconds"])
        # the CPU runs the plain versions: no kernel launches
        assert set(timing["launches"].values()) == {0}
        for seed in (3, 4):
            assert suite.runs[(seed, label)].series.succ.shape == (T,)
    topo = ttopo.make_topology(3, 30, 10, device="cpu")
    assert torch.equal(suite.topos[3].rtt, topo.rtt)
    # each seed's lane equals the seed run alone
    alone = ts.run_sim_stream("qedgeproxy", suite.topos[4].lb_instance_rtt(),
                              suite.config.cfg, 104,
                              warmup_steps=suite.config.warm, device="cpu")
    for f in alone.acc._fields:
        assert torch.equal(getattr(alone.acc, f),
                           getattr(suite.runs[(4, "qedgeproxy")].acc, f)), f


# ---------------------------------------------------------------------------
# Trace against stream, inside the port.
# ---------------------------------------------------------------------------

CFG = ts.SimConfig(horizon=15.0)
WARM = 50
WIN = int(CFG.window / CFG.dt)


@pytest.fixture(scope="module", params=[("qedgeproxy", {}),
                                        ("proxy_mity", dict(alpha=0.9)),
                                        ("dec_sarsa", {})],
                ids=["qedgeproxy", "proxy_mity", "dec_sarsa"])
def both(request):
    name, kw = request.param
    rtt = ttopo.make_topology(2, 8, 4, device="cpu").lb_instance_rtt()
    trace = ts.run_sim(name, rtt, CFG, 5, device="cpu", **kw)
    stream = ts.run_sim_stream(name, rtt, CFG, 5, warmup_steps=WARM,
                               device="cpu", **kw)
    return trace, stream


def test_trace_readouts_match_the_stream(both):
    trace, stream = both
    acc, K, M = stream.acc, 8, 4
    want, want_present = tm.per_client_success(trace, WARM)
    got, got_present = tm.per_client_success_stream(acc)
    np.testing.assert_array_equal(got_present, want_present)
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert tm.client_qos_satisfaction_stream(acc, CFG.rho) == \
        tm.client_qos_satisfaction(trace, CFG.rho, WARM)
    np.testing.assert_array_equal(acc.arrivals_m.numpy(),
                                  trace.arrivals.numpy()[WARM:].sum(0))
    assert tm.jain_fairness_stream(acc) == pytest.approx(
        tm.jain_fairness(trace, warmup_steps=WARM), rel=1e-6)
    np.testing.assert_allclose(tm.request_rate_per_instance_stream(acc, CFG.dt),
                               tm.request_rate_per_instance(trace, CFG.dt,
                                                            WARM), rtol=1e-6)
    for lb in range(K):
        np.testing.assert_array_equal(
            tm.per_lb_request_distribution_stream(acc, lb),
            tm.per_lb_request_distribution(trace, lb, WARM))
    np.testing.assert_allclose(tm.rolling_qos_series(stream.series, WIN),
                               tm.rolling_qos(trace, WIN), atol=1e-6)
    want = tm.cumulative_regret(trace)
    np.testing.assert_allclose(tm.cumulative_regret_series(stream.series),
                               want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tm.variation_budget_stream(acc),
                               tm.variation_budget_emp(trace),
                               rtol=1e-4, atol=1e-5)
    p90 = tm.p90_proc_latency(trace, WARM)
    sketch = tm.proc_latency_quantile_stream(acc, 0.9)
    present = acc.arrivals_m.numpy() > 0
    np.testing.assert_allclose(sketch[present], p90[present], rtol=0.15)
    assert (sketch[~present] == 0).all() and M == len(sketch)
    assert float(acc.steps_measured) == CFG.num_steps - WARM


def test_readouts_match_the_reference_readouts(both):
    """Each port readout equals the reference's, on the same numbers."""
    trace, stream = both
    jtrace = js.SimOutputs(*(x.numpy() for x in trace))
    jacc = jm.MetricAccumulator(*(x.numpy() for x in stream.acc))
    jseries = jm.StepSeries(*(x.numpy() for x in stream.series))
    for fn, args in (("per_client_success", (WARM,)),
                     ("client_qos_satisfaction", (CFG.rho, WARM)),
                     ("jain_fairness", (None, WARM)),
                     ("rolling_qos", (WIN,)), ("per_lb_rolling_qos", (WIN,)),
                     ("request_rate_per_instance", (CFG.dt, WARM)),
                     ("p90_proc_latency", (WARM,)),
                     ("per_lb_request_distribution", (3, WARM)),
                     ("cumulative_regret", ()), ("variation_budget_emp", ())):
        want = getattr(jm, fn)(jtrace, *args)
        got = getattr(tm, fn)(trace, *args)
        pairs = zip(want, got) if isinstance(want, tuple) else [(want, got)]
        for a, b in pairs:
            np.testing.assert_array_equal(b, a, err_msg=fn)
    for fn, args in (("per_lb_request_distribution_stream", (3,)),
                     ("variation_budget_stream", ())):
        np.testing.assert_array_equal(getattr(tm, fn)(stream.acc, *args),
                                      getattr(jm, fn)(jacc, *args))
    np.testing.assert_array_equal(tm.cumulative_regret_series(stream.series),
                                  jm.cumulative_regret_series(jseries))
