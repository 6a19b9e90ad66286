"""The port's telemetry export against the JAX package's, live JAX calls
on the CPU: the registry's documents, ``collect_stream`` and
``stream_cell`` on a run of each package, the Chrome trace, provenance,
run directories, the ``python -m repro_torch.obs`` CLI and the router's
trace.

* Metric validation, the JSON round trip of NaN and inf and the
  Prometheus format, as the reference's tests hold them.
* ``collect_stream`` on the port's run of the ``retry_storm`` lifecycle
  config (the size at which ``test_torch_obs_recorder.py`` holds every
  count and event exact) against the reference's on the JAX run: the
  same names, labels and kinds; equal values but for the float sums of
  the true ``mu`` (regret), which hold ``rtol=1e-6``.
* The reference's ``validate_metrics_json``, ``validate_prometheus``
  and ``validate_chrome_trace`` accept the port's documents, and the
  recorder's trace events are the reference's.
* ``config_hash`` of the port's ``SimConfig`` (control and recorder
  configs included) equals the reference's for equal settings; no
  field differs. The provenance block's fields differ by design (torch,
  CUDA and the device in place of jax), so the reference's
  ``validate_artifact`` refuses the port's block and the port's accepts
  it.
* A run directory is written, loaded, validated and rendered; the CLI's
  ``smoke`` and ``report`` run on the CPU.
* ``QEdgeRouter.export_trace`` writes the reference's document for the
  same membership log, timestamps aside.
"""
import contextlib
import dataclasses
import io
import json
import math
import os
import warnings

import jax
import numpy as np
import pytest
import torch

from benchmarks import scenario_suite as bsuite
from repro.continuum import control as jc
from repro.continuum import library as jlib
from repro.continuum import scenarios as jscn
from repro.continuum import simulator as js
from repro.continuum import topology as jtopo
from repro.obs import provenance as jprov
from repro.obs import recorder as jrec
from repro.obs import registry as jreg
from repro.obs import trace as jtrace
from repro.serving.router import QEdgeRouter as JRouter
from repro_torch import convert
from repro_torch.continuum import control as tc
from repro_torch.continuum import simulator as ts
from repro_torch.obs import __main__ as cli
from repro_torch.obs import provenance, registry, report, runlog, trace
from repro_torch.obs.recorder import RecorderConfig
from repro_torch.obs.registry import Metric, MetricSet
from repro_torch.serving.router import QEdgeRouter

K, M, C, R, H, WARM = 6, 4, 4, 16, 5.0, 10
KNOBS = dict(bsuite.DEGRADE_POLICIES)["bounded"]
EPS32 = float(np.finfo(np.float32).eps)
# the float sums of the true mu: rtol 1e-6 plus M * eps32 a term
REGRET_ATOL = {"repro_regret_total": int(H / 0.1) * K * M * EPS32,
               "repro_step_regret": K * M * EPS32}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors: one intra-op thread is faster than many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def storm_runs():
    """The reference's and the port's run of one storm config."""
    small = dict(max_clients=C, ring=R, horizon=H, tau=bsuite.DEGRADE_TAU,
                 **KNOBS)
    jcfg = js.SimConfig(**small, recorder=jrec.RecorderConfig(capacity=512))
    tcfg = ts.SimConfig(**small, recorder=RecorderConfig(capacity=512))
    sc = jlib.get_library(H, K, M)["retry_storm"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jdrv = jscn.compile_scenario(sc, jcfg, jax.random.PRNGKey(600))
    rtt = jtopo.make_topology(jax.random.PRNGKey(1), K, M).lb_instance_rtt()
    key = jax.random.PRNGKey(5)
    want = js.run_sim_stream("qedgeproxy", rtt, jcfg, key, drivers=jdrv,
                             warmup_steps=WARM)
    got = ts.run_sim_stream(
        "qedgeproxy", np.asarray(rtt), tcfg,
        convert.key_to_torch(np.asarray(key), "cpu"),
        drivers=convert.drivers_to_torch(jax.tree.map(np.asarray, jdrv),
                                         "cpu"),
        warmup_steps=WARM, device="cpu")
    return jcfg, tcfg, want, got


# -- registry -----------------------------------------------------------

def test_metric_validation():
    with pytest.raises(ValueError, match="kind"):
        Metric("x", 1.0, kind="histogram")
    with pytest.raises(ValueError, match="name"):
        Metric("2bad", 1.0)
    with pytest.raises(ValueError, match="label"):
        Metric("ok", 1.0, labels={"bad-label": "v"})
    ms = MetricSet()
    ms.add("repro_x", 1.0, instance="0")
    ms.add("repro_x", 2.0, instance="1")    # same name, new labels: fine
    with pytest.raises(ValueError, match="duplicate"):
        ms.add("repro_x", 3.0, instance="0")
    ms.add("repro_t", torch.tensor([1.0, 2.0]), kind="series")
    assert list(ms)[-1].value == [1.0, 2.0]


@pytest.mark.parametrize("special", [float("nan"), float("inf"),
                                     float("-inf")])
def test_json_round_trip_keeps_non_finite_values(special):
    ms = MetricSet()
    ms.add("repro_a", special, help="a special gauge")
    ms.add("repro_b", 2.5, kind="counter")
    ms.add("repro_s", [1.0, special, 3.0], kind="series")
    doc = ms.to_json()
    # strict JSON: no bare NaN or Infinity tokens
    doc2 = json.loads(json.dumps(doc, allow_nan=False))
    assert registry.validate_metrics_json(doc2) == []
    assert jreg.validate_metrics_json(doc2) == []
    assert doc2 == jreg.metricset_from_json(doc2).to_json()
    vals = {m.name: m for m in registry.metricset_from_json(doc2)}
    same = math.isnan if math.isnan(special) else special.__eq__
    assert same(vals["repro_a"].value) and same(vals["repro_s"].value[1])
    assert vals["repro_b"].value == 2.5 and vals["repro_s"].value[2] == 3.0


def test_prometheus_format_and_validator():
    ms = MetricSet()
    ms.add("repro_qos", 93.5, help="QoS satisfaction")
    ms.add("repro_rate", float("nan"), instance="2")
    ms.add("repro_series", [1, 2], kind="series")
    text = ms.to_prometheus()
    assert registry.validate_prometheus(text) == []
    assert jreg.validate_prometheus(text) == []
    assert "# TYPE repro_qos gauge" in text
    assert 'repro_rate{instance="2"} NaN' in text
    assert "repro_series" not in text       # series have no sample
    assert registry.validate_prometheus("not a metric line\n")
    assert registry.validate_metrics_json({"schema": "other"})


def test_collect_stream_matches_the_reference(storm_runs):
    jcfg, tcfg, want, got = storm_runs
    kw = dict(rho=tcfg.rho, dt=tcfg.dt, bucket_s=tcfg.ev_bucket)
    a, b = jreg.collect_stream(want, **kw), registry.collect_stream(got, **kw)
    assert [(m.name, m.kind, m.labels) for m in a] == \
        [(m.name, m.kind, m.labels) for m in b]
    for x, y in zip(a, b):
        if x.name in REGRET_ATOL:
            np.testing.assert_allclose(y.value, x.value, rtol=1e-6,
                                       atol=REGRET_ATOL[x.name],
                                       err_msg=x.name)
        else:
            np.testing.assert_equal(y.value, x.value, err_msg=x.name)
    names = {m.name for m in b}
    assert {"repro_recorder_events_appended", "repro_step_succ",
            "repro_event_dip"} <= names
    assert b.scalars()["repro_recorder_events_appended"] > 0
    # the reference's validators accept the port's documents
    assert jreg.validate_metrics_json(b.to_json()) == []
    assert jreg.validate_prometheus(b.to_prometheus()) == []


SWITCHES = [dict(jain=True, n_events=True),
            dict(resilience=True, breaker_frac=True, max_recovery=False),
            dict(jain=True, tenants=True, drop_rate=True, control=True)]


@pytest.mark.parametrize("switches", SWITCHES,
                         ids=["open_loop", "degradation", "closed_loop"])
def test_stream_cell_matches_the_reference(storm_runs, switches):
    _, tcfg, want, got = storm_runs
    kw = dict(rho=tcfg.rho, bucket_s=tcfg.ev_bucket, **switches)
    assert registry.stream_cell(got, **kw) == jreg.stream_cell(want, **kw)


def test_recovery_summary_matches_the_reference():
    recs = [dict(dip=0.5, recovered=True, recovery_s=2.0),
            dict(dip=float("nan"), recovered=False, recovery_s=None),
            dict(dip=0.25, recovered=True, recovery_s=6.0)]
    for kw in ({}, dict(max_recovery=False)):
        assert registry.recovery_summary(recs, **kw) == \
            jreg.recovery_summary(recs, **kw)
    assert registry.recovery_summary([]) == {}


# -- trace --------------------------------------------------------------

def test_recorder_trace_and_host_timeline(storm_runs):
    jcfg, tcfg, want, got = storm_runs
    evs = trace.recorder_trace_events(got.rec, tcfg.dt)
    assert evs == jtrace.recorder_trace_events(want.rec, jcfg.dt)
    tl = trace.HostTimeline()
    with tl.span("phase", "test"):
        tl.instant("ping")
    doc = trace.chrome_trace(evs, tl.events, meta={"run": "t"})
    assert trace.validate_chrome_trace(doc) == []
    assert jtrace.validate_chrome_trace(doc) == []
    insts = [e for e in doc["traceEvents"] if e["ph"] == "i"
             and e.get("cat") == "recorder"]
    assert insts, "the storm run records events"
    for e in insts:     # simulated µs: ts / (dt * 1e6) is the step
        assert abs(e["ts"] / (tcfg.dt * 1e6) - e["args"]["step"]) < 1e-6
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert spans and spans[0]["dur"] >= 0
    assert trace.validate_chrome_trace({"traceEvents": [{"ph": "?"}]})


# -- provenance ---------------------------------------------------------

def test_provenance_stamp_and_validate(tmp_path):
    payload = {"cell": {"x": 1.0}}
    provenance.stamp(payload, ts.SimConfig(horizon=6.0),
                     extra={"benchmark": "t"}, device="cpu")
    pv = payload["provenance"]
    assert pv["schema_version"] == provenance.ARTIFACT_SCHEMA_VERSION
    assert pv["benchmark"] == "t" and pv["backend"] == "cpu"
    assert pv["device_name"] == "cpu" and pv["device_count"] == 1
    assert pv["torch_version"] == torch.__version__
    assert len(pv["config_hash"]) == 16
    assert payload["cell"] == {"x": 1.0}     # additive, not an envelope
    p = tmp_path / "t.json"
    p.write_text(json.dumps(payload))
    assert provenance.validate_artifact(str(p)) == []
    # the fields that differ by design: torch, CUDA and the device name
    # in place of jax
    assert jprov.validate_artifact(str(p)) == ["provenance missing "
                                               "'jax_version'"]
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"cell": 1}))
    assert provenance.validate_artifact(str(bad))
    res = provenance.validate_all(str(tmp_path))
    assert res["t.json"] == [] and res["bad.json"]


CTL = dict(managed=2, warmup=0.5, up_queue=2.0, admit=True, regions=2)


def test_config_hash_is_the_references():
    pairs = [(js.SimConfig(horizon=6.0), ts.SimConfig(horizon=6.0)),
             (js.SimConfig(horizon=6.0, **KNOBS,
                           recorder=jrec.RecorderConfig(capacity=64)),
              ts.SimConfig(horizon=6.0, **KNOBS,
                           recorder=RecorderConfig(capacity=64))),
             (js.SimConfig(control=jc.ControlConfig(**CTL)),
              ts.SimConfig(control=tc.ControlConfig(**CTL))),
             ({"a": 1, "b": [1.5, None]}, {"a": 1, "b": [1.5, None]})]
    for j, t in pairs:
        assert provenance.config_hash(t) == jprov.config_hash(j)
    a = provenance.config_hash(ts.SimConfig(horizon=6.0))
    assert a == provenance.config_hash(ts.SimConfig(horizon=6.0))
    assert a != provenance.config_hash(ts.SimConfig(horizon=7.0))
    assert a != provenance.config_hash(
        dataclasses.replace(ts.SimConfig(horizon=6.0),
                            recorder=RecorderConfig()))


# -- run directory and CLI ----------------------------------------------

def test_write_load_validate_report_run(tmp_path, storm_runs):
    _, cfg, _, out = storm_runs
    ms = registry.collect_stream(out, rho=cfg.rho, dt=cfg.dt,
                                 bucket_s=cfg.ev_bucket)
    tl = trace.HostTimeline()
    with tl.span("export", "host"):
        pass
    d = str(tmp_path / "run")
    runlog.write_run(d, metrics=ms, rec=out.rec, dt=cfg.dt, timeline=tl,
                     config=cfg, manifest_extra={"label": "export-test"},
                     device="cpu")
    for f in ("manifest.json", "metrics.json", "metrics.prom",
              "events.json", "trace.json"):
        assert os.path.exists(os.path.join(d, f)), f
    assert {k: v for k, v in runlog.validate_run(d).items() if v} == {}
    run = runlog.load_run(d)
    assert run["manifest"]["label"] == "export-test"
    assert run["manifest"]["provenance"]["config_hash"] == \
        provenance.config_hash(cfg)
    assert run["events"]["events"], "the storm's events are exported"
    assert jtrace.validate_chrome_trace(run["trace"]) == []
    text = report.render(d)
    assert "export-test" in text and "qos_satisfaction" in text
    assert "flight recorder" in text and "schema validation: OK" in text
    with pytest.raises(ValueError, match="dt"):
        runlog.write_run(str(tmp_path / "x"), rec=out.rec)
    # a corrupt file is reported, not rendered over
    with open(os.path.join(d, "metrics.json"), "w") as f:
        json.dump({"schema": "wrong"}, f)
    run = runlog.load_run(d)
    assert "metrics" not in run and "metrics_doc" in run
    assert any(runlog.validate_run(d).values())
    assert runlog.validate_run(str(tmp_path)) == {
        "manifest.json": ["missing"]}


def test_smoke_and_report_cli(tmp_path):
    d = str(tmp_path / "smoke")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["smoke", "--device", "cpu", "--horizon", "6",
                         "--out", d]) == 0
        assert cli.main(["report", d]) == 0
    text = buf.getvalue()
    assert "obs smoke OK" in text and "trace replay" in text
    assert "label: obs_smoke:retry_storm" in text
    assert "schema validation: OK" in text


# -- router -------------------------------------------------------------

def test_router_trace_is_the_references(tmp_path):
    """The same membership changes on both routers: the same trace
    document but for the wall-clock timestamps."""
    docs = []
    for router, name in ((JRouter(2, 3, seed=1), "ref.json"),
                         (QEdgeRouter(2, 3, seed=1, device="cpu"),
                          "port.json")):
        router.replica_failed(2)
        router.replica_joined(2)
        router.replica_failed(0)
        doc = router.export_trace(str(tmp_path / name))
        assert json.loads((tmp_path / name).read_text()) == doc
        assert jtrace.validate_chrome_trace(doc) == []
        for e in doc["traceEvents"]:
            e.pop("ts", None)
        docs.append(doc)
    assert docs[1] == docs[0]
    assert sum(e["ph"] == "i" for e in docs[1]["traceEvents"]) == 6
