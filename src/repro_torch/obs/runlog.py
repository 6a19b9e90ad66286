"""Run directories: one directory per observed run. Port of
``repro/obs/runlog.py``.

Layout (every file optional but the manifest)::

    <run_dir>/
      manifest.json   # provenance, the config's hash, the files present
      metrics.json    # MetricSet, versioned JSON (registry schema)
      metrics.prom    # the same scalars, Prometheus text format
      trace.json      # Chrome trace-event JSON (Perfetto-loadable)
      events.json     # decoded flight-recorder events, one record each

``python -m repro_torch.obs report <run_dir>`` renders one.
"""
from __future__ import annotations

import json
import os

from repro_torch.obs import provenance as obp
from repro_torch.obs import recorder as obr
from repro_torch.obs import registry as obreg
from repro_torch.obs import trace as obt

MANIFEST_SCHEMA_VERSION = 1


def write_run(
    run_dir: str,
    *,
    metrics: "obreg.MetricSet | None" = None,
    rec=None,
    dt: float | None = None,
    timeline: "obt.HostTimeline | None" = None,
    config=None,
    manifest_extra: dict | None = None,
    device=None,
) -> dict:
    """Write a run directory; returns the manifest.

    ``rec`` is a ``RecorderState``: its events become ``events.json``
    and, with ``timeline``'s host spans, ``trace.json`` (``dt`` places
    them on the simulated time axis). ``device`` is the run's device,
    for the provenance block.
    """
    os.makedirs(run_dir, exist_ok=True)
    files = {}

    if metrics is not None:
        obreg.write_metrics(metrics,
                            json_path=os.path.join(run_dir, "metrics.json"),
                            prom_path=os.path.join(run_dir, "metrics.prom"))
        files["metrics"] = "metrics.json"
        files["prometheus"] = "metrics.prom"

    rec_events = []
    if rec is not None:
        if dt is None:
            raise ValueError("rec needs dt to place events in time")
        rec_events = obr.recorder_events(rec)
        with open(os.path.join(run_dir, "events.json"), "w") as f:
            json.dump({
                "schema": "repro.obs.events",
                "schema_version": MANIFEST_SCHEMA_VERSION,
                "appended": obr.events_appended(rec),
                "dropped": obr.events_dropped(rec),
                "events": [{"step": e.step, "t": e.step * dt,
                            "kind": e.kind_str, "entity": e.entity,
                            "value": e.value, "shard": e.shard,
                            "seq": e.seq} for e in rec_events],
            }, f, indent=1)
        files["events"] = "events.json"

    if rec is not None or timeline is not None:
        lists = []
        if rec is not None:
            lists.append(obt.recorder_trace_events(rec_events, dt))
        if timeline is not None:
            lists.append(timeline.events)
        obt.write_chrome_trace(os.path.join(run_dir, "trace.json"), *lists)
        files["trace"] = "trace.json"

    manifest = {
        "schema": "repro.obs.manifest",
        "schema_version": MANIFEST_SCHEMA_VERSION,
        "provenance": obp.provenance(config, device=device),
        "files": files,
    }
    if manifest_extra:
        manifest.update(manifest_extra)
    with open(os.path.join(run_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def _read_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_run(run_dir: str) -> dict:
    """Whatever a run directory holds: any of ``manifest``, ``metrics``
    (a MetricSet), ``metrics_doc``, ``events``, ``trace`` and
    ``prometheus``."""
    out: dict = {}
    for key, name in (("manifest", "manifest.json"),
                      ("metrics_doc", "metrics.json"),
                      ("events", "events.json"), ("trace", "trace.json")):
        path = os.path.join(run_dir, name)
        if os.path.exists(path):
            out[key] = _read_json(path)
    if "metrics_doc" in out:
        try:
            out["metrics"] = obreg.metricset_from_json(out["metrics_doc"])
        except (KeyError, TypeError, ValueError):
            pass    # a corrupt or foreign document: validate_run says so
    ppath = os.path.join(run_dir, "metrics.prom")
    if os.path.exists(ppath):
        with open(ppath) as f:
            out["prometheus"] = f.read()
    return out


def validate_run(run_dir: str) -> dict:
    """{file: [problems]} for every schema-bearing file present."""
    out: dict = {}
    loaded = load_run(run_dir)
    if "manifest" not in loaded:
        return {"manifest.json": ["missing"]}
    man = loaded["manifest"]
    probs = []
    if man.get("schema") != "repro.obs.manifest":
        probs.append("bad manifest schema tag")
    probs += obp.validate_artifact(man)
    out["manifest.json"] = probs
    if "metrics_doc" in loaded:
        out["metrics.json"] = obreg.validate_metrics_json(
            loaded["metrics_doc"])
    if "prometheus" in loaded:
        out["metrics.prom"] = obreg.validate_prometheus(
            loaded["prometheus"])
    if "trace" in loaded:
        out["trace.json"] = obt.validate_chrome_trace(loaded["trace"])
    if "events" in loaded:
        ev = loaded["events"]
        out["events.json"] = (
            [] if isinstance(ev.get("events"), list) else ["no events list"])
    return out
