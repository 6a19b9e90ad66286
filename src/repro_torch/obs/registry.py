"""Metrics registry: one named-timeseries schema over the simulator's
streaming outputs. Port of ``repro/obs/registry.py``.

* :class:`Metric`: a named scalar (``gauge``/``counter``) or 1-D
  ``series``, with Prometheus-style labels and help text;
* :class:`MetricSet`: an ordered collection with exporters to versioned
  JSON (:meth:`MetricSet.to_json`) and the Prometheus text exposition
  format (:meth:`MetricSet.to_prometheus`; series have no point-in-time
  value and are left out there);
* :func:`collect_stream`: the ``StreamOutputs -> MetricSet`` mapping
  (accumulator statistics, resilience and control counters, the flight
  recorder's counts, one labelled record per scenario event);
* :func:`stream_cell`: the benchmark-cell dict the scenario suite's
  lanes report;
* :func:`collect_tenants` and :func:`tenant_cell`: the same for a tenant
  run (``StreamOutputs.acc`` a tuple of per-tenant accumulators).

The documents are the reference's, schema tag and version included, so
either package's validators accept the other's. This module imports
``repro_torch.continuum`` and is one of ``repro_torch.obs``'s lazy
attributes: the simulator must not import it.
"""
from __future__ import annotations

import json
import math
import re
from dataclasses import dataclass, field

import numpy as np

from repro_torch.continuum import metrics as qm
from repro_torch.continuum.control import (control_stats_stream,
                                           per_tenant_qos_spread)
from repro_torch.obs import recorder as obr

REGISTRY_SCHEMA_VERSION = 1

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
_KINDS = ("gauge", "counter", "series")


@dataclass
class Metric:
    """One named measurement. ``value`` is a float for scalar kinds, a
    1-D list (of floats) for ``series``."""
    name: str
    value: object
    kind: str = "gauge"
    help: str = ""
    labels: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown metric kind {self.kind!r}")
        if not _NAME_RE.match(self.name):
            raise ValueError(f"invalid metric name {self.name!r}")
        for k in self.labels:
            if not _LABEL_RE.match(k):
                raise ValueError(f"invalid label name {k!r}")
        if self.kind == "series":
            self.value = [float(v) for v in obr._np(self.value).ravel()]
        else:
            self.value = float(self.value)


class MetricSet:
    """An ordered collection of :class:`Metric`, unique by name and
    labels."""

    def __init__(self):
        self._metrics: list[Metric] = []
        self._seen: set[tuple] = set()

    def add(self, name: str, value, kind: str = "gauge", help: str = "",
            **labels) -> "MetricSet":
        m = Metric(name, value, kind, help,
                   {k: str(v) for k, v in labels.items()})
        key = (m.name, tuple(sorted(m.labels.items())))
        if key in self._seen:
            raise ValueError(f"duplicate metric {key}")
        self._seen.add(key)
        self._metrics.append(m)
        return self

    def __iter__(self):
        return iter(self._metrics)

    def __len__(self):
        return len(self._metrics)

    def scalars(self) -> dict:
        """{name{labels}: value} for every non-series metric."""
        out = {}
        for m in self._metrics:
            if m.kind == "series":
                continue
            lbl = ",".join(f"{k}={v}" for k, v in sorted(m.labels.items()))
            out[f"{m.name}{{{lbl}}}" if lbl else m.name] = m.value
        return out

    # -- exporters ---------------------------------------------------------

    def to_json(self) -> dict:
        """The versioned JSON document; non-finite values are the
        strings "nan"/"inf"/"-inf", so it parses under
        ``allow_nan=False``."""
        def one(v):
            if math.isnan(v):
                return "nan"
            if math.isinf(v):
                return "inf" if v > 0 else "-inf"
            return v

        def val(m):
            if m.kind == "series":
                return [one(v) for v in m.value]
            return one(m.value)

        return {
            "schema": "repro.obs.metrics",
            "schema_version": REGISTRY_SCHEMA_VERSION,
            "metrics": [
                {"name": m.name, "kind": m.kind, "value": val(m),
                 **({"help": m.help} if m.help else {}),
                 **({"labels": m.labels} if m.labels else {})}
                for m in self._metrics],
        }

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4). Series are
        left out; NaN scalars export as ``NaN``."""
        lines = []
        helped = set()
        for m in self._metrics:
            if m.kind == "series":
                continue
            if m.name not in helped:
                if m.help:
                    lines.append(f"# HELP {m.name} {m.help}")
                lines.append(f"# TYPE {m.name} {m.kind}")
                helped.add(m.name)
            lbl = ""
            if m.labels:
                inner = ",".join(
                    f'{k}="{v}"' for k, v in sorted(m.labels.items()))
                lbl = "{" + inner + "}"
            v = "NaN" if math.isnan(m.value) else repr(m.value)
            lines.append(f"{m.name}{lbl} {v}")
        return "\n".join(lines) + "\n"


def metricset_from_json(doc: dict) -> MetricSet:
    """Loader of :meth:`MetricSet.to_json` documents."""
    if doc.get("schema") != "repro.obs.metrics":
        raise ValueError("not a repro.obs.metrics document")
    if doc.get("schema_version") != REGISTRY_SCHEMA_VERSION:
        raise ValueError(
            f"metrics schema v{doc.get('schema_version')} != "
            f"v{REGISTRY_SCHEMA_VERSION}")
    ms = MetricSet()
    special = {"nan": float("nan"), "inf": float("inf"),
               "-inf": float("-inf")}

    def unval(v):
        if isinstance(v, list):
            return [special.get(x, x) if isinstance(x, str) else x
                    for x in v]
        return special.get(v, v) if isinstance(v, str) else v

    for m in doc["metrics"]:
        ms.add(m["name"], unval(m["value"]), m["kind"],
               m.get("help", ""), **m.get("labels", {}))
    return ms


def validate_metrics_json(doc: dict) -> list[str]:
    """Schema check; a list of problems (empty: valid)."""
    try:
        metricset_from_json(doc)
        return []
    except (KeyError, TypeError, ValueError) as e:
        return [str(e)]


def validate_prometheus(text: str) -> list[str]:
    """Line-level check of the text exposition format."""
    problems = []
    sample_re = re.compile(
        r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? "
        r"(NaN|[+-]?(Inf|[0-9.eE+-]+))$")
    for i, line in enumerate(text.splitlines()):
        if not line or line.startswith("# "):
            continue
        if not sample_re.match(line):
            problems.append(f"line {i + 1}: unparseable sample {line!r}")
    if not text.endswith("\n"):
        problems.append("missing trailing newline")
    return problems


# ---------------------------------------------------------------------------
# StreamOutputs -> MetricSet.
# ---------------------------------------------------------------------------

def collect_stream(outs, *, rho: float, dt: float, bucket_s: float,
                   with_series: bool = True) -> MetricSet:
    """Everything a streaming run reports, under one namespace.

    ``outs`` is one run's ``StreamOutputs`` (a lane: ``metrics.lane``).
    Adds the control counters when ``outs.ctrl`` is present, the
    recorder's totals and per-kind counts when ``outs.rec`` is, and one
    labelled record per scenario event from ``metrics.event_recovery``.
    """
    acc = outs.acc
    ms = MetricSet()
    ms.add("repro_qos_satisfaction_pct",
           qm.client_qos_satisfaction_stream(acc, rho),
           help="clients with success ratio >= rho, % (Fig. 5)")
    ms.add("repro_jain_fairness", qm.jain_fairness_stream(acc),
           help="Jain index over per-instance arrival totals (Fig. 7)")
    for k, v in qm.resilience_stats_stream(acc).items():
        kind = "counter" if k in ("requests", "attempts", "timeouts",
                                  "drops") else "gauge"
        ms.add(f"repro_{k}", v, kind,
               help=f"post-warmup {k.replace('_', ' ')}")
    ms.add("repro_steps_measured", float(obr._np(acc.steps_measured)),
           "counter", help="post-warmup steps accumulated")
    ms.add("repro_regret_total",
           float(obr._np(acc.regret_k).astype(np.float64).sum()), "counter",
           help="cumulative system regret (post-warmup)")
    rates = qm.request_rate_per_instance_stream(acc, dt)
    for m_i, r in enumerate(rates):
        ms.add("repro_instance_request_rate", float(r),
               help="per-instance arrival rate, req/s", instance=m_i)
    for e, r in enumerate(qm.event_recovery(acc, bucket_s)):
        for k in ("pre", "dip", "dip_s", "steady"):
            ms.add(f"repro_event_{k}",
                   float("nan") if r[k] is None else r[k],
                   help=f"event-recovery {k}", event=e)
        ms.add("repro_event_recovered", 1.0 if r["recovered"] else 0.0,
               help="event QoS recovered inside the observed windows",
               event=e)
        ms.add("repro_event_recovery_s",
               float("nan") if r["recovery_s"] is None else r["recovery_s"],
               help="time-to-recover from the dip, s", event=e)
    if outs.ctrl is not None:
        for k, v in control_stats_stream(acc, outs.ctrl).items():
            ms.add(f"repro_{k}", v,
                   "counter" if k.startswith("ctrl_") and "rate" not in k
                   else "gauge", help=f"control-plane {k}")
    if outs.rec is not None:
        ms.add("repro_recorder_events_appended",
               obr.events_appended(outs.rec), "counter",
               help="flight-recorder events appended (incl. overwritten)")
        ms.add("repro_recorder_events_dropped",
               obr.events_dropped(outs.rec), "counter",
               help="flight-recorder events lost to ring wraparound")
        by_kind: dict = {}
        for ev in obr.recorder_events(outs.rec):
            by_kind[ev.kind_str] = by_kind.get(ev.kind_str, 0) + 1
        for k in sorted(by_kind):
            ms.add("repro_recorder_events_retained", by_kind[k],
                   "counter", help="flight-recorder events in the ring",
                   event_kind=k)
    if with_series and outs.series is not None:
        s = outs.series
        ms.add("repro_step_succ", s.succ, "series",
               help="per-step fleet QoS successes")
        ms.add("repro_step_issued", s.issued, "series",
               help="per-step fleet issued requests")
        ms.add("repro_step_regret", s.regret, "series",
               help="per-step system regret")
        ms.add("repro_step_attempts", s.attempts, "series",
               help="per-step attempts incl. retries")
    return ms


# ---------------------------------------------------------------------------
# The benchmark-cell builder (the scenario suite's lanes).
# ---------------------------------------------------------------------------

def recovery_summary(recs: list[dict], *,
                     max_recovery: bool = True) -> dict:
    """``worst_dip`` / ``unrecovered_events`` / ``max_recovery_s`` from
    an ``event_recovery`` readout (empty without events). Events with no
    data-bearing post bucket count as unrecovered and stay out of the
    dip minimum."""
    if not recs:
        return {}
    out = {}
    dips = [r["dip"] for r in recs if math.isfinite(r["dip"])]
    if dips:
        out["worst_dip"] = min(dips)
    recovered = [r["recovery_s"] for r in recs if r["recovered"]]
    out["unrecovered_events"] = len(recs) - len(recovered)
    if max_recovery and recovered:
        out["max_recovery_s"] = max(recovered)
    return out


def stream_cell(outs, *, rho: float, bucket_s: float,
                jain: bool = False, n_events: bool = False,
                resilience: bool = False, breaker_frac: bool = False,
                tenants: bool = False, drop_rate: bool = False,
                control: bool = False, max_recovery: bool = True) -> dict:
    """One benchmark-cell dict from one run's ``StreamOutputs``:
    ``{"qos_sat_pct": ...}`` plus the :func:`recovery_summary` keys when
    the run had scenario events; the keyword switches add the extras
    the scenario suite's lanes use. ``breaker_open_frac`` is a float32
    mean, as the reference takes it."""
    acc = outs.acc
    recs = qm.event_recovery(acc, bucket_s)
    cell = {"qos_sat_pct": qm.client_qos_satisfaction_stream(acc, rho)}
    if jain:
        cell["jain"] = qm.jain_fairness_stream(acc)
    if tenants:
        spread = per_tenant_qos_spread(acc)
        cell["tenant_qos_spread"] = spread["spread"]
        cell["tenant_qos_min"] = spread["min"]
    if resilience:
        cell.update(qm.resilience_stats_stream(acc))
    elif drop_rate:
        cell["drop_rate"] = qm.resilience_stats_stream(acc)["drop_rate"]
    if breaker_frac:
        # a float32 mean summed in order, as XLA:CPU reduces it
        frac = qm.breaker_open_fraction_stream(acc).astype(np.float32)
        total = np.cumsum(frac.ravel(), dtype=np.float32)[-1]
        cell["breaker_open_frac"] = float(total / np.float32(frac.size))
    if n_events:
        cell["events"] = len(recs)
    cell.update(recovery_summary(recs, max_recovery=max_recovery))
    if control and outs.ctrl is not None:
        cell.update(control_stats_stream(acc, outs.ctrl))
    return cell


# ---------------------------------------------------------------------------
# Multi-tenant collectors (StreamOutputs.acc a tuple of NT accumulators).
# ---------------------------------------------------------------------------

def collect_tenants(outs, *, rho: float) -> MetricSet:
    """Per-tenant QoS and cross-tenant fairness from one tenant run
    (``SimConfig.tenancy`` with two or more tenants)."""
    accs = outs.acc
    if not qm.is_tenant_run(accs):
        raise TypeError("collect_tenants expects a tenant run "
                        "(StreamOutputs.acc must be a tuple of per-"
                        "tenant MetricAccumulators)")
    ms = MetricSet()
    sat = qm.tenant_qos_satisfaction_stream(accs, rho)
    qos = qm.tenant_qos_stream(accs)
    served = qm.tenant_served_stream(accs)
    for s in range(len(accs)):
        ms.add("repro_tenant_qos_satisfaction_pct", float(sat[s]),
               help="tenant clients with success ratio >= rho, %",
               tenant=s)
        ms.add("repro_tenant_qos_ratio", float(qos[s]),
               help="tenant overall QoS success ratio", tenant=s)
        ms.add("repro_tenant_requests", float(served[s]), "counter",
               help="tenant post-warmup issued requests", tenant=s)
    for k, v in qm.tenant_fairness_stream(accs).items():
        ms.add(f"repro_fairness_{k}", v,
               help=f"cross-tenant fairness index: {k.replace('_', ' ')}")
    part = qm.tenant_partition_stream(accs)
    ms.add("repro_tenant_partition_index", part["partition_index"],
           help="1 - mean pairwise routing overlap between tenants")
    ms.add("repro_tenant_mean_overlap", part["mean_overlap"],
           help="mean pairwise min-overlap of tenant routing profiles")
    return ms


def tenant_cell(outs, *, rho: float) -> dict:
    """One multi-tenant benchmark-cell dict, the ``multi_tenant`` lane's
    schema: per-tenant QoS columns (index = tenant id) plus the
    cross-tenant fairness and partition scalars."""
    accs = outs.acc
    cell = {
        "tenant_qos_sat_pct": [
            float(v) for v in qm.tenant_qos_satisfaction_stream(accs, rho)],
        "tenant_qos_ratio": [float(v) for v in qm.tenant_qos_stream(accs)],
        "tenant_requests": [float(v) for v in qm.tenant_served_stream(accs)],
    }
    cell.update(qm.tenant_fairness_stream(accs))
    cell.update(qm.tenant_partition_stream(accs))
    return cell


def write_metrics(ms: MetricSet, json_path=None, prom_path=None) -> None:
    if json_path is not None:
        with open(json_path, "w") as f:
            json.dump(ms.to_json(), f, indent=1, allow_nan=False)
    if prom_path is not None:
        with open(prom_path, "w") as f:
            f.write(ms.to_prometheus())
