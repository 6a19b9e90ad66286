"""Chrome trace-event export: recorder events and host-side timings as
a Perfetto-loadable timeline. Port of ``repro/obs/trace.py``.

Two time domains share one trace, on separate process lanes:

* **Simulated time**: flight-recorder events at ``ts = step * dt`` (in
  trace microseconds), one process (``pid``) a ring (``shard``: a lane
  of a lane-batched run) and one thread (``tid``) an event kind, so
  Perfetto shows lanes like ``player shard 0 / breaker_trip``.
  Fleet-level events (scenario marks, control actions) get their own
  ``fleet`` process.
* **Host wall time**: :class:`HostTimeline` spans (dispatch, export,
  ...) as complete events on a ``host`` process, re-based so the
  timeline starts at t=0.

The document is the JSON object format (``{"traceEvents": [...]}``)
with "i" instant events for records, "X" complete events for host spans
and "M" metadata events naming the lanes; :func:`validate_chrome_trace`
is its schema check.
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager

from repro_torch.obs import recorder as obr

TRACE_SCHEMA_VERSION = 1

# fixed pid blocks so lanes sort stably in the UI
_PID_FLEET = 1
_PID_SHARD0 = 10
_PID_HOST = 1000

_FLEET_KINDS = frozenset({obr.KIND_MARK, obr.KIND_SCALE_UP,
                          obr.KIND_SCALE_DOWN, obr.KIND_MIGRATE})


def meta_event(pid, tid, key, name) -> dict:
    """A "M" metadata event naming a process or thread lane."""
    return {"ph": "M", "pid": pid, "tid": tid, "name": key,
            "args": {"name": name}}


def recorder_trace_events(rec_or_events, dt: float) -> list[dict]:
    """Recorder events as Chrome instant events, with lane metadata.
    Takes a ``RecorderState`` or a decoded event list."""
    events = (rec_or_events if isinstance(rec_or_events, list)
              else obr.recorder_events(rec_or_events))
    out = []
    lanes_named: set[tuple] = set()

    def name_lane(pid, tid, pname, tname):
        if (pid, None) not in lanes_named:
            out.append(meta_event(pid, 0, "process_name", pname))
            lanes_named.add((pid, None))
        if (pid, tid) not in lanes_named:
            out.append(meta_event(pid, tid, "thread_name", tname))
            lanes_named.add((pid, tid))

    for ev in events:
        fleet = ev.kind in _FLEET_KINDS
        pid = _PID_FLEET if fleet else _PID_SHARD0 + ev.shard
        tid = ev.kind + 1
        name_lane(pid, tid,
                  "fleet" if fleet else f"player shard {ev.shard}",
                  ev.kind_str)
        out.append({
            "ph": "i", "s": "g" if fleet else "t",
            "pid": pid, "tid": tid,
            "name": ev.kind_str,
            "cat": "recorder",
            "ts": ev.step * dt * 1e6,       # simulated µs
            "args": {"step": ev.step, "entity": ev.entity,
                     "value": ev.value, "seq": ev.seq},
        })
    return out


class HostTimeline:
    """Wall-clock spans of the host side of a run (dispatch, checkpoint
    writes, export): "X" complete events on the ``host`` process lane,
    re-based to the timeline's construction time."""

    def __init__(self):
        self._t0 = time.perf_counter()
        self.events: list[dict] = [
            meta_event(_PID_HOST, 0, "process_name", "host"),
            meta_event(_PID_HOST, 1, "thread_name", "driver"),
        ]

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    @contextmanager
    def span(self, name: str, cat: str = "host", **args):
        t0 = self._now_us()
        try:
            yield
        finally:
            self.events.append({
                "ph": "X", "pid": _PID_HOST, "tid": 1, "name": name,
                "cat": cat, "ts": t0, "dur": self._now_us() - t0,
                **({"args": args} if args else {})})

    def instant(self, name: str, cat: str = "host", **args):
        self.events.append({
            "ph": "i", "s": "t", "pid": _PID_HOST, "tid": 1,
            "name": name, "cat": cat, "ts": self._now_us(),
            **({"args": args} if args else {})})


def chrome_trace(*event_lists, meta: dict | None = None) -> dict:
    """Event lists as one trace document."""
    events = [e for lst in event_lists for e in lst]
    doc = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"schema": "repro.obs.trace",
                      "schema_version": TRACE_SCHEMA_VERSION},
    }
    if meta:
        doc["otherData"].update(meta)
    return doc


def write_chrome_trace(path, *event_lists, meta: dict | None = None) -> dict:
    doc = chrome_trace(*event_lists, meta=meta)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


_PHASES = {"i", "X", "M", "B", "E", "b", "e", "n", "C"}


def validate_chrome_trace(doc) -> list[str]:
    """Schema check; a list of problems (empty: valid)."""
    problems = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["not a JSON-object-format trace (no traceEvents)"]
    evs = doc["traceEvents"]
    if not isinstance(evs, list):
        return ["traceEvents is not a list"]
    for i, e in enumerate(evs):
        if not isinstance(e, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = e.get("ph")
        if ph not in _PHASES:
            problems.append(f"event {i}: bad ph {ph!r}")
            continue
        if "name" not in e or "pid" not in e:
            problems.append(f"event {i}: missing name/pid")
        if ph in ("i", "X") and not isinstance(e.get("ts"), (int, float)):
            problems.append(f"event {i}: missing numeric ts")
        if ph == "X" and not isinstance(e.get("dur"), (int, float)):
            problems.append(f"event {i}: X event missing dur")
        if ph == "i" and e.get("s") not in (None, "g", "p", "t"):
            problems.append(f"event {i}: bad instant scope {e.get('s')!r}")
    return problems
