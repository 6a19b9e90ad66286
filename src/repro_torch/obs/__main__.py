"""``python -m repro_torch.obs``: the observability CLI. Port of
``repro/obs/__main__.py``.

* ``report <run_dir>`` renders a run directory written by
  :func:`repro_torch.obs.runlog.write_run` (timeline, recovery windows,
  provenance, timing figures).
* ``smoke [--out DIR] [--horizon S] [--device D]`` drives the
  ``retry_storm`` scenario at 30 x 10 on the bounded request lifecycle
  with the flight recorder off and on: every accumulator field must be
  equal; the recorded scenario marks must equal the scenario's marks
  and ``event_recovery``'s windows; the run directory is written and
  every file validated; the exported trace must carry the marks at
  their exact steps. The recorder's overhead prints for information
  (eager torch compiles nothing, so there is no warm-up run; the card's
  overhead figure comes from ``chip_smoke.py``'s fleet).
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import tempfile
import time


def _cmd_report(args) -> int:
    from repro_torch.obs import report
    print(report.render(args.run_dir))
    return 0


def _cmd_smoke(args) -> int:
    import torch

    from repro_torch.continuum import (compile_scenario, event_recovery,
                                       get_library, make_topology)
    from repro_torch.continuum.simulator import SimConfig, run_sim_stream
    from repro_torch.device import resolve_device
    from repro_torch.obs import (KIND_MARK, RecorderConfig, recorder_events,
                                 registry, runlog, trace)

    dev = resolve_device(args.device)
    K, M = 30, 10
    warm = 50
    base = dict(horizon=args.horizon, tau=0.150, attempt_timeout=0.090,
                max_retries=2, retry_backoff=0.002, breaker_threshold=5,
                breaker_cooldown=1.0)
    cfg_off = SimConfig(**base)
    cfg_on = SimConfig(**base, recorder=RecorderConfig(capacity=4096))

    rtt = make_topology(1, K, M, device=dev).lb_instance_rtt()
    lib = get_library(cfg_on.horizon, K, M)
    drv = compile_scenario(lib["retry_storm"], cfg_on, 7, device=dev)
    timeline = trace.HostTimeline()

    def run(cfg, label):
        with timeline.span(f"run:{label}", "dispatch"):
            t0 = time.perf_counter()
            out = run_sim_stream("qedgeproxy", rtt, cfg, 11, drivers=drv,
                                 warmup_steps=warm, device=dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return out, time.perf_counter() - t0

    out_off, off_s = run(cfg_off, "recorder_off")
    out_on, on_s = run(cfg_on, "recorder_on")
    steps = cfg_on.num_steps
    ratio = on_s / max(off_s, 1e-9)
    print(f"smoke cell K={K} M={M} T={steps} on {dev.type}: recorder off "
          f"{off_s * 1e6 / steps:.1f} us/step, on "
          f"{on_s * 1e6 / steps:.1f} us/step (ratio {ratio:.3f}, "
          f"informational)")

    # recorder on and off: every accumulator field equal
    mismatch = [f for f in out_off.acc._fields
                if not torch.equal(getattr(out_off.acc, f),
                                   getattr(out_on.acc, f))]
    if mismatch:
        print(f"FAIL: recorder changed accumulator fields {mismatch}")
        return 1

    evs = recorder_events(out_on.rec)
    kinds = collections.Counter(e.kind_str for e in evs)
    print(f"recorded: {dict(sorted(kinds.items()))}")

    # replay: the recorded scenario marks are the scenario's marks and
    # the accumulator's event windows, same count, same steps
    mark_evs = sorted(e.step for e in evs if e.kind == KIND_MARK)
    marks = sorted(int(m) for m in drv.marks.cpu().numpy() if m >= 0)
    recs = event_recovery(out_on.acc, cfg_on.ev_bucket)
    if mark_evs != marks or len(recs) != len(marks):
        print(f"FAIL: recorded marks {mark_evs} vs scenario marks "
              f"{marks} vs {len(recs)} event windows")
        return 1
    print(f"replay: {len(mark_evs)} recorded marks == scenario marks "
          f"== {len(recs)} accumulator event windows")

    # the run directory, every file validated
    out_dir = args.out or tempfile.mkdtemp(prefix="obs_smoke_")
    ms = registry.collect_stream(out_on, rho=cfg_on.rho, dt=cfg_on.dt,
                                 bucket_s=cfg_on.ev_bucket)
    with timeline.span("export", "host"):
        runlog.write_run(
            out_dir, metrics=ms, rec=out_on.rec, dt=cfg_on.dt,
            timeline=timeline, config=cfg_on, device=dev,
            manifest_extra={
                "label": "obs_smoke:retry_storm",
                "overhead_ratio": ratio,
                "recorder_us_per_step": on_s * 1e6 / steps,
                "baseline_us_per_step": off_s * 1e6 / steps,
            })
    problems = {f: p for f, p in runlog.validate_run(out_dir).items() if p}
    if problems:
        print(f"FAIL: schema validation {problems}")
        return 1
    print(f"run dir {out_dir}: all schemas valid")

    # trace replay: the exported trace carries the marks at their steps
    with open(os.path.join(out_dir, "trace.json")) as f:
        doc = json.load(f)
    tr_marks = sorted(
        round(e["ts"] / (cfg_on.dt * 1e6))
        for e in doc["traceEvents"]
        if e.get("ph") == "i" and e.get("name") == "scenario_mark")
    if tr_marks != marks:
        print(f"FAIL: trace marks {tr_marks} != scenario marks {marks}")
        return 1
    print(f"trace replay: {len(tr_marks)} scenario_mark instants at the "
          f"exact mark steps")
    print("obs smoke OK")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m repro_torch.obs")
    sub = p.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("report", help="render a run directory")
    pr.add_argument("run_dir")
    pr.set_defaults(fn=_cmd_report)
    ps = sub.add_parser("smoke", help="record, export, validate, replay")
    ps.add_argument("--out", default=None, help="run directory to write")
    ps.add_argument("--horizon", type=float, default=60.0)
    ps.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    ps.set_defaults(fn=_cmd_smoke)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
