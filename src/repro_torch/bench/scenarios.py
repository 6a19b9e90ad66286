"""The scenario library on the card: every named non-stationarity regime
as the lanes of one run per strategy, with QoS and event-recovery
columns.

Twin of the open-loop part of the JAX package's
``benchmarks/scenario_suite.py``: the library (``get_library``) on the
paper's 30 x 10 testbed, seed 1's topology for every lane, lane i
compiled at key ``500 + i``, one run key (11) for every lane so that
scenarios share the noise stream, under the contrast pair
``qedgeproxy`` and ``proxy_mity_1.0``. Per scenario and strategy the
payload records clients >= rho (%), Jain fairness, the number of events,
the worst dip and the slowest recovery from ``event_recovery`` (the
reference's ``stream_cell``). Each strategy records its seconds and
``grid_steps_per_s`` (lanes x steps / seconds).

The reference's ``graceful_degradation`` and ``closed_loop`` lanes need
the resilience layer and the control plane (ROADMAP A9); their row
functions raise.

    python -m repro_torch.bench.scenarios [--smoke] [--device cpu]

prints the payload as one JSON line, then the timings as another; smoke
runs the reference's ``SMOKE_SCENARIOS`` at the 24 s smoke horizon.
"""
from __future__ import annotations

import argparse
import json
import math
import time

import torch

from repro_torch.bench import figures
from repro_torch.continuum import (client_qos_satisfaction_stream,
                                   compile_scenario, event_recovery,
                                   get_library, jain_fairness_stream, lane,
                                   make_topology, stack_drivers)
from repro_torch.core import prand
from repro_torch.device import resolve_device

# contrast pair: the adaptive balancer against static proximity
SUITE_STRATEGIES = (("qedgeproxy", {}), ("proxy_mity_1.0", dict(alpha=1.0)))
SMOKE_SCENARIOS = ("baseline", "surge", "cascade_failure", "everything")
COMPILE_KEY0, RUN_KEY = 500, 11


def get_scenario_suite(device=None, smoke: bool = False,
                       horizon: float | None = None) -> dict:
    """``{"names", "config", "runs": {(name, label): StreamOutputs},
    "timings": {label: timing}, "device"}`` over the library, each
    strategy's scenarios as the lanes of one run. ``horizon`` overrides ``figures.configure(smoke)``'s; the
    warm-up stays the first third."""
    base = figures.configure(smoke)
    conf = figures._config(base.cfg.horizon if horizon is None else horizon,
                           base.seeds, smoke)
    dev = resolve_device(device)
    cfg = conf.cfg
    K, M = figures.N_LBS, figures.N_INSTANCES
    lib = get_library(cfg.horizon, K, M)
    names = [n for n in lib if not smoke or n in SMOKE_SCENARIOS]
    S = len(names)
    rtt = make_topology(1, K, M, device=dev).lb_instance_rtt()
    rtts = rtt[None].expand(S, K, M).contiguous()
    # lane i compiles at key 500 + i, as the reference keys them
    drivers = stack_drivers(
        [compile_scenario(lib[n], cfg, COMPILE_KEY0 + i, device=dev)
         for i, n in enumerate(names)])
    keys = prand.prng_key(RUN_KEY, dev)[None].expand(S, 2).contiguous()
    runs, timings = {}, {}
    for label, kw in SUITE_STRATEGIES:
        out, timings[label] = figures.run_lanes(label, kw, rtts, keys,
                                                drivers, conf, dev)
        for i, name in enumerate(names):
            runs[(name, label)] = lane(out, i)
    return dict(names=list(names), config=conf, runs=runs, timings=timings,
                device=figures.device_name(dev))


def recovery_summary(recs: list[dict]) -> dict:
    """``worst_dip`` / ``unrecovered_events`` / ``max_recovery_s`` from
    an ``event_recovery`` readout (empty without events); events with no
    data-bearing post bucket count as unrecovered and stay out of the
    dip minimum, as in the reference's ``obs.registry``."""
    if not recs:
        return {}
    out = {}
    dips = [r["dip"] for r in recs if math.isfinite(r["dip"])]
    if dips:
        out["worst_dip"] = min(dips)
    recovered = [r["recovery_s"] for r in recs if r["recovered"]]
    out["unrecovered_events"] = len(recs) - len(recovered)
    if recovered:
        out["max_recovery_s"] = max(recovered)
    return out


def stream_cell(outs, rho: float, bucket_s: float) -> dict:
    """One scenario x strategy row: the reference's ``stream_cell(...,
    jain=True, n_events=True)``."""
    recs = event_recovery(outs.acc, bucket_s)
    cell = {"qos_sat_pct": client_qos_satisfaction_stream(outs.acc, rho),
            "jain": jain_fairness_stream(outs.acc),
            "events": len(recs)}
    cell.update(recovery_summary(recs))
    return cell


def scenario_rows(suite: dict) -> dict:
    """``{scenario: {strategy: cell}}``, the open-loop rows of the
    reference's ``scenario_suite`` payload."""
    cfg = suite["config"].cfg
    return {name: {label: stream_cell(suite["runs"][(name, label)], cfg.rho,
                                      cfg.ev_bucket)
                   for label, _ in SUITE_STRATEGIES}
            for name in suite["names"]}


def graceful_degradation(suite: dict) -> dict:
    raise NotImplementedError(
        "the graceful-degradation lane needs request-lifecycle resilience, "
        "not ported to repro_torch yet (ROADMAP A9)")


def closed_loop(suite: dict) -> dict:
    raise NotImplementedError(
        "the closed-loop lane needs the control plane, not ported to "
        "repro_torch yet (ROADMAP A9)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="24 s horizon, the reference's smoke scenarios")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    suite = get_scenario_suite(args.device, smoke=args.smoke)
    payload = scenario_rows(suite)
    conf = suite["config"]
    payload["provenance"] = {
        "benchmark": "scenario_suite",
        "us_per_call": (time.perf_counter() - t0) * 1e6,
        "device": suite["device"], "torch": torch.__version__,
        "smoke": conf.smoke, "horizon_s": conf.cfg.horizon}
    print(json.dumps(payload), flush=True)
    print(json.dumps({"timings": suite["timings"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
