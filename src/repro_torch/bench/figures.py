"""The paper's evaluation suite (§VII-A6) on the card: Figs 3-11 and
the regret curve.

Twin of the JAX package's harness, ``benchmarks/common.py``'s suite and
``benchmarks/figures.py``: the same four strategies on the paper's
30 x 10 testbed over seeds, each lane the reference's (topology
``make_topology(seed)``, key ``prng_key(100 + seed)``, the compiled
``baseline`` scenario, streaming metrics), and one payload function per
figure that returns the reference's dict. Each strategy runs its seeds
as the lanes of one run (``run_sim_grid``) and records its seconds,
``grid_steps_per_s`` (lanes x steps / seconds) and the launches of the
port's counted kernels. Figs 10-11 run the two legacy events (a client
surge, an instance removal) as the two lanes of one run per strategy,
compiled from scenario specs as the reference compiles them.

    python -m repro_torch.bench.figures [--smoke] [--device cpu] [--out DIR]

prints each figure's payload as one JSON line, stamped with
``obs.provenance.stamp`` (git sha, torch and CUDA, the device, the
config's hash, and under it the figure, compute time and settings);
with ``--out`` it also writes ``DIR/<figure>.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.continuum import (InstanceKill, LoadSurge, Scenario,
                                   SimConfig, client_qos_satisfaction_stream,
                                   compile_scenario, cumulative_regret_series,
                                   event_recovery, jain_fairness_stream, lane,
                                   make_topology, per_client_success_stream,
                                   per_lb_request_distribution_stream,
                                   proc_latency_quantile_stream,
                                   request_rate_per_instance_stream,
                                   rolling_qos_series, run_sim_grid,
                                   stack_drivers)
from repro_torch.core import prand
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.obs import provenance

STRATEGIES = (
    ("qedgeproxy", {}),
    ("proxy_mity_1.0", dict(alpha=1.0)),
    ("proxy_mity_0.9", dict(alpha=0.9)),
    ("dec_sarsa", {}),
)
N_LBS, N_INSTANCES = 30, 10


@dataclass(frozen=True)
class SuiteConfig:
    cfg: SimConfig
    warm: int             # warm-up steps: the first third of the horizon
    seeds: tuple
    smoke: bool


def _config(horizon: float, seeds: tuple, smoke: bool) -> SuiteConfig:
    cfg = SimConfig(horizon=horizon)
    return SuiteConfig(cfg, int(horizon / 3 / cfg.dt), tuple(seeds), smoke)


def configure(smoke: bool = False) -> SuiteConfig:
    """The reference harness's two configs: 180 s with a 60 s warm-up
    over seeds 1-5, or the smoke gate's 24 s / 8 s over seeds 1-2."""
    if smoke:
        return _config(24.0, (1, 2), True)
    return _config(180.0, (1, 2, 3, 4, 5), False)


def strategy_name(label: str) -> str:
    return "proxy_mity" if label.startswith("proxy_mity") else label


class Suite(NamedTuple):
    config: SuiteConfig
    runs: dict          # (seed, label) -> StreamOutputs
    topos: dict         # seed -> Topology
    timings: dict       # label -> seconds, lanes, grid steps/s, launches
    device: str         # the card's name, or "cpu"


def _launches() -> dict:
    return {fn.__name__: fn.launches for fn in kernel_ops.WRAPPERS}


def device_name(dev: torch.device) -> str:
    """The card's name, or "cpu"."""
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_lanes(label: str, kw: dict, rtts, keys, drivers, conf: SuiteConfig,
              dev: torch.device):
    """One strategy's lanes as one ``run_sim_grid`` run: ``(outputs,
    timing)``, the timing its seconds, lanes, ``grid_steps_per_s`` and
    the launches of each counted kernel."""
    S, T = rtts.shape[0], conf.cfg.num_steps
    before = _launches()
    _sync(dev)
    t0 = time.perf_counter()
    out = run_sim_grid(strategy_name(label), rtts, conf.cfg, keys,
                       drivers=drivers, warmup_steps=conf.warm, device=dev,
                       **kw)
    _sync(dev)
    secs = time.perf_counter() - t0
    after = _launches()
    return out, dict(seconds=secs, lanes=S, steps=T,
                     grid_steps_per_s=S * T / secs,
                     launches={k: after[k] - before[k] for k in after})


def get_suite(device=None, seeds=None, horizon: float | None = None,
              smoke: bool = False) -> Suite:
    """Every (seed, strategy) lane of the evaluation grid on ``device``
    (default ``cuda``): each strategy's seeds as the lanes of one run.
    ``seeds`` and ``horizon`` override ``configure(smoke)``'s; the
    warm-up stays the first third of the horizon."""
    base = configure(smoke)
    conf = _config(base.cfg.horizon if horizon is None else horizon,
                   base.seeds if seeds is None else seeds, smoke)
    dev = resolve_device(device)
    topos = {seed: make_topology(seed, N_LBS, N_INSTANCES, device=dev)
             for seed in conf.seeds}
    rtts = torch.stack([topos[s].lb_instance_rtt() for s in conf.seeds])
    keys = torch.stack([prand.prng_key(100 + s, dev) for s in conf.seeds])
    # every seed lane runs the compiled `baseline` scenario, as there
    scn = Scenario("baseline", n_nodes=N_LBS, n_instances=N_INSTANCES)
    drivers = stack_drivers([compile_scenario(scn, conf.cfg, s, device=dev)
                             for s in conf.seeds])
    runs, timings = {}, {}
    for label, kw in STRATEGIES:
        out, timings[label] = run_lanes(label, kw, rtts, keys, drivers, conf,
                                        dev)
        for i, seed in enumerate(conf.seeds):
            runs[(seed, label)] = lane(out, i)
    return Suite(conf, runs, topos, timings, device_name(dev))


# ---------------------------------------------------------------------------
# One payload per figure: the reference's dicts. Figs 5-9 and the regret
# curve read the first seed's lane, as the reference reads seed 1.
# ---------------------------------------------------------------------------

def _first(suite: Suite, label: str):
    return suite.runs[(suite.config.seeds[0], label)]


def fig3_qos_success(suite: Suite) -> dict:
    out = {}
    for label, _ in STRATEGIES:
        vals = [client_qos_satisfaction_stream(suite.runs[(s, label)].acc,
                                               suite.config.cfg.rho)
                for s in suite.config.seeds]
        out[label] = {"per_scenario": vals, "mean": float(np.mean(vals)),
                      "std": float(np.std(vals))}
    return out


def fig4_fairness(suite: Suite) -> dict:
    out = {}
    for label, _ in STRATEGIES:
        vals = [jain_fairness_stream(suite.runs[(s, label)].acc)
                for s in suite.config.seeds]
        out[label] = {"per_scenario": vals, "mean": float(np.mean(vals))}
    return out


def fig5_per_client(suite: Suite) -> dict:
    out = {}
    for label, _ in STRATEGIES:
        ratio, present = per_client_success_stream(_first(suite, label).acc)
        r = np.sort(ratio[present])
        out[label] = {
            "min": float(r[0]), "p25": float(np.percentile(r, 25)),
            "median": float(np.median(r)),
            "clients_below_target": int((r < suite.config.cfg.rho).sum()),
            "n_clients": int(r.size),
        }
    return out


def fig6_rolling_qos(suite: Suite) -> dict:
    cfg = suite.config.cfg
    win = int(cfg.window / cfg.dt)
    out = {}
    for label, _ in STRATEGIES:
        roll = rolling_qos_series(_first(suite, label).series, win)
        steady = roll[suite.config.warm:].mean()
        # convergence: first time rolling QoS reaches 95% of steady
        idx = np.argmax(roll >= 0.95 * steady)
        out[label] = {"steady": float(steady),
                      "convergence_s": float(idx * cfg.dt),
                      "curve_30s_samples": roll[::50][:40].tolist()}
    return out


def fig7_request_distribution(suite: Suite) -> dict:
    out = {}
    for label, _ in STRATEGIES:
        rate = request_rate_per_instance_stream(_first(suite, label).acc,
                                                suite.config.cfg.dt)
        out[label] = {"per_instance_req_s": rate.tolist(),
                      "max": float(rate.max()), "min": float(rate.min())}
    return out


def fig8_p90_latency(suite: Suite) -> dict:
    out = {}
    for label, _ in STRATEGIES:
        p90 = proc_latency_quantile_stream(_first(suite, label).acc, 0.9)
        out[label] = {"per_instance_ms": (p90 * 1e3).tolist(),
                      "max_ms": float(p90.max() * 1e3)}
    return out


def fig9_single_lb(suite: Suite) -> dict:
    topo = suite.topos[suite.config.seeds[0]]
    inst_nodes = set(topo.instance_nodes.tolist())
    lb_local = next(i for i in range(N_LBS) if i in inst_nodes)
    lb_remote = next(i for i in range(N_LBS) if i not in inst_nodes)
    out = {}
    for label, _ in STRATEGIES:
        acc = _first(suite, label).acc
        out[label] = {
            "lb_with_local": per_lb_request_distribution_stream(
                acc, lb_local).tolist(),
            "lb_without_local": per_lb_request_distribution_stream(
                acc, lb_remote).tolist(),
        }
        for key in ("lb_with_local", "lb_without_local"):
            p = np.asarray(out[label][key])
            nz = p[p > 0]
            out[label][key + "_entropy"] = float(-(nz * np.log(nz)).sum())
    return out


# The §VII-C surge subset, frozen as data in the reference
# (benchmarks/figures.py): the LBs that gain clients in Fig 10.
SURGE_LBS = (0, 1, 4, 5, 6, 9, 10, 13, 14, 16, 17, 20, 22, 24, 29)
EVENTS = ("surge", "removal")


def legacy_event_scenarios(cfg: SimConfig, K: int = N_LBS,
                           M: int = N_INSTANCES) -> tuple:
    """The two legacy events (Figs 10/11) as scenario specs: a +2-client
    step surge on half the LBs, and the last instance going dark, both
    at mid-horizon."""
    half = (cfg.num_steps // 2) * cfg.dt
    surge = Scenario(
        "legacy_surge",
        (LoadSurge(start=half, extra=2,
                   lbs=tuple(lb for lb in SURGE_LBS if lb < K)),),
        n_nodes=K, n_instances=M, base_clients=2)
    removal = Scenario(
        "legacy_removal",
        (InstanceKill(start=half, instances=(M - 1,)),),
        n_nodes=K, n_instances=M, base_clients=4)
    return surge, removal


def get_events(conf: SuiteConfig, device=None) -> tuple[dict, dict]:
    """``({(event, label): StreamOutputs}, {label: timing})`` for the
    surge and removal events: both compiled at key 0 and run as the two
    lanes of one run per strategy on seed 1's topology at key 11, as the
    reference's ``_event_suite``; smoke runs its first two strategies."""
    dev = resolve_device(device)
    cfg = conf.cfg
    rtt = make_topology(1, N_LBS, N_INSTANCES, device=dev).lb_instance_rtt()
    S = len(EVENTS)
    drivers = stack_drivers([compile_scenario(s, cfg, 0, device=dev)
                             for s in legacy_event_scenarios(cfg)])
    rtts = rtt[None].expand(S, *rtt.shape).contiguous()
    keys = prand.prng_key(11, dev)[None].expand(S, 2).contiguous()
    runs, timings = {}, {}
    for label, kw in (STRATEGIES[:2] if conf.smoke else STRATEGIES):
        out, timings[label] = run_lanes(label, kw, rtts, keys, drivers, conf,
                                        dev)
        for i, event in enumerate(EVENTS):
            runs[(event, label)] = lane(out, i)
    return runs, timings


def event_payload(runs: dict, event: str, conf: SuiteConfig) -> dict:
    """The reference's ``_event_run`` payload: per strategy the rolling
    QoS before the event, its worst value over three windows after it,
    the steady level of the last 20 s, the recovery time, and the
    accumulator's event window (``acc_window``)."""
    cfg = conf.cfg
    T = cfg.num_steps
    win = int(cfg.window / cfg.dt)
    out = {}
    for (ev, label), o in runs.items():
        if ev != event:
            continue
        roll = rolling_qos_series(o.series, win)
        pre = roll[T // 2 - win:T // 2].mean()
        dip = roll[T // 2:T // 2 + 3 * win].min()
        # never reach back past the event (smoke horizons are short)
        tail_steps = min(int(20 / cfg.dt), T - T // 2)
        tail = roll[-tail_steps:].mean()
        post = roll[T // 2:]
        rec_idx = int(np.argmax(post >= 0.95 * tail))
        out[label] = {"pre": float(pre), "dip": float(dip),
                      "post_steady": float(tail),
                      "recovery_s": rec_idx * cfg.dt}
        rec = event_recovery(o.acc, cfg.ev_bucket)
        if rec:
            out[label]["acc_window"] = rec[0]
    return out


def fig10_client_surge(events: dict, conf: SuiteConfig) -> dict:
    return event_payload(events, "surge", conf)


def fig11_instance_removal(events: dict, conf: SuiteConfig) -> dict:
    return event_payload(events, "removal", conf)


def regret_curve(suite: Suite) -> dict:
    """§V-E empirics: cumulative regret growth exponent (<1 sublinear)."""
    out = {}
    for label, _ in STRATEGIES:
        reg = cumulative_regret_series(_first(suite, label).series)
        t = np.arange(1, len(reg) + 1)
        sl = slice(len(reg) // 4, None)
        slope = np.polyfit(np.log(t[sl]), np.log(reg[sl] + 1e-9), 1)[0]
        out[label] = {"total_regret": float(reg[-1]),
                      "late_growth_exponent": float(slope)}
    return out


def suite_timings(suite: Suite) -> dict:
    """Per strategy: the seconds of its run over every seed's lane and
    the grid's steps/s (lanes x steps / seconds)."""
    out = {}
    for label, _ in STRATEGIES:
        t = suite.timings[label]
        out[label] = {"run_s": t["seconds"], "scenarios": t["lanes"],
                      "grid_steps_per_s": t["grid_steps_per_s"]}
    return out


FIGURES = (suite_timings, fig3_qos_success, fig4_fairness, fig5_per_client,
           fig6_rolling_qos, fig7_request_distribution, fig8_p90_latency,
           fig9_single_lb, fig10_client_surge, fig11_instance_removal,
           regret_curve)
# these read get_events' runs, the others the suite
EVENT_FIGURES = (fig10_client_surge, fig11_instance_removal)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="24 s horizon, 8 s warm-up, seeds 1-2")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    ap.add_argument("--out", metavar="DIR",
                    help="write one JSON per figure into DIR")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    suite = get_suite(dev, smoke=args.smoke)
    events = get_events(suite.config, dev)[0]
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    for fn in FIGURES:
        name = "suite_build" if fn is suite_timings else fn.__name__
        inputs = (events, suite.config) if fn in EVENT_FIGURES else (suite,)
        t0 = time.perf_counter()
        payload = fn(*inputs)
        us = (time.perf_counter() - t0) * 1e6
        provenance.stamp(payload, suite.config.cfg, device=dev, extra={
            "benchmark": name, "us_per_call": us, "device": suite.device,
            "torch": torch.__version__, "smoke": suite.config.smoke,
            "horizon_s": suite.config.cfg.horizon,
            "seeds": list(suite.config.seeds)})
        print(json.dumps(payload), flush=True)
        if args.out:
            with open(os.path.join(args.out, f"{name}.json"), "w") as f:
                json.dump(payload, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
