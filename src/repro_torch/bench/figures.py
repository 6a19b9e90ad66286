"""The paper's evaluation suite (§VII-A6) on the card: Figs 3-9 and the
regret curve.

Twin of the JAX package's harness, ``benchmarks/common.py``'s suite and
``benchmarks/figures.py``: the same four strategies on the paper's
30 x 10 testbed over seeds, each lane the reference's (topology
``make_topology(seed)``, key ``prng_key(100 + seed)``, constant
drivers, streaming metrics), and one payload function per figure that
returns the reference's dict. The lanes run one after another; each
records its seconds, steps/s and the launches of the port's counted
kernels.

    python -m repro_torch.bench.figures [--smoke] [--device cpu] [--out DIR]

prints each figure's payload as one JSON line, stamped with a
``provenance`` block (figure, compute time, device, torch, config);
with ``--out`` it also writes ``DIR/<figure>.json``. Figs 10-11 need
the scenario compiler (ROADMAP A7).
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

from repro_torch.continuum import (SimConfig, client_qos_satisfaction_stream,
                                   cumulative_regret_series,
                                   jain_fairness_stream, make_topology,
                                   neutral_drivers, per_client_success_stream,
                                   per_lb_request_distribution_stream,
                                   proc_latency_quantile_stream,
                                   request_rate_per_instance_stream,
                                   rolling_qos_series, run_sim_stream)
from repro_torch.core import prand
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kernel_ops

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
    lanes: dict         # (seed, label) -> seconds, steps/s, kernel launches
    device: str         # the card's name, or "cpu"


def _launches() -> dict:
    return {fn.__name__: fn.launches for fn in kernel_ops.WRAPPERS}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def get_suite(device=None, seeds=None, horizon: float | None = None,
              smoke: bool = False) -> Suite:
    """Every (seed, strategy) lane of the evaluation grid, one after
    another, on ``device`` (default ``cuda``). ``seeds`` and
    ``horizon`` override ``configure(smoke)``'s; the warm-up stays the
    first third of the horizon."""
    base = configure(smoke)
    conf = _config(base.cfg.horizon if horizon is None else horizon,
                   base.seeds if seeds is None else seeds, smoke)
    dev = resolve_device(device)
    cfg, T = conf.cfg, conf.cfg.num_steps
    runs, topos, lanes = {}, {}, {}
    for seed in conf.seeds:
        topos[seed] = make_topology(seed, N_LBS, N_INSTANCES, device=dev)
        rtt = topos[seed].lb_instance_rtt()
        # the reference compiles the `baseline` scenario: constant fills
        drivers = neutral_drivers(cfg, N_LBS, N_INSTANCES, device=dev)
        for label, kw in STRATEGIES:
            before = _launches()
            _sync(dev)
            t0 = time.perf_counter()
            runs[(seed, label)] = run_sim_stream(
                strategy_name(label), rtt, cfg, prand.prng_key(100 + seed, dev),
                drivers=drivers, warmup_steps=conf.warm, device=dev, **kw)
            _sync(dev)
            secs = time.perf_counter() - t0
            after = _launches()
            lanes[(seed, label)] = dict(
                seconds=secs, steps_per_s=T / secs,
                launches={k: after[k] - before[k] for k in after})
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return Suite(conf, runs, topos, lanes, name)


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


def fig10_client_surge(suite: Suite) -> dict:
    raise NotImplementedError("Fig 10 needs the scenario compiler, not "
                              "ported to repro_torch yet (ROADMAP A7)")


def fig11_instance_removal(suite: Suite) -> dict:
    raise NotImplementedError("Fig 11 needs the scenario compiler, not "
                              "ported to repro_torch yet (ROADMAP A7)")


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
    """Per strategy: run seconds over all seeds and steps/s."""
    T = suite.config.cfg.num_steps
    out = {}
    for label, _ in STRATEGIES:
        secs = sum(suite.lanes[(s, label)]["seconds"]
                   for s in suite.config.seeds)
        n = len(suite.config.seeds)
        out[label] = {"run_s": secs, "scenarios": n,
                      "grid_steps_per_s": n * T / secs}
    return out


FIGURES = (suite_timings, fig3_qos_success, fig4_fairness, fig5_per_client,
           fig6_rolling_qos, fig7_request_distribution, fig8_p90_latency,
           fig9_single_lb, regret_curve)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="24 s horizon, 8 s warm-up, seeds 1-2")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    ap.add_argument("--out", metavar="DIR",
                    help="write one JSON per figure into DIR")
    args = ap.parse_args(argv)
    suite = get_suite(args.device, smoke=args.smoke)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    for fn in FIGURES:
        name = "suite_build" if fn is suite_timings else fn.__name__
        t0 = time.perf_counter()
        payload = fn(suite)
        us = (time.perf_counter() - t0) * 1e6
        payload["provenance"] = {
            "benchmark": name, "us_per_call": us, "device": suite.device,
            "torch": torch.__version__, "smoke": suite.config.smoke,
            "horizon_s": suite.config.cfg.horizon,
            "seeds": list(suite.config.seeds)}
        print(json.dumps(payload), flush=True)
        if args.out:
            with open(os.path.join(args.out, f"{name}.json"), "w") as f:
                json.dump(payload, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
