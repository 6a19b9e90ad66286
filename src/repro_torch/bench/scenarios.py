"""The scenario library on the card: every named non-stationarity regime
as the lanes of one run per strategy or policy, with QoS, event-recovery,
request-lifecycle and control columns.

Twin of the JAX package's ``benchmarks/scenario_suite.py``, on the
paper's 30 x 10 testbed, seed 1's topology for every lane and one run
key (11) for every lane so that scenarios share the noise stream:

* the open-loop rows: the library (``get_library``), lane i compiled at
  key ``500 + i``, under the contrast pair ``qedgeproxy`` and
  ``proxy_mity_1.0``; per scenario and strategy clients >= rho (%),
  Jain fairness, the number of events, the worst dip and the slowest
  recovery from ``event_recovery``;
* ``graceful_degradation``: the resilience probes (lane i compiled at
  ``600 + i``) at tau = 150 ms under the five request-lifecycle
  ``DEGRADE_POLICIES`` (neutral, deadline-bounded retries with and
  without breakers, naive unbounded retries, a timeout inside the
  healthy band), each policy one ``qedgeproxy`` run; the cells add the
  attempt, retry, timeout and drop counts and the breakers' open share;
* ``closed_loop``: the overload probes on a fleet widened by
  ``CONTROL_STANDBY`` parked instances (``with_standby``, lane i
  compiled at ``700 + i``) under the eight ``CONTROL_POLICIES`` (parked
  standby, three autoscalers, admission, both, migration, a pre-warmed
  fleet), every row on ``CONTROL_RES``'s bounded lifecycle at tau = 80
  ms; the cells add the drop rate, the per-player QoS spread and the
  control counters' readouts;
* ``multi_tenant``: ``MT_TENANTS`` services on the one fleet
  (``TenancyConfig(MT_TAUS, interference=MT_INTERFERENCE)``,
  ``MT_BASE_CLIENTS`` clients per LB per tenant), the tenant library
  (``get_tenant_library``; lane i compiled at ``800 + i``) as the lanes
  of one run per ``MT_POLICIES`` entry; the cells are
  ``obs.registry.tenant_cell``: per-tenant QoS columns, cross-tenant
  fairness and partition indices.

Each strategy or policy records its seconds and ``grid_steps_per_s``
(lanes x steps / seconds).

    python -m repro_torch.bench.scenarios [--smoke] [--horizon S] [--device cpu]

prints the ``scenario_suite`` payload as one JSON line and the
``multi_tenant`` payload as another (each stamped), then the timings
as a third; smoke runs the reference's smoke scenario sets at the 24 s
smoke horizon. The reference gates its smoke tenant grid on
``MT_SMOKE_FLOOR`` grid steps/s (XLA's one compiled step); the port's
step is bound by host dispatch, so its figure is printed beside that
floor on standard error and not gated.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time

import torch

from repro_torch.bench import figures
from repro_torch.continuum import (ControlConfig, TenancyConfig,
                                   compile_scenario, compile_tenant_scenario,
                                   get_library, get_tenant_library, lane,
                                   make_topology, stack_drivers, with_standby)
from repro_torch.core import prand
from repro_torch.device import resolve_device
from repro_torch.obs import provenance, registry

# contrast pair: the adaptive balancer against static proximity
SUITE_STRATEGIES = (("qedgeproxy", {}), ("proxy_mity_1.0", dict(alpha=1.0)))
SMOKE_SCENARIOS = ("baseline", "surge", "cascade_failure", "everything")
COMPILE_KEY0, RUN_KEY, TOPOLOGY_SEED = 500, 11, 1

# graceful-degradation lane: scenarios x request-lifecycle policies
DEGRADE_SCENARIOS = ("retry_storm", "metastable_overload", "flash_crowd")
SMOKE_DEGRADE_SCENARIOS = ("retry_storm",)
DEGRADE_POLICIES = (
    ("neutral", {}),
    ("bounded", dict(attempt_timeout=0.090, max_retries=2,
                     retry_backoff=0.002, breaker_threshold=5,
                     breaker_cooldown=1.0)),
    ("bounded_nobrk", dict(attempt_timeout=0.090, max_retries=2,
                           retry_backoff=0.002)),
    ("naive", dict(attempt_timeout=0.090, max_retries=5,
                   retry_deadline=False)),
    # the bounded policy with its timeout inside the healthy latency band
    ("tight", dict(attempt_timeout=0.070, max_retries=2,
                   retry_backoff=0.002, breaker_threshold=5,
                   breaker_cooldown=1.0)),
)
DEGRADE_TAU = 0.150
DEGRADE_KEY0 = 600

# closed-loop lane: controller x scenario grid at the paper's tau, the
# base fleet plus CONTROL_STANDBY parked instances (appended last, where
# ControlConfig.managed points), every row on the bounded lifecycle
CONTROL_SCENARIOS = ("retry_storm", "metastable_overload",
                     "sustained_overload", "surge", "cascade_failure")
SMOKE_CONTROL_SCENARIOS = ("retry_storm", "metastable_overload")
CONTROL_STANDBY = 4
CONTROL_RES = dict(attempt_timeout=0.055, max_retries=2,
                   retry_backoff=0.002, breaker_threshold=4,
                   breaker_cooldown=1.0)
_AUTOSCALE = dict(managed=CONTROL_STANDBY, warmup=1.0, up_queue=2.0,
                  down_queue=0.5, hold=0.4, action_cooldown=2.0, batch=2)
# a standby pool nothing ever spawns: the open-loop floor
_PARKED = dict(managed=CONTROL_STANDBY, up_queue=math.inf,
               down_queue=-1.0)
CONTROL_POLICIES = (
    ("static", ControlConfig(**_PARKED)),
    ("autoscale_fast", ControlConfig(**_AUTOSCALE)),
    ("autoscale_slow", ControlConfig(**{**_AUTOSCALE, "warmup": 4.0,
                                        "hold": 2.0,
                                        "action_cooldown": 10.0,
                                        "batch": 1})),
    # thresholds nearly touching and a short dwell: the thrash probe
    ("autoscale_narrow", ControlConfig(**{**_AUTOSCALE, "up_queue": 1.2,
                                          "down_queue": 1.0, "hold": 0.2,
                                          "action_cooldown": 1.0})),
    ("admit", ControlConfig(**_PARKED, admit=True, target_queue=1.5)),
    ("autoscale_admit", ControlConfig(**_AUTOSCALE, admit=True,
                                      target_queue=1.5)),
    ("migrate", ControlConfig(**_PARKED, regions=2)),
    # every instance live from t=0, no controller: the capacity ceiling
    ("prewarmed", None),
)
CONTROL_KEY0 = 700

# multi-tenant lane: MT_TENANTS services sharing one fleet over the
# tenant library. Tenant 0 is the tight-deadline foreground (the paper's
# tau = 80 ms), tenants 1-2 the mid class, tenant 3 the relaxed batch
# class; base_clients is per tenant, so 4 tenants x 30 LBs x 1 client
# keep the aggregate demand at the library baseline's 1200 req/s
MT_TENANTS = 4
MT_TAUS = (0.080, 0.110, 0.110, 0.150)
MT_INTERFERENCE = 0.3
MT_BASE_CLIENTS = 1
MT_POLICIES = (("qedgeproxy", {}), ("proxy_mity_1.0", dict(alpha=1.0)))
SMOKE_MT_SCENARIOS = ("mt_baseline", "mt_tenant_surge")
MT_KEY0 = 800
# the reference's smoke floor (grid steps/s), printed beside the port's
MT_SMOKE_FLOOR = 60.0


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
    rtts, keys = _lanes_inputs(len(names), K, M, dev)
    # lane i compiles at key 500 + i, as the reference keys them
    drivers = stack_drivers(
        [compile_scenario(lib[n], cfg, COMPILE_KEY0 + i, device=dev)
         for i, n in enumerate(names)])
    runs, timings = {}, {}
    for label, kw in SUITE_STRATEGIES:
        out, timings[label] = figures.run_lanes(label, kw, rtts, keys,
                                                drivers, conf, dev)
        for i, name in enumerate(names):
            runs[(name, label)] = lane(out, i)
    return dict(names=list(names), config=conf, runs=runs, timings=timings,
                device=figures.device_name(dev))


def _lanes_inputs(S: int, K: int, M: int, dev):
    """Topology 1's RTT and run key 11 for each of S lanes."""
    rtt = make_topology(TOPOLOGY_SEED, K, M, device=dev).lb_instance_rtt()
    rtts = rtt[None].expand(S, K, M).contiguous()
    keys = prand.prng_key(RUN_KEY, dev)[None].expand(S, 2).contiguous()
    return rtts, keys


def _policy_suite(policies, names, lib_fn, key0, base_cfg, conf, M, dev):
    """One ``qedgeproxy`` run of the scenario lanes per ``(label,
    cfg)`` of ``policies``: ``{"names", "config", "runs": {(name,
    label): StreamOutputs}, "timings", "device"}``; lane i compiles
    ``lib_fn(name)`` at key ``key0 + i`` (the schedules never depend on
    the policy, so every policy shares them)."""
    K = figures.N_LBS
    rtts, keys = _lanes_inputs(len(names), K, M, dev)
    drivers = stack_drivers([compile_scenario(lib_fn(n), base_cfg, key0 + i,
                                              device=dev)
                             for i, n in enumerate(names)])
    runs, timings = {}, {}
    for label, cfg in policies:
        out, timings[label] = figures.run_lanes(
            "qedgeproxy", {}, rtts, keys, drivers,
            dataclasses.replace(conf, cfg=cfg), dev)
        for i, name in enumerate(names):
            runs[(name, label)] = lane(out, i)
    return dict(names=list(names), config=conf, runs=runs, timings=timings,
                device=figures.device_name(dev))


def _suite_config(smoke: bool, horizon: float | None):
    base = figures.configure(smoke)
    return figures._config(base.cfg.horizon if horizon is None else horizon,
                           base.seeds, smoke)


def get_degradation_suite(device=None, smoke: bool = False,
                          horizon: float | None = None) -> dict:
    """The graceful-degradation lane: ``DEGRADE_SCENARIOS`` (smoke:
    ``SMOKE_DEGRADE_SCENARIOS``) as the lanes of one run per
    ``DEGRADE_POLICIES`` entry, at tau = ``DEGRADE_TAU``."""
    conf = _suite_config(smoke, horizon)
    dev = resolve_device(device)
    K, M = figures.N_LBS, figures.N_INSTANCES
    names = SMOKE_DEGRADE_SCENARIOS if smoke else DEGRADE_SCENARIOS
    lib = get_library(conf.cfg.horizon, K, M)
    base = dataclasses.replace(conf.cfg, tau=DEGRADE_TAU)
    policies = [(label, dataclasses.replace(base, **knobs))
                for label, knobs in DEGRADE_POLICIES]
    return _policy_suite(policies, names, lib.__getitem__, DEGRADE_KEY0,
                         base, conf, M, dev)


def get_control_suite(device=None, smoke: bool = False,
                      horizon: float | None = None) -> dict:
    """The closed-loop lane: ``CONTROL_SCENARIOS`` (smoke:
    ``SMOKE_CONTROL_SCENARIOS``) over the base fleet plus
    ``CONTROL_STANDBY`` parked instances as the lanes of one run per
    ``CONTROL_POLICIES`` entry, each on ``CONTROL_RES``."""
    conf = _suite_config(smoke, horizon)
    dev = resolve_device(device)
    K, M = figures.N_LBS, figures.N_INSTANCES
    names = SMOKE_CONTROL_SCENARIOS if smoke else CONTROL_SCENARIOS
    lib = get_library(conf.cfg.horizon, K, M)
    base = dataclasses.replace(conf.cfg, **CONTROL_RES)
    policies = [(label, dataclasses.replace(base, control=ctl))
                for label, ctl in CONTROL_POLICIES]
    return _policy_suite(policies, names,
                         lambda n: with_standby(lib[n], CONTROL_STANDBY),
                         CONTROL_KEY0, base, conf, M + CONTROL_STANDBY, dev)


def mt_config(base):
    """``base`` with the multi-tenant lane's ``TenancyConfig``."""
    return dataclasses.replace(base, tenancy=TenancyConfig(
        taus=MT_TAUS, interference=MT_INTERFERENCE))


def mt_inputs(device=None, smoke: bool = False, horizon: float | None = None):
    """The multi-tenant lane's inputs: ``(conf, cfg, names, rtts, keys,
    drivers)`` with ``cfg`` the tenant config, the tenant library's
    names (smoke: ``SMOKE_MT_SCENARIOS``), topology 1's RTT and run key
    11 for each lane, and lane i's drivers compiled at ``MT_KEY0 + i``."""
    conf = _suite_config(smoke, horizon)
    dev = resolve_device(device)
    K, M = figures.N_LBS, figures.N_INSTANCES
    cfg = mt_config(conf.cfg)
    lib = get_tenant_library(cfg.horizon, K, M, n_tenants=MT_TENANTS,
                             base_clients=MT_BASE_CLIENTS)
    names = [n for n in lib if not smoke or n in SMOKE_MT_SCENARIOS]
    rtts, keys = _lanes_inputs(len(names), K, M, dev)
    drivers = [compile_tenant_scenario(lib[n], cfg, MT_KEY0 + i, device=dev)
               for i, n in enumerate(names)]
    return conf, cfg, names, rtts, keys, drivers


def get_multi_tenant_suite(device=None, smoke: bool = False,
                           horizon: float | None = None) -> dict:
    """The multi-tenant lane: the tenant library (smoke:
    ``SMOKE_MT_SCENARIOS``) as the lanes of one run per ``MT_POLICIES``
    entry: ``{"names", "config", "runs": {(name, label):
    StreamOutputs}, "timings", "device"}``, every run's ``acc`` the tuple
    of its tenants' accumulators."""
    dev = resolve_device(device)
    conf, cfg, names, rtts, keys, drivers = mt_inputs(dev, smoke, horizon)
    batch = stack_drivers(drivers)
    runs, timings = {}, {}
    for label, kw in MT_POLICIES:
        out, timings[label] = figures.run_lanes(
            label, kw, rtts, keys, batch, dataclasses.replace(conf, cfg=cfg),
            dev)
        for i, name in enumerate(names):
            runs[(name, label)] = lane(out, i)
    return dict(names=names, config=conf, runs=runs, timings=timings,
                device=figures.device_name(dev))


def multi_tenant(suite: dict) -> dict:
    """The reference's ``multi_tenant`` payload: the lane's constants,
    each policy's ``grid_steps_per_s`` and ``{scenario: {policy:
    tenant_cell}}``."""
    rho = suite["config"].cfg.rho
    out = {"tenants": MT_TENANTS, "taus": list(MT_TAUS),
           "interference": MT_INTERFERENCE,
           "grid_steps_per_s": {label: t["grid_steps_per_s"]
                                for label, t in suite["timings"].items()}}
    for name in suite["names"]:
        out[name] = {label: registry.tenant_cell(suite["runs"][(name, label)],
                                                 rho=rho)
                     for label, _ in MT_POLICIES}
    return out


def stream_cell(outs, rho: float, bucket_s: float) -> dict:
    """One open-loop scenario x strategy cell of one lane's run:
    ``obs.registry.stream_cell`` with ``jain`` and ``n_events``."""
    return registry.stream_cell(outs, rho=rho, bucket_s=bucket_s, jain=True,
                                n_events=True)


def scenario_rows(suite: dict) -> dict:
    """``{scenario: {strategy: cell}}``, the open-loop rows of the
    reference's ``scenario_suite`` payload."""
    cfg = suite["config"].cfg
    return {name: {label: stream_cell(suite["runs"][(name, label)], cfg.rho,
                                      cfg.ev_bucket)
                   for label, _ in SUITE_STRATEGIES}
            for name in suite["names"]}


def graceful_degradation(suite: dict) -> dict:
    """``{scenario: {policy: cell}}`` of ``get_degradation_suite``: the
    reference payload's ``graceful_degradation`` rows."""
    cfg = suite["config"].cfg
    return {name: {label: registry.stream_cell(
        suite["runs"][(name, label)], rho=cfg.rho, bucket_s=cfg.ev_bucket,
        resilience=True,
        breaker_frac=bool(knobs.get("breaker_threshold")),
        max_recovery=False) for label, knobs in DEGRADE_POLICIES}
        for name in suite["names"]}


def closed_loop(suite: dict) -> dict:
    """``{scenario: {policy: cell}}`` of ``get_control_suite``: the
    reference payload's ``closed_loop`` rows."""
    cfg = suite["config"].cfg
    return {name: {label: registry.stream_cell(
        suite["runs"][(name, label)], rho=cfg.rho, bucket_s=cfg.ev_bucket,
        jain=True, tenants=True, drop_rate=True, control=True)
        for label, _ in CONTROL_POLICIES}
        for name in suite["names"]}


def _stamp(payload: dict, name: str, suite: dict, dev, t0: float) -> dict:
    conf = suite["config"]
    return provenance.stamp(payload, conf.cfg, device=dev, extra={
        "benchmark": name, "us_per_call": (time.perf_counter() - t0) * 1e6,
        "device": suite["device"], "torch": torch.__version__,
        "smoke": conf.smoke, "horizon_s": conf.cfg.horizon})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="24 s horizon, the reference's smoke scenarios")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    ap.add_argument("--horizon", type=float, default=None,
                    help="simulated seconds (default 180, smoke 24)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    dev = resolve_device(args.device)
    kw = dict(smoke=args.smoke, horizon=args.horizon)
    suite = get_scenario_suite(dev, **kw)
    payload = scenario_rows(suite)
    degrade = get_degradation_suite(dev, **kw)
    payload["graceful_degradation"] = graceful_degradation(degrade)
    control = get_control_suite(dev, **kw)
    payload["closed_loop"] = closed_loop(control)
    print(json.dumps(_stamp(payload, "scenario_suite", suite, dev, t0)),
          flush=True)
    t0 = time.perf_counter()
    mt = get_multi_tenant_suite(dev, **kw)
    print(json.dumps(_stamp(multi_tenant(mt), "multi_tenant", mt, dev, t0)),
          flush=True)
    print("multi_tenant grid steps/s: " + ", ".join(
        f"{label} {t['grid_steps_per_s']:.2f}"
        for label, t in mt["timings"].items())
        + f" (the reference's smoke floor: {MT_SMOKE_FLOOR:.0f}; not "
        "gated: the port's step is bound by host dispatch)",
        file=sys.stderr, flush=True)
    print(json.dumps({"timings": suite["timings"],
                      "graceful_degradation": degrade["timings"],
                      "closed_loop": control["timings"],
                      "multi_tenant": mt["timings"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
