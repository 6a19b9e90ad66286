"""Declarative non-stationarity: scenarios compile to driver arrays.

Port of ``repro/continuum/scenarios.py``. A ``Scenario`` is a
topology spec plus an ordered tuple of typed timeline events;
``compile_scenario`` lowers the events on the host, in numpy, into
dense per-step ``Drivers``: the engine's only view of a scenario. Per
step ``t`` the engine forms the effective RTT ``rtt *
rtt_scale[t][None, :] + min(rtt_cut_k[t][:, None], rtt_cut_m[t][None,
:])``, reads the ``s_m[t]`` service row, bounds the request rounds per
LB by ``n_clients[t]`` and fires Alg 3/4 placement events when
``active[t]`` changes. ``marks`` are event-onset step indices
(``-1``-padded to ``MAX_MARKS``) for the recovery windows of the
accumulator. ``stack_drivers`` stacks compiled scenarios into the (S,
·) batch that lane-batched runs take. A ``TenantScenario`` holds one
timeline per tenant of a shared fleet; ``compile_tenant_scenario``
merges them into drivers whose ``n_clients`` is (T, NT, K).

Stochastic events draw from ``fold_in(key, event_index)`` through
``core.prand``, which replays ``jax.random``: the same key compiles the
same arrays as the reference, bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from dataclasses import dataclass
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import prand
from repro_torch.device import resolve_device

# Fixed mark-array width so compiled scenarios stack into lane batches;
# -1 is the "no event" sentinel the accumulator drops.
MAX_MARKS = 32
# Floor for per-instance service time after all slowdowns compose.
MIN_SERVICE_TIME = 1e-4


class Drivers(NamedTuple):
    n_clients: torch.Tensor   # (T, K) i32 active client slots per LB
    active: torch.Tensor      # (T, M) bool instance liveness
    rtt_scale: torch.Tensor   # (T, M) f32 multiplicative column RTT scale
    rtt_cut_k: torch.Tensor   # (T, K) f32 partition penalty, LB side [s]
    rtt_cut_m: torch.Tensor   # (T, M) f32 partition penalty, instance side [s]
    s_m: torch.Tensor         # (T, M) f32 per-instance service time [s]
    marks: torch.Tensor       # (E,)  i32 event-onset steps, -1 padded


# Fields with a leading time axis (everything but marks).
STEP_FIELDS = ("n_clients", "active", "rtt_scale", "rtt_cut_k",
               "rtt_cut_m", "s_m")


def slice_drivers(drv: Drivers, lo: int, hi: int) -> Drivers:
    """Time-slice the per-step fields; marks stay whole (they are
    global step indices)."""
    return drv._replace(**{f: getattr(drv, f)[lo:hi] for f in STEP_FIELDS})


def neutral_drivers(cfg, K: int, M: int,
                    n_clients: torch.Tensor | None = None,
                    active: torch.Tensor | None = None,
                    base_clients: int = 4,
                    service_time: float | None = None,
                    device=None) -> Drivers:
    """Constant-filled drivers: ``base_clients`` per LB, every instance
    live, RTT scale 1, no cut, constant service time. ``n_clients`` /
    ``active`` override the constant fill. Tensors live on ``device``
    (default ``cuda``)."""
    dev = resolve_device(device)
    T = cfg.num_steps
    if n_clients is None:
        n_clients = torch.full((T, K), base_clients, dtype=torch.int32,
                               device=dev)
    if active is None:
        active = torch.ones(T, M, dtype=torch.bool, device=dev)
    s = cfg.service_time if service_time is None else service_time
    return Drivers(
        n_clients=n_clients.to(dev),
        active=active.to(dev),
        rtt_scale=torch.ones(T, M, dtype=torch.float32, device=dev),
        rtt_cut_k=torch.zeros(T, K, dtype=torch.float32, device=dev),
        rtt_cut_m=torch.zeros(T, M, dtype=torch.float32, device=dev),
        s_m=torch.full((T, M), s, dtype=torch.float32, device=dev),
        marks=torch.full((MAX_MARKS,), -1, dtype=torch.int32, device=dev),
    )


def stack_drivers(drivers: Sequence[Drivers]) -> Drivers:
    """Stack compiled scenarios into an (S, ·) lane batch (tenant
    drivers' (T, NT, K) schedules into (S, T, NT, K))."""
    return Drivers(*(torch.stack(xs) for xs in zip(*drivers)))


# ---------------------------------------------------------------------------
# Events. Each event edits the (numpy) driver arrays over its window
# and reports its onset step(s) as recovery-metric marks. Events apply
# in scenario order, so later events compose on top of earlier ones
# (a ServiceSlowdown over a LinkDegrade multiplies both effects).
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Event:
    start: float = 0.0          # event onset [s]

    def marks(self, cfg) -> list[int]:
        return [int(round(self.start / cfg.dt))]

    def apply(self, arrs: dict, cfg, K: int, M: int, key) -> None:
        raise NotImplementedError


def _window(cfg, T: int, start: float, stop: float) -> tuple[int, int]:
    lo = max(0, min(T, int(round(start / cfg.dt))))
    hi = T if math.isinf(stop) else max(lo, min(T, int(round(stop / cfg.dt))))
    return lo, hi


def _pick(key, n: int, count: int, explicit) -> np.ndarray:
    """Explicit index tuple, or a key-deterministic choice of `count`
    (``jax.random.choice`` without replacement, as ``prand.choice``)."""
    if explicit is not None:
        return np.asarray(explicit, np.int32)
    count = max(1, min(n, count))
    return np.asarray(prand.choice(key, n, count).numpy(), np.int32)


@dataclass(frozen=True)
class LoadSurge(Event):
    """Extra clients on a subset of LBs in [start, stop); optional
    linear ramp-in over ``ramp`` seconds (flash crowds ramp, step
    surges don't)."""
    stop: float = math.inf
    extra: int = 2
    lbs: tuple[int, ...] | None = None   # explicit LB ids, else…
    fraction: float = 0.5                # …key-chosen fraction of K
    ramp: float = 0.0

    def apply(self, arrs, cfg, K, M, key):
        lo, hi = _window(cfg, arrs["T"], self.start, self.stop)
        sel = _pick(key, K, int(round(self.fraction * K)), self.lbs)
        t = (np.arange(lo, hi) - lo) * cfg.dt
        f = np.clip(t / self.ramp, 0.0, 1.0) if self.ramp > 0 else np.ones_like(t)
        arrs["n_clients"][lo:hi, sel] += np.rint(
            self.extra * f)[:, None].astype(np.int64)


@dataclass(frozen=True)
class DiurnalWave(Event):
    """Fleet-wide sinusoidal load: ±amplitude clients on every LB."""
    stop: float = math.inf
    period: float = 60.0
    amplitude: float = 2.0
    phase: float = 0.0           # fraction of a period

    def apply(self, arrs, cfg, K, M, key):
        lo, hi = _window(cfg, arrs["T"], self.start, self.stop)
        t = (np.arange(lo, hi) - lo) * cfg.dt
        delta = np.rint(self.amplitude * np.sin(
            2.0 * np.pi * (t / self.period + self.phase))).astype(np.int64)
        arrs["n_clients"][lo:hi] += delta[:, None]


@dataclass(frozen=True)
class ClientChurn(Event):
    """Per-LB clamped random walk: each step a client joins/leaves an
    LB with probability ``rate * dt`` each, clamped to ±max_delta
    around the base level (mobile clients roaming in and out)."""
    stop: float = math.inf
    rate: float = 0.5            # churn events per LB per second
    max_delta: int = 2

    def marks(self, cfg) -> list[int]:
        return []                # continuous churn has no onset to recover from

    def apply(self, arrs, cfg, K, M, key):
        lo, hi = _window(cfg, arrs["T"], self.start, self.stop)
        n = hi - lo
        if n <= 0:
            return
        p = min(0.5, self.rate * cfg.dt)
        u = prand.uniform(key, (n, K)).numpy()
        step = np.where(u < p, -1, np.where(u > 1.0 - p, 1, 0))
        walk = np.empty((n, K), np.int64)
        acc = np.zeros((K,), np.int64)
        for i in range(n):       # host-side compile: a true clamped walk
            acc = np.clip(acc + step[i], -self.max_delta, self.max_delta)
            walk[i] = acc
        arrs["n_clients"][lo:hi] += walk


@dataclass(frozen=True)
class InstanceKill(Event):
    """Instances go dark in [start, stop) (inf = never restored)."""
    stop: float = math.inf
    instances: tuple[int, ...] = (0,)

    def apply(self, arrs, cfg, K, M, key):
        lo, hi = _window(cfg, arrs["T"], self.start, self.stop)
        arrs["active"][lo:hi, np.asarray(self.instances)] = False


@dataclass(frozen=True)
class InstanceRestore(Event):
    """Instances come (back) online from ``start`` on; composes over
    an earlier open-ended InstanceKill."""
    instances: tuple[int, ...] = (0,)

    def apply(self, arrs, cfg, K, M, key):
        lo, _ = _window(cfg, arrs["T"], self.start, math.inf)
        arrs["active"][lo:, np.asarray(self.instances)] = True


@dataclass(frozen=True)
class Autoscale(Event):
    """Staggered capacity change: the listed instances come online
    ("up") or drain ("down") one at a time, evenly spaced across
    [start, stop]. "up" instances are offline from t=0 until their
    onset: they are the new replicas the autoscaler adds."""
    stop: float = 60.0
    instances: tuple[int, ...] = (0,)
    direction: str = "up"

    def _onsets(self, cfg) -> list[tuple[int, float]]:
        n = len(self.instances)
        span = max(self.stop - self.start, 0.0)
        return [(inst, self.start + span * i / max(n - 1, 1))
                for i, inst in enumerate(self.instances)]

    def marks(self, cfg) -> list[int]:
        return [int(round(t / cfg.dt)) for _, t in self._onsets(cfg)]

    def apply(self, arrs, cfg, K, M, key):
        if self.direction not in ("up", "down"):
            raise ValueError(f"Autoscale direction {self.direction!r}")
        T = arrs["T"]
        for inst, t in self._onsets(cfg):
            at = max(0, min(T, int(round(t / cfg.dt))))
            if self.direction == "up":
                arrs["active"][:at, inst] = False
                arrs["active"][at:, inst] = True
            else:
                arrs["active"][at:, inst] = False


@dataclass(frozen=True)
class RttDrift(Event):
    """Mobility-style global RTT drift: every link ramps linearly from
    1x to ``factor``x across [start, stop], held after (``hold``) or
    snapped back (handover complete)."""
    stop: float = math.inf
    factor: float = 1.5
    hold: bool = True

    def apply(self, arrs, cfg, K, M, key):
        T = arrs["T"]
        lo, hi = _window(cfg, T, self.start, self.stop)
        n = hi - lo
        if n > 0:
            ramp = 1.0 + (self.factor - 1.0) * (np.arange(n) / max(n - 1, 1))
            arrs["rtt_scale"][lo:hi] *= ramp[:, None]
        if self.hold:
            arrs["rtt_scale"][hi:] *= self.factor


@dataclass(frozen=True)
class LinkDegrade(Event):
    """Congestion on the links into specific instances: their RTT
    column scales by ``factor`` for the window."""
    stop: float = math.inf
    instances: tuple[int, ...] = (0,)
    factor: float = 3.0

    def apply(self, arrs, cfg, K, M, key):
        lo, hi = _window(cfg, arrs["T"], self.start, self.stop)
        arrs["rtt_scale"][lo:hi, np.asarray(self.instances)] *= self.factor


@dataclass(frozen=True)
class Partition(Event):
    """Network partition: routes from ``lbs`` to ``instances`` gain
    ``penalty`` seconds (far above tau: unreachable for QoS purposes)
    until the heal at ``stop``; a request routed there fails. Factored
    as min(cut_k, cut_m): only the LB-instance intersection pays."""
    stop: float = math.inf
    lbs: tuple[int, ...] = ()
    instances: tuple[int, ...] = ()
    penalty: float = 10.0

    def apply(self, arrs, cfg, K, M, key):
        lo, hi = _window(cfg, arrs["T"], self.start, self.stop)
        k_idx = np.asarray(self.lbs, np.int32)
        m_idx = np.asarray(self.instances, np.int32)
        arrs["rtt_cut_k"][lo:hi, k_idx] = np.maximum(
            arrs["rtt_cut_k"][lo:hi, k_idx], self.penalty)
        arrs["rtt_cut_m"][lo:hi, m_idx] = np.maximum(
            arrs["rtt_cut_m"][lo:hi, m_idx], self.penalty)


@dataclass(frozen=True)
class ServiceSlowdown(Event):
    """Per-instance throttling: s_m multiplies by ``factor`` for the
    window (noisy neighbour, thermal throttling, or, with
    start=0/stop=inf, statically heterogeneous hardware)."""
    stop: float = math.inf
    instances: tuple[int, ...] = (0,)
    factor: float = 2.0

    def apply(self, arrs, cfg, K, M, key):
        lo, hi = _window(cfg, arrs["T"], self.start, self.stop)
        arrs["s_m"][lo:hi, np.asarray(self.instances)] *= self.factor


# ---------------------------------------------------------------------------
# Scenario + compiler.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Scenario:
    """Topology spec + ordered event timeline. ``n_nodes`` is K (one LB
    per node), ``n_instances`` is M; ``base_clients`` fills
    ``n_clients`` before events edit it."""
    name: str
    events: tuple = ()
    n_nodes: int = 30
    n_instances: int = 10
    base_clients: int = 4
    description: str = ""


def with_standby(scn: Scenario, count: int) -> Scenario:
    """Widen a scenario's fleet by ``count`` standby instances.

    The new instances take the last indices of the widened M, so every
    event of the timeline keeps hitting exactly the instances it did
    before: the standby pool is untouched capacity (the closed-loop
    study's topology helper in the reference)."""
    if count < 0:
        raise ValueError(f"standby count must be >= 0, got {count}")
    return dataclasses.replace(
        scn, n_instances=scn.n_instances + count,
        description=(scn.description +
                     f" [+{count} standby instances]" if count else
                     scn.description))


def compile_scenario(scn: Scenario, cfg, key, device=None) -> Drivers:
    """Lower a scenario to dense driver arrays on ``device`` (default
    ``cuda``).

    ``key`` is a (2,) key tensor or an integer seed. Deterministic
    under a fixed key: event i draws from ``fold_in(key, i)``. The
    arrays are built in numpy on the host, as in the reference, with
    its post-conditions enforced, not trusted from events: ``0 <=
    n_clients <= cfg.max_clients``, ``s_m >= MIN_SERVICE_TIME``,
    ``rtt_scale > 0``, cuts ``>= 0``, and at least one instance alive
    at every step (ValueError otherwise: a dead fleet is a spec bug).
    """
    dev = resolve_device(device)
    key = (prand.prng_key(key) if isinstance(key, int)
           else torch.as_tensor(key, dtype=torch.int64).cpu())
    T, K, M = cfg.num_steps, scn.n_nodes, scn.n_instances
    arrs = {
        "T": T,
        "n_clients": np.full((T, K), scn.base_clients, np.int64),
        "active": np.ones((T, M), bool),
        "rtt_scale": np.ones((T, M), np.float64),
        "rtt_cut_k": np.zeros((T, K), np.float64),
        "rtt_cut_m": np.zeros((T, M), np.float64),
        "s_m": np.full((T, M), cfg.service_time, np.float64),
    }
    marks: list[int] = []
    for i, ev in enumerate(scn.events):
        ev.apply(arrs, cfg, K, M, prand.fold_in(key, i))
        marks.extend(m for m in ev.marks(cfg) if 0 <= m < T)

    # The factored partition cut is a rank-1 AND: two partitions that
    # overlap in time with different LB/instance sets also penalize
    # the cross routes between them. Never let that happen silently.
    parts = [e for e in scn.events if isinstance(e, Partition)]
    for i, a in enumerate(parts):
        for b in parts[i + 1:]:
            overlap = a.start < b.stop and b.start < a.stop
            aligned = (set(a.lbs) == set(b.lbs)
                       or set(a.instances) == set(b.instances))
            if overlap and not aligned:
                warnings.warn(
                    f"scenario {scn.name!r}: partitions "
                    f"[{a.start:g},{a.stop:g}) and [{b.start:g},{b.stop:g}) "
                    f"overlap with different LB/instance sets — the "
                    f"factored min(cut_k, cut_m) also cuts the cross "
                    f"routes between their sides", stacklevel=2)

    if not arrs["active"].any(axis=1).all():
        dead = int(np.argmin(arrs["active"].any(axis=1)))
        raise ValueError(
            f"scenario {scn.name!r}: no instance alive at step {dead} "
            f"(t={dead * cfg.dt:.1f}s) — fix the kill/restore timeline")
    if (arrs["rtt_scale"] <= 0).any():
        raise ValueError(f"scenario {scn.name!r}: non-positive rtt_scale")

    marks = sorted(set(marks))
    if len(marks) > MAX_MARKS:
        warnings.warn(
            f"scenario {scn.name!r}: {len(marks)} event marks exceed "
            f"MAX_MARKS={MAX_MARKS}; recovery windows only cover the "
            f"first {MAX_MARKS} onsets", stacklevel=2)
        marks = marks[:MAX_MARKS]
    marks_arr = np.full((MAX_MARKS,), -1, np.int64)
    marks_arr[:len(marks)] = marks

    def put(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(dev)

    return Drivers(
        n_clients=put(np.clip(arrs["n_clients"], 0, cfg.max_clients),
                      np.int32),
        active=put(arrs["active"], np.bool_),
        rtt_scale=put(arrs["rtt_scale"], np.float32),
        rtt_cut_k=put(arrs["rtt_cut_k"], np.float32),
        rtt_cut_m=put(arrs["rtt_cut_m"], np.float32),
        s_m=put(np.maximum(arrs["s_m"], MIN_SERVICE_TIME), np.float32),
        marks=put(marks_arr, np.int32),
    )


# ---------------------------------------------------------------------------
# Multi-tenant scenarios: NT per-tenant timelines merged onto ONE fleet.
#
# The tenant engine takes the same Drivers with one change: ``n_clients``
# gains a tenant axis, (T, NT, K), one client schedule per service. The
# shared-infrastructure fields stay (T, ·): tenants ride the same
# instances, links and hardware, so each timeline's infra events merge
# pessimally (any tenant's kill, slowdown or partition hits the shared
# fleet) while its load events stay scoped to that tenant's clients.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TenantScenario:
    """One :class:`Scenario` timeline per tenant over one shared fleet.
    Every timeline targets the same (n_nodes, n_instances); each
    tenant's ``base_clients`` and load events shape its own
    ``n_clients[:, s, :]``, and infra events from any tenant apply
    fleet-wide (``tenant_drivers``' merge rules)."""
    name: str
    tenants: tuple[Scenario, ...]
    description: str = ""


def broadcast_tenants(drv: Drivers, S: int) -> Drivers:
    """Give all S tenants one shared (T, K) client schedule: the
    single-tenant drivers with ``n_clients`` broadcast to (T, S, K).
    Demand multiplies by S."""
    if drv.n_clients.dim() != 2:
        raise ValueError(
            f"broadcast_tenants expects single-tenant (T, K) n_clients, "
            f"got {tuple(drv.n_clients.shape)}")
    T, K = drv.n_clients.shape
    return drv._replace(n_clients=drv.n_clients[:, None, :].expand(
        T, S, K).contiguous())


def tenant_neutral_drivers(cfg, S: int, K: int, M: int,
                           base_clients: int = 1,
                           service_time: float | None = None,
                           device=None) -> Drivers:
    """Neutral multi-tenant drivers: every tenant runs ``base_clients``
    constant clients per LB on an undisturbed fleet (total demand S x
    base_clients x K x 1/dt req/s)."""
    return broadcast_tenants(
        neutral_drivers(cfg, K, M, base_clients=base_clients,
                        service_time=service_time, device=device), S)


def tenant_drivers(per_tenant: Sequence[Drivers]) -> Drivers:
    """Merge single-tenant driver sets onto one shared fleet, on the
    host in numpy:

    * ``n_clients`` stacks into (T, NT, K): load stays tenant-scoped;
    * ``active`` ANDs: an instance any timeline kills is dead for all;
    * ``rtt_scale``, ``rtt_cut_k``, ``rtt_cut_m`` and ``s_m`` take the
      elementwise max: the worst modulation any timeline applies;
    * ``marks`` union, sorted and -1-padded to ``MAX_MARKS``.

    The result lives on the first drivers' device."""
    S = len(per_tenant)
    if S < 1:
        raise ValueError("tenant_drivers needs at least one tenant")
    shapes = {tuple(d.n_clients.shape) for d in per_tenant}
    if len(shapes) != 1 or per_tenant[0].n_clients.dim() != 2:
        raise ValueError(
            f"per-tenant drivers must share one (T, K) n_clients "
            f"shape, got {sorted(shapes)}")
    if len({tuple(d.active.shape) for d in per_tenant}) != 1:
        raise ValueError("per-tenant drivers must share one fleet shape")
    dev = per_tenant[0].active.device

    def npf(x):
        return x.cpu().numpy()

    active = np.logical_and.reduce([npf(d.active) for d in per_tenant])
    if not active.any(axis=1).all():
        dead = int(np.argmin(active.any(axis=1)))
        raise ValueError(
            f"merged tenant timelines leave no instance alive at step "
            f"{dead}: fix the kill/restore timelines")
    mk = np.concatenate([npf(d.marks) for d in per_tenant])
    mk = np.unique(mk[mk >= 0])
    if len(mk) > MAX_MARKS:
        warnings.warn(
            f"merged tenant timelines carry {len(mk)} event marks; "
            f"recovery windows only cover the first {MAX_MARKS}",
            stacklevel=2)
        mk = mk[:MAX_MARKS]
    marks_arr = np.full((MAX_MARKS,), -1, np.int64)
    marks_arr[:len(mk)] = mk

    def put(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(dev)

    def worst(field):
        return put(np.maximum.reduce([npf(getattr(d, field))
                                      for d in per_tenant]), np.float32)

    return Drivers(
        n_clients=torch.stack([d.n_clients.to(dev) for d in per_tenant],
                              dim=1),
        active=put(active, np.bool_),
        rtt_scale=worst("rtt_scale"),
        rtt_cut_k=worst("rtt_cut_k"),
        rtt_cut_m=worst("rtt_cut_m"),
        s_m=worst("s_m"),
        marks=put(marks_arr, np.int32),
    )


def compile_tenant_scenario(tscn: TenantScenario, cfg, key,
                            device=None) -> Drivers:
    """Compile each tenant's timeline and merge them onto the shared
    fleet. Tenant i compiles under ``fold_in(key, i)`` (``key`` a (2,)
    key tensor or an integer seed), so its stochastic events are
    independent across tenants and stable when other tenants'
    timelines change."""
    base = tscn.tenants[0]
    for s in tscn.tenants[1:]:
        if (s.n_nodes, s.n_instances) != (base.n_nodes, base.n_instances):
            raise ValueError(
                f"tenant scenario {tscn.name!r}: every tenant timeline "
                f"must target the same shared fleet (got "
                f"{(s.n_nodes, s.n_instances)} vs "
                f"{(base.n_nodes, base.n_instances)})")
    key = (prand.prng_key(key) if isinstance(key, int)
           else torch.as_tensor(key, dtype=torch.int64).cpu())
    return tenant_drivers([
        compile_scenario(s, cfg, prand.fold_in(key, i), device=device)
        for i, s in enumerate(tscn.tenants)])
