"""The named scenario library: every dynamic regime the paper (and its
related work) argues about, as one ``Scenario`` each.

Port of ``repro/continuum/library.py``: the single-service library and
the multi-tenant one (``get_tenant_library``). Event times are fractions of the
horizon, so the same library runs at the 180 s evaluation horizon and
at a seconds-long smoke horizon; instance and LB subsets are fractions
of M and K, so the same entries drive the 30 x 10 testbed and larger
fleets. ``compile_scenario`` each entry and ``stack_drivers`` the
results to run the library as lanes (``repro_torch.bench.scenarios``).

Capacity framing (defaults, 30 x 10, s_m = 5.5 ms): demand 1200 req/s
against ~1818 req/s of capacity. ``surge`` stays under capacity;
``flash_crowd`` and ``cascade_failure`` push through it; the rest
stress the estimate (drift, partition, slowdown) rather than capacity.
"""
from __future__ import annotations

from repro_torch.continuum.scenarios import (Autoscale, ClientChurn,
                                             DiurnalWave, InstanceKill,
                                             InstanceRestore, LoadSurge,
                                             Partition, RttDrift, Scenario,
                                             ServiceSlowdown, TenantScenario)


def _frac(n: int, frac: float, lo: int = 1) -> tuple[int, ...]:
    """First max(lo, frac*n) indices: a deterministic subset."""
    return tuple(range(max(lo, int(round(frac * n)))))


def get_library(horizon: float, n_nodes: int = 30, n_instances: int = 10,
                base_clients: int = 4) -> dict[str, Scenario]:
    """The 15 named scenarios sized to ``horizon`` seconds and a K x M
    fleet, in the reference's order."""
    hz, K, M = horizon, n_nodes, n_instances
    kw = dict(n_nodes=K, n_instances=M, base_clients=base_clients)
    third_m = _frac(M, 1 / 3)
    third_k = _frac(K, 1 / 3)
    half_third = max(1, len(third_m) // 2)

    lib = [
        Scenario("baseline", (), description="stationary reference", **kw),
        Scenario(
            "surge",
            (LoadSurge(start=0.5 * hz, extra=2, fraction=0.5),),
            description="step surge on half the LBs (Fig. 10 regime)", **kw),
        Scenario(
            "flash_crowd",
            (LoadSurge(start=0.4 * hz, stop=0.6 * hz, extra=4,
                       fraction=0.8, ramp=0.05 * hz),),
            description="ramped over-capacity crowd, then gone", **kw),
        Scenario(
            "cascade_failure",
            (InstanceKill(start=0.35 * hz, instances=third_m[:half_third]),
             InstanceKill(start=0.5 * hz,
                          instances=third_m[half_third:] or third_m[:1]),
             InstanceRestore(start=0.75 * hz, instances=third_m)),
            description="two failure waves, one mass restore", **kw),
        Scenario(
            "rolling_restart",
            tuple(InstanceKill(start=(0.3 + 0.5 * i / M) * hz,
                               stop=(0.3 + 0.5 * i / M) * hz + 0.04 * hz,
                               instances=(i,))
                  for i in range(M)),
            description="every instance drains briefly, staggered", **kw),
        Scenario(
            "diurnal",
            (DiurnalWave(start=0.0, period=0.5 * hz, amplitude=2.0),),
            description="fleet-wide sinusoidal load", **kw),
        Scenario(
            "rtt_drift",
            (RttDrift(start=0.3 * hz, stop=0.7 * hz, factor=2.0),),
            description="mobility-style global RTT ramp, held", **kw),
        Scenario(
            "partition_heal",
            (Partition(start=0.4 * hz, stop=0.7 * hz,
                       lbs=third_k, instances=third_m),),
            description="a third of the LBs lose a third of the fleet,"
                        " then heal", **kw),
        Scenario(
            "hetero_slowdown",
            (ServiceSlowdown(start=0.0, instances=tuple(range(0, M, 2)),
                             factor=1.4),
             ServiceSlowdown(start=0.45 * hz, stop=0.75 * hz,
                             instances=(M - 1,), factor=3.0)),
            description="heterogeneous hardware + a mid-run throttle", **kw),
        Scenario(
            "churn",
            (ClientChurn(start=0.0, rate=0.5, max_delta=2),),
            description="per-LB clamped random-walk client churn", **kw),
        Scenario(
            "autoscale_up",
            (InstanceKill(start=0.0, instances=third_m),
             Autoscale(start=0.4 * hz, stop=0.7 * hz, instances=third_m,
                       direction="up")),
            description="start short-handed, autoscaler staggers in"
                        " replicas", **kw),
        Scenario(
            "retry_storm",
            (ServiceSlowdown(start=0.35 * hz, stop=0.65 * hz,
                             instances=_frac(M, 1 / 10), factor=6.0),),
            description="gray failure: one instance throttles 6x, slow"
                        " enough that its requests would trip an attempt"
                        " timeout, alive enough that liveness masking"
                        " never fires", **kw),
        Scenario(
            "metastable_overload",
            (LoadSurge(start=0.4 * hz, stop=0.5 * hz, extra=4,
                       fraction=0.8, ramp=0.02 * hz),),
            description="brief over-capacity trigger, then load returns"
                        " to normal: the metastable-overload probe", **kw),
        Scenario(
            "sustained_overload",
            (LoadSurge(start=0.45 * hz, extra=4, fraction=0.8,
                       ramp=0.02 * hz),),
            description="over-capacity surge that never ends: only added"
                        " capacity or admission shedding restores QoS",
            **kw),
        Scenario(
            "everything",
            (ClientChurn(start=0.0, rate=0.3, max_delta=1),
             LoadSurge(start=0.3 * hz, extra=2, fraction=0.5),
             InstanceKill(start=0.45 * hz, stop=0.75 * hz,
                          instances=third_m[:half_third]),
             RttDrift(start=0.5 * hz, stop=0.8 * hz, factor=1.5),
             ServiceSlowdown(start=0.6 * hz, stop=0.85 * hz,
                             instances=(M - 1,), factor=2.0)),
            description="surge + failure + drift + throttle + churn,"
                        " overlapping", **kw),
    ]
    return {s.name: s for s in lib}


def get_tenant_library(horizon: float, n_nodes: int = 30,
                       n_instances: int = 10, n_tenants: int = 4,
                       base_clients: int = 1) -> dict[str, TenantScenario]:
    """The four named multi-tenant scenarios, one event schedule per
    tenant over ONE shared fleet (``compile_tenant_scenario`` merges
    them into tenant-axis drivers), in the reference's order.

    Tenant 0 is the latency-sensitive foreground service (give it the
    tightest tau), the last tenant the batch hog. ``base_clients`` is
    per tenant: 4 tenants x 30 LBs x 1 client x 10 req/s = 1200 req/s,
    the single-service library's baseline demand."""
    hz, K, M, S = horizon, n_nodes, n_instances, n_tenants
    if S < 2:
        raise ValueError(f"tenant library needs >= 2 tenants, got {S}")
    kw = dict(n_nodes=K, n_instances=M, base_clients=base_clients)

    def quiet(s: int) -> Scenario:
        return Scenario(f"tenant{s}_quiet", (), description="steady", **kw)

    lib = [
        TenantScenario(
            "mt_baseline",
            tuple(quiet(s) for s in range(S)),
            description="S steady tenants sharing the fleet — do the"
                        " independent bandit fleets co-exist without"
                        " starving anyone?"),
        TenantScenario(
            "mt_tenant_surge",
            (Scenario("tenant0_surge",
                      (LoadSurge(start=0.45 * hz, stop=0.75 * hz, extra=3,
                                 fraction=0.6, ramp=0.03 * hz),),
                      description="foreground surge", **kw),)
            + tuple(quiet(s) for s in range(1, S)),
            description="one tenant surges 4x mid-run while the others"
                        " stay steady: does the surge degrade the quiet"
                        " tenants' QoS (fairness under surge)?"),
        TenantScenario(
            "mt_noisy_neighbor",
            tuple(quiet(s) for s in range(S - 1))
            + (Scenario(
                f"tenant{S - 1}_hog",
                (LoadSurge(start=0.35 * hz, extra=4, fraction=0.8,
                           ramp=0.02 * hz),
                 ServiceSlowdown(start=0.35 * hz, stop=0.8 * hz,
                                 instances=_frac(M, 1 / 5), factor=2.5)),
                description="background hog + the slowdown it causes",
                **kw),),
            description="the last tenant floods the fleet AND throttles"
                        " a fifth of the instances (cache/IO pressure):"
                        " can the foreground tenants route around the"
                        " noisy neighbor?"),
        TenantScenario(
            "mt_priority_inversion",
            (quiet(0),)
            + tuple(Scenario(
                f"tenant{s}_batch",
                (LoadSurge(start=0.4 * hz, extra=3, fraction=1.0,
                           ramp=0.05 * hz),),
                description="batch wave", **kw)
                for s in range(1, S)),
            description="every background tenant surges past capacity"
                        " at once while the tight-deadline tenant 0"
                        " stays quiet: the priority-inversion probe —"
                        " does tenant 0's QoS survive load it did not"
                        " create?"),
    ]
    return {t.name: t for t in lib}
