"""Multi-tenant continuum: NT services sharing ONE instance fleet.

Port of ``repro/continuum/tenancy.py``. The paper's engine is
single-service; real edge infrastructures host coexisting applications
that compete for the same nodes. ``TenancyConfig`` widens the simulator
to NT tenants, each with its own QoS target tau_s, its own client
population (a per-tenant ``n_clients`` schedule in the drivers) and its
own bandit fleet in the step carry, while the instance queues, the
liveness mask and the RTT fabric stay shared.

The queue gains a tenant axis: ``q`` is (NT, M) per run (the engine's
lanes put their (S,) axis before it), a request's position in line is
the TOTAL backlog ``q.sum`` over tenants at its instance, and the
per-round drain is work-conserving processor sharing across tenants.
Cross-service interference folds into the effective service-time row::

    s_eff[s, m] = s_m[m] * service_scale[s]
                  * (1 + interference * q_other[s, m] / (1 + q_tot[m]))

so a tenant's requests slow down in proportion to the share of the
instance backlog OTHER tenants hold. ``interference=0`` makes tenants
couple only through queue length and capacity.

The reference calls the tenant count ``S``; the port's engine uses
``S`` for lanes, so it names the tenant axis ``NT``. ``TenancyConfig.S``
keeps the reference's name. ``tenancy=None``, or a degenerate S=1
config, keeps the engine on the single-service path.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TenancyConfig:
    """Static description of the services sharing the fleet.

    taus           per-tenant QoS deadlines [s]; ``len(taus)`` is the
                   tenant count and tenant s succeeds iff latency <=
                   taus[s].
    service_scale  per-tenant demand multiplier on the instance service
                   time; ``None`` means all 1.0.
    interference   cross-service coupling coefficient xi >= 0: how much
                   a tenant's effective service time inflates per unit
                   share of *other* tenants' backlog on the instance.
    """
    taus: tuple[float, ...]
    service_scale: tuple[float, ...] | None = None
    interference: float = 0.0

    def __post_init__(self):
        if not self.taus:
            raise ValueError("TenancyConfig needs at least one tenant tau")
        if any(t <= 0.0 for t in self.taus):
            raise ValueError(f"tenant taus must be positive: {self.taus}")
        if self.service_scale is not None:
            if len(self.service_scale) != len(self.taus):
                raise ValueError(
                    f"service_scale has {len(self.service_scale)} entries "
                    f"for {len(self.taus)} tenants")
            if any(s <= 0.0 for s in self.service_scale):
                raise ValueError(
                    f"service_scale must be positive: {self.service_scale}")
        if self.interference < 0.0:
            raise ValueError(
                f"interference must be >= 0: {self.interference}")

    @property
    def S(self) -> int:
        """The tenant count (the reference's name)."""
        return len(self.taus)

    @property
    def enabled(self) -> bool:
        """Two or more tenants turn the tenant engine on; an S=1 config
        is degenerate and stays on the single-service path."""
        return self.S >= 2

    @property
    def scales(self) -> tuple[float, ...]:
        return tuple(float(s) for s in (self.service_scale
                                        or (1.0,) * self.S))


def tenancy_enabled(cfg) -> bool:
    """True iff ``cfg.tenancy`` switches the engine onto the
    multi-tenant path (None and S=1 both stay single-service)."""
    tn = getattr(cfg, "tenancy", None)
    return tn is not None and tn.enabled


def tenancy_size(cfg) -> int:
    """The tenant count when the tenant engine is on, else 0."""
    return cfg.tenancy.S if tenancy_enabled(cfg) else 0
