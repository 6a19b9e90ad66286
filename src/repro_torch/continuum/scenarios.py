"""Per-step driver schedules: the engine's only view of a scenario.

Port of the ``Drivers`` contract of ``repro/continuum/scenarios.py``
(the event compiler waits for a later slice). Per step ``t`` the engine
forms the effective RTT ``rtt * rtt_scale[t][None, :] +
min(rtt_cut_k[t][:, None], rtt_cut_m[t][None, :])``, reads the
``s_m[t]`` service row, bounds the request rounds per LB by
``n_clients[t]`` and fires Alg 3/4 placement events when ``active[t]``
changes. ``marks`` are event-onset step indices (``-1``-padded to
``MAX_MARKS``) for the recovery windows of the accumulator.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import resolve_device

MAX_MARKS = 32


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
