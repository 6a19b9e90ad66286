"""Flight recorder: a bounded ring of structured events in the
simulator's step carry.

Port of ``repro/obs/recorder.py``. A fixed-capacity ring of (step,
kind, entity, value) records rides in the carry and captures the steps
worth looking at as they happen: breaker trips and resets, retry
exhaustions, control-plane actions (scale up/down, migrate), admission
sheds, scenario event marks and per-player QoS-miss spikes, at
O(capacity) memory for any horizon.

* ``SimConfig.recorder=None`` (or a zero-capacity
  :class:`RecorderConfig`) leaves the carry slot ``None`` and the step
  runs no recorder op.
* The ring is ordinary carry state: it streams through chunked runs
  and rides the checkpoint bit for bit.
* **Lanes.** A lane-batched run keeps one ring a lane as the rows of
  one state: ``step``/``kind``/``entity``/``value`` (S, cap), ``ptr``
  (S, 1) and ``prev_open`` (S, K, M) ((S, 0, 0) without breakers); every
  lane appends along its own candidate axis, so lane s's ring is the
  ring of its run alone. A single run's ring is the reference's layout:
  (cap,) arrays, a (1,) ``ptr``, a (K, M) ``prev_open``.
  :func:`record_step` takes either.

Append mechanics, as in the reference: each step contributes a fixed
set of candidate lanes; the valid candidates get ring positions from an
exclusive cumulative sum off the monotone ``ptr``; candidates that a
later candidate of the same batch would overwrite are masked out, so
the scatter indices are distinct and the write deterministic. Torch has
no ``mode="drop"``: the scatter goes into a buffer of ``cap + 1`` slots
whose last slot takes every masked candidate, and the first ``cap``
are kept. Nothing here reads a device value on the host (no boolean-
mask indexing, ``nonzero``, ``.item()`` or ``.tolist()``), so the
appends never wait on the card. ``ptr`` counts every event ever
appended; ``ptr - capacity`` (clamped at 0) is the number overwritten.

The host readout (:func:`recorder_events`, :func:`events_appended`,
:func:`events_dropped`) is numpy, and splits rings by ``ptr.size`` as
the reference's does: a lane-batched state decodes as one ring a lane.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device

# Event kinds. Stable small integers: they appear in exported traces
# and run artifacts, so renumbering is a schema change.
KIND_MARK = 0             # scenario event onset (entity = mark index)
KIND_SCALE_UP = 1         # controller spawned standby capacity
KIND_SCALE_DOWN = 2       # controller killed standby capacity
KIND_MIGRATE = 3          # cross-region capacity migration fired
KIND_BREAKER_TRIP = 4     # entity = player id; value = arms newly open
KIND_BREAKER_RESET = 5    # entity = player id; value = arms newly closed
KIND_RETRY_EXHAUSTED = 6  # entity = player id; value = dropped requests
KIND_SHED = 7             # entity = player id; value = requests shed
KIND_QOS_SPIKE = 8        # entity = player id; value = step miss fraction

KIND_NAMES = {
    KIND_MARK: "scenario_mark",
    KIND_SCALE_UP: "scale_up",
    KIND_SCALE_DOWN: "scale_down",
    KIND_MIGRATE: "migrate",
    KIND_BREAKER_TRIP: "breaker_trip",
    KIND_BREAKER_RESET: "breaker_reset",
    KIND_RETRY_EXHAUSTED: "retry_exhausted",
    KIND_SHED: "shed",
    KIND_QOS_SPIKE: "qos_spike",
}

FLEET = -1    # entity sentinel for fleet-level events


def kind_name(kind: int) -> str:
    return KIND_NAMES.get(int(kind), f"kind_{int(kind)}")


@dataclass(frozen=True)
class RecorderConfig:
    """Static recorder knobs (a ``SimConfig`` field). ``capacity`` is
    the ring size of one run (of one lane); ``capacity <= 0`` disables
    the recorder. ``qos_spike`` is the per-player per-step QoS-miss
    fraction at or above which a ``KIND_QOS_SPIKE`` event is recorded
    (players with no issued requests that step never spike)."""
    capacity: int = 1024
    qos_spike: float = 0.5

    @property
    def enabled(self) -> bool:
        return self.capacity > 0


def recorder_enabled(cfg) -> bool:
    """The simulator's gate on the recorder path (``cfg`` a
    ``SimConfig``)."""
    rec = getattr(cfg, "recorder", None)
    return rec is not None and rec.enabled


class RecorderState(NamedTuple):
    """The in-carry ring (shapes of a single run; lanes add a leading
    (S,) axis to every field). ``prev_open`` is the previous step's
    breaker-open snapshot: trip and reset events are its step-over-step
    transitions, which also catches cooldown expiries between steps."""
    step: torch.Tensor       # (cap,) i32 global step index of each record
    kind: torch.Tensor       # (cap,) i32 event kind (KIND_*)
    entity: torch.Tensor     # (cap,) i32 player id / mark index / FLEET
    value: torch.Tensor      # (cap,) f32 event magnitude
    ptr: torch.Tensor        # (1,) i32 total events ever appended
    prev_open: torch.Tensor  # (K, M) bool breaker-open snapshot


def recorder_init(rcfg: RecorderConfig, K: int, M: int,
                  track_breakers: bool, lanes: int | None = None,
                  device=None) -> RecorderState:
    """An empty ring for ``K`` players and ``M`` instances on ``device``
    (default ``cuda``); ``lanes=S`` gives S rings as rows."""
    dev = resolve_device(device)
    cap = int(rcfg.capacity)
    lead = () if lanes is None else (lanes,)

    def full(shape, v, dtype):
        return torch.full(lead + shape, v, dtype=dtype, device=dev)

    return RecorderState(
        step=full((cap,), -1, torch.int32),
        kind=full((cap,), -1, torch.int32),
        entity=full((cap,), FLEET, torch.int32),
        value=full((cap,), 0.0, torch.float32),
        ptr=full((1,), 0, torch.int32),
        prev_open=full((K, M) if track_breakers else (0, 0), False,
                       torch.bool))


def _append(rec: RecorderState, t_idx, kinds, entities, values,
            valid) -> RecorderState:
    """Append each lane's valid candidates ((S, E) rows) in candidate
    order: one cumsum and four scatters. Indices within a row are
    distinct but for the spare slot ``cap``, which takes the masked
    candidates and is cut off, so the write order is immaterial."""
    S, cap = rec.step.shape
    vi = valid.to(torch.int64)
    n_new = vi.sum(-1, keepdim=True)                     # (S, 1)
    base = rec.ptr.to(torch.int64)                       # (S, 1)
    pos = base + torch.cumsum(vi, -1) - vi               # exclusive
    keep = valid & (pos >= base + n_new - cap)
    slot = torch.where(keep, pos % cap, cap)

    def put(buf, src):
        spare = torch.nn.functional.pad(buf, (0, 1))     # slot cap: dropped
        return spare.scatter_(1, slot, src)[:, :cap]

    steps = (torch.full_like(slot, t_idx, dtype=torch.int32)
             if not isinstance(t_idx, torch.Tensor)
             else t_idx.to(torch.int32).expand(slot.shape))
    return rec._replace(
        step=put(rec.step, steps), kind=put(rec.kind, kinds),
        entity=put(rec.entity, entities), value=put(rec.value, values),
        ptr=(base + n_new).to(torch.int32))


def _with_lanes(rec: RecorderState) -> bool:
    return rec.ptr.dim() == 2


def record_step(
    rcfg: RecorderConfig,
    rec: RecorderState,
    *,
    t_idx,                     # global step index: a host int or 0-dim
    pids: torch.Tensor,        # (K,) player ids (lane-local under lanes)
    marks: torch.Tensor,       # (E,) scenario event-onset steps, -1 pad
    miss_k: torch.Tensor,      # (K,) f32 QoS misses this step
    iss_k: torch.Tensor,       # (K,) f32 issued requests this step
    retry_drop_k: torch.Tensor | None = None,  # (K,) f32 deadline drops
    shed_k: torch.Tensor | None = None,        # (K,) f32 admission sheds
    open_now: torch.Tensor | None = None,      # (K, M) bool breaker open
    ctl_deltas: tuple | None = None,           # (up, down, mig) f32 diffs
) -> RecorderState:
    """Build this step's candidate-event lanes and append the valid
    ones. Lane order is fixed (marks, control actions, then the
    per-player lanes), so records within a step have a deterministic
    sequence. Fleet-level lanes are gated on ``pids[0] == 0``, the run
    holding player 0, as the reference gates them.

    With lanes (a ring of (S, cap) rows) every per-step input has a
    leading (S,) axis (``marks`` (S, E), ``miss_k`` (S, K), ``open_now``
    (S, K, M), each control delta (S,)) and ``pids`` stays (K,)."""
    if not _with_lanes(rec):
        one = RecorderState(*(x[None] for x in rec))
        out = record_step(
            rcfg, one, t_idx=t_idx, pids=pids, marks=marks[None],
            miss_k=miss_k[None], iss_k=iss_k[None],
            retry_drop_k=None if retry_drop_k is None else retry_drop_k[None],
            shed_k=None if shed_k is None else shed_k[None],
            open_now=None if open_now is None else open_now[None],
            ctl_deltas=None if ctl_deltas is None else tuple(
                torch.as_tensor(d)[None] for d in ctl_deltas))
        return RecorderState(*(x[0] for x in out))

    S = rec.ptr.shape[0]
    owner = pids[0] == 0
    ents_k = pids.to(torch.int32).expand(S, -1)
    kinds, ents, vals, valids = [], [], [], []

    def lane(kind, ent, val, valid):
        kinds.append(torch.full_like(ent, kind))
        ents.append(ent)
        vals.append(val.to(torch.float32))
        valids.append(valid)

    # scenario event onsets (entity = mark index, value = onset step)
    E = marks.shape[-1]
    lane(KIND_MARK, torch.arange(E, dtype=torch.int32,
                                 device=marks.device).expand(S, -1),
         marks.to(torch.float32), (marks >= 0) & (marks == t_idx) & owner)

    # control-plane actions, detected as counter diffs across this
    # step's control_actuate call (post-warmup, like the counters)
    if ctl_deltas is not None:
        fleet = torch.full((S, 1), FLEET, dtype=torch.int32,
                           device=miss_k.device)
        for kind, d in zip((KIND_SCALE_UP, KIND_SCALE_DOWN, KIND_MIGRATE),
                           ctl_deltas):
            d = d.reshape(S, 1)
            lane(kind, fleet, d, (d > 0) & owner)

    # breaker transitions: step-over-step open-mask diff per player
    if open_now is not None:
        trips = (open_now & ~rec.prev_open).sum(-1).to(torch.float32)
        resets = (rec.prev_open & ~open_now).sum(-1).to(torch.float32)
        lane(KIND_BREAKER_TRIP, ents_k, trips, trips > 0)
        lane(KIND_BREAKER_RESET, ents_k, resets, resets > 0)
        rec = rec._replace(prev_open=open_now)

    if retry_drop_k is not None:
        lane(KIND_RETRY_EXHAUSTED, ents_k, retry_drop_k, retry_drop_k > 0)
    if shed_k is not None:
        lane(KIND_SHED, ents_k, shed_k, shed_k > 0)

    # per-player QoS-miss spike: miss fraction of this step's issued
    # requests at or above the configured threshold
    frac = miss_k / torch.clamp_min(iss_k, 1.0)
    lane(KIND_QOS_SPIKE, ents_k, frac,
         (iss_k > 0) & (frac >= float(np.float32(rcfg.qos_spike))))

    return _append(rec, t_idx, torch.cat(kinds, -1), torch.cat(ents, -1),
                   torch.cat(vals, -1), torch.cat(valids, -1))


# ---------------------------------------------------------------------------
# Host-side readout.
# ---------------------------------------------------------------------------

class Event(NamedTuple):
    """One decoded record. ``shard`` is the ring it came from (0 for a
    single run, the lane in a lane-batched state), ``seq`` its
    per-ring append sequence number."""
    step: int
    kind: int
    entity: int
    value: float
    shard: int
    seq: int

    @property
    def kind_str(self) -> str:
        return kind_name(self.kind)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _rings(rec) -> tuple[np.ndarray, ...]:
    """The ring arrays as (D, cap) views, D = ptr.size."""
    ptr = _np(rec.ptr).reshape(-1).astype(np.int64)
    D = max(ptr.shape[0], 1)
    step = _np(rec.step).reshape(D, -1)
    kind = _np(rec.kind).reshape(D, -1)
    entity = _np(rec.entity).reshape(D, -1)
    value = _np(rec.value).reshape(D, -1)
    return ptr, step, kind, entity, value


def recorder_events(rec) -> list[Event]:
    """A ``RecorderState`` as chronologically ordered events, sorted by
    (step, shard, seq): within one ring the order is exact append
    order."""
    ptr, step, kind, entity, value = _rings(rec)
    cap = step.shape[1]
    out = []
    for d in range(len(ptr)):
        p = int(ptr[d])
        for s in range(max(0, p - cap), p):
            sl = s % cap
            out.append(Event(int(step[d, sl]), int(kind[d, sl]),
                             int(entity[d, sl]), float(value[d, sl]),
                             d, s))
    out.sort(key=lambda e: (e.step, e.shard, e.seq))
    return out


def events_appended(rec) -> int:
    """Total events ever appended (over every ring), wrapped or not."""
    return int(_np(rec.ptr).reshape(-1).astype(np.int64).sum())


def events_dropped(rec) -> int:
    """Events overwritten by ring wraparound (over every ring)."""
    ptr, step, *_ = _rings(rec)
    cap = step.shape[1]
    return int(np.maximum(ptr - cap, 0).sum())
