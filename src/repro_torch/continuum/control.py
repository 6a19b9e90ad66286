"""Closed-loop control plane: reactive autoscaling, admission control and
capacity migration, the orchestrator that answers overload.

Port of ``repro/continuum/control.py``. A small policy state machine
rides in the simulator's step carry next to the breaker state. At step
start ``control_actuate`` reads the queue and the scenario's drivers
and returns the *effective* drivers (controller-masked liveness, the
admitted client slots, the migration-scaled service row); at step end
``control_observe`` folds the fleet's QoS and timeout totals into
rolling averages.

* **Reactive autoscaler** (``managed`` > 0): the last ``managed``
  instances are a standby pool the controller spawns and kills on the
  fleet's backlog per live instance, through a dwell (``hold``),
  hysteresis (``up_queue`` > ``down_queue``) and ``action_cooldown``.
  Spawns serve after ``warmup``. Scenario liveness always wins, and a
  mask that would darken the whole fleet is waived (fail-open).
* **Admission control** (``admit``): per-player token buckets refilled
  at an AIMD admitted fraction; requests beyond the bucket are shed:
  issued QoS misses that never reach a queue.
* **Capacity migration** (``regions`` > 1): the hottest region borrows
  ``mig_step`` of service capacity from the coldest.

A neutral ``ControlConfig`` (``enabled`` False) keeps the simulator on
its open-loop path. Decisions need no randomness.

Lanes: the carry may hold S independent controllers, one a lane of a
lane-batched run. Fleet-level fields then have a leading (S,) axis,
(S,) or (S, M) or (S, R); the per-player ``tokens`` and ``shed_k`` are
(S·K,), lane s owning rows [s·K, (s+1)·K). Every reduction stays inside
a lane. ``control_actuate`` and ``control_observe`` take either layout:
an (M,) queue means one controller without the lane axis, as in the
reference.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device

_F32 = torch.float32


@dataclass(frozen=True)
class ControlConfig:
    """The controller's static knobs; the default instance is neutral.

    Autoscaler (``managed`` > 0): the last ``managed`` instances form
    the standby pool, parked at t=0 unless ``start_up``. ``up_queue`` /
    ``down_queue`` are hysteresis thresholds on backlog per live
    instance; a signal must hold ``hold`` seconds, actions are
    ``action_cooldown`` seconds apart and move ``batch`` instances;
    spawns serve after ``warmup`` seconds.

    Admission (``admit``): shed when backlog per live instance exceeds
    ``target_queue``, the rolling QoS falls below ``qos_floor`` or the
    rolling timeout rate exceeds ``timeout_ceiling`` (averages over
    ``qos_window`` seconds). AIMD: x``admit_md`` a hot step,
    +``admit_ai``/s when healthy, within [``admit_floor``, 1]. Buckets
    hold at most ``burst`` tokens.

    Migration (``regions`` > 1): contiguous regions of instances; when
    the hottest region's backlog per instance leads the coldest's by
    ``mig_threshold``, ``mig_step`` of capacity share moves hot-ward,
    shares kept in [``share_min``, ``share_max``].
    """
    # --- reactive autoscaler ---
    managed: int = 0
    start_up: bool = False
    warmup: float = 2.0
    up_queue: float = 8.0
    down_queue: float = 1.0
    hold: float = 1.0
    action_cooldown: float = 5.0
    batch: int = 1
    # --- admission control (token-bucket load shedding) ---
    admit: bool = False
    target_queue: float = 6.0
    qos_floor: float = 0.0
    timeout_ceiling: float = math.inf
    admit_md: float = 0.9
    admit_ai: float = 0.25
    admit_floor: float = 0.2
    burst: float = 16.0
    qos_window: float = 2.0
    # --- capacity migration between regions ---
    regions: int = 0
    mig_threshold: float = 4.0
    mig_step: float = 0.1
    mig_cooldown: float = 5.0
    share_min: float = 0.25
    share_max: float = 4.0

    @property
    def enabled(self) -> bool:
        """False: no mechanism active, the open-loop program."""
        return self.managed > 0 or self.admit or self.regions > 1


def control_enabled(cfg) -> bool:
    """The simulator's gate on the control path (``cfg`` a
    ``SimConfig``)."""
    ctl = getattr(cfg, "control", None)
    return ctl is not None and ctl.enabled


class ControlState(NamedTuple):
    """Controller dynamics carried through the steps."""
    ctrl_on: torch.Tensor      # (M,) bool desired on/off for managed instances
    ready_at: torch.Tensor     # (M,) f32 spawn warm-up deadline [s]
    up_dwell: torch.Tensor     # ()  f32 seconds the scale-up signal has held
    down_dwell: torch.Tensor   # ()  f32 seconds the scale-down signal has held
    cool_until: torch.Tensor   # ()  f32 no scale action before this time
    admit_frac: torch.Tensor   # ()  f32 AIMD admitted fraction in [floor, 1]
    tokens: torch.Tensor       # (K,) f32 per-player admission token buckets
    ema_qos: torch.Tensor      # ()  f32 rolling fleet QoS success ratio
    ema_timeout: torch.Tensor  # ()  f32 rolling fleet timeout-per-attempt ratio
    share: torch.Tensor        # (R,) f32 per-region capacity shares (mean 1)
    mig_cool: torch.Tensor     # ()  f32 no migration before this time


class ControlCounters(NamedTuple):
    """Control-action accounting (post-warmup, as the accumulator's
    measured fields)."""
    shed_k: torch.Tensor          # (K,) requests shed at admission per player
    admit_frac_sum: torch.Tensor  # ()  sum of admit_frac per measured step
    scale_up: torch.Tensor        # ()  scale-up actions
    scale_down: torch.Tensor      # ()  scale-down actions
    migrations: torch.Tensor      # ()  capacity-migration actions
    ctrl_up_m: torch.Tensor       # (M,) steps each managed instance served
    steps: torch.Tensor           # ()  measured steps


class ControlCarry(NamedTuple):
    state: ControlState
    counters: ControlCounters


# the fields with a player axis; every other field is fleet-level
PLAYER_FIELDS = ("tokens", "shed_k")


def _managed_mask(ccfg: ControlConfig, M: int) -> np.ndarray:
    return np.arange(M) >= M - min(ccfg.managed, M)


def _region_ids(ccfg: ControlConfig, M: int) -> np.ndarray:
    R = max(ccfg.regions, 1)
    return (np.arange(M) * R) // M


def _map_fleet(carry: ControlCarry, f) -> ControlCarry:
    """``carry`` with ``f`` applied to every fleet-level field."""
    def part(x):
        return type(x)(*(v if name in PLAYER_FIELDS else f(v)
                         for name, v in zip(x._fields, x)))
    return ControlCarry(part(carry.state), part(carry.counters))


def with_lane_axis(carry: ControlCarry) -> ControlCarry:
    """One controller's carry in the lane layout (S = 1)."""
    return _map_fleet(carry, lambda v: v[None])


def without_lane_axis(carry: ControlCarry) -> ControlCarry:
    """A one-lane carry in the reference's layout."""
    return _map_fleet(carry, lambda v: v[0])


def control_init(ccfg: ControlConfig, K: int, M: int, lanes: int | None = None,
                 device=None) -> ControlCarry:
    """Fresh carry for ``K`` players and ``M`` instances; ``lanes=S``
    gives S controllers (``K`` then counts the players of every lane)."""
    dev = resolve_device(device)
    lead = () if lanes is None else (lanes,)
    R = max(ccfg.regions, 1)
    managed = torch.as_tensor(_managed_mask(ccfg, M), device=dev)

    def full(shape, v, dtype=_F32):
        return torch.full(lead + shape, v, dtype=dtype, device=dev)

    state = ControlState(
        ctrl_on=(managed & bool(ccfg.start_up)).expand(lead + (M,)).clone(),
        ready_at=full((M,), -math.inf),
        up_dwell=full((), 0.0), down_dwell=full((), 0.0),
        cool_until=full((), -math.inf), admit_frac=full((), 1.0),
        tokens=torch.full((K,), ccfg.burst, dtype=_F32, device=dev),
        ema_qos=full((), 1.0), ema_timeout=full((), 0.0),
        share=full((R,), 1.0), mig_cool=full((), -math.inf))
    counters = ControlCounters(
        shed_k=torch.zeros(K, dtype=_F32, device=dev),
        admit_frac_sum=full((), 0.0), scale_up=full((), 0.0),
        scale_down=full((), 0.0), migrations=full((), 0.0),
        ctrl_up_m=full((M,), 0.0), steps=full((), 0.0))
    return ControlCarry(state, counters)


def _f32(x: float) -> float:
    return float(np.float32(x))


def _plus(t) -> callable:
    """``t + c`` rounded to float32 once (a host ``t``), as the step
    function of a run hands it over when ``t`` is not given."""
    tf = np.float32(t)
    return lambda c: float(tf + np.float32(c))


def control_actuate(ccfg: ControlConfig, dt: float, t, carry: ControlCarry,
                    q: torch.Tensor, act: torch.Tensor, nc: torch.Tensor,
                    s_m: torch.Tensor, measf, t_plus=None):
    """Step-start control pass: advance the policy state machine and
    return ``(carry, act_eff, nc_adm, s_m_eff, shed_k)``, the effective
    drivers (``nc_adm <= nc``; the gap is shed at the balancer edge)
    and this step's (K,) shed counts.

    ``t`` is the step time (a host float or a 0-dim float32 tensor);
    ``measf`` is 1.0 once past the warm-up, else 0.0. ``t_plus(c)``,
    when given, is the host float32 of ``t + c`` as the caller rounds
    it (the simulator replays the reference's compiler there). With
    lanes ``q``/``act``/``s_m`` are (S, M) and ``nc`` (S·K,)."""
    if q.dim() == 1:
        out = control_actuate(ccfg, dt, t, with_lane_axis(carry), q[None],
                              act[None], nc, s_m[None], measf, t_plus)
        carry, act_eff, nc_adm, s_m_eff, shed = out
        return (without_lane_axis(carry), act_eff[0], nc_adm, s_m_eff[0],
                shed)
    st, cnt = carry
    S, M = act.shape
    K = nc.shape[0] // S
    dev = q.device
    managed = torch.as_tensor(_managed_mask(ccfg, M), device=dev)
    tf = torch.as_tensor(t, dtype=_F32, device=dev)
    if t_plus is None:
        t_plus = (_plus(t) if not isinstance(t, torch.Tensor)
                  else lambda c: tf + _f32(c))
    measf = torch.as_tensor(measf, dtype=_F32, device=dev)

    def eff_active(state: ControlState) -> torch.Tensor:
        # newly spawned capacity serves once its warm-up has elapsed
        if ccfg.managed <= 0:
            return act
        up = torch.where(managed, state.ctrl_on & (tf >= state.ready_at),
                         True)
        eff = act & up
        # fail-open: never darken a lane's whole fleet
        return torch.where(eff.any(-1, keepdim=True), eff, act)

    act0 = eff_active(st)
    live_n = torch.clamp_min(act0.sum(-1), 1).to(_F32)
    qbar = q.sum(-1) / live_n            # backlog per live instance (S,)

    # --- reactive autoscaler: dwell + hysteresis + cooldown ---
    if ccfg.managed > 0:
        up_cond = qbar > ccfg.up_queue
        down_cond = qbar < ccfg.down_queue
        up_dwell = torch.where(up_cond, st.up_dwell + dt, 0.0)
        down_dwell = torch.where(down_cond, st.down_dwell + dt, 0.0)
        can_act = tf >= st.cool_until
        parked = managed & ~st.ctrl_on & act   # a dead standby can't spawn
        on = managed & st.ctrl_on
        do_up = (up_cond & (up_dwell >= ccfg.hold) & can_act
                 & parked.any(-1))
        do_down = (down_cond & (down_dwell >= ccfg.hold) & can_act
                   & on.any(-1))
        spawn = parked & (torch.cumsum(parked, -1) <= ccfg.batch)
        kill = on & (torch.cumsum(on.flip(-1), -1).flip(-1) <= ccfg.batch)
        ctrl_on = torch.where(do_up[:, None], st.ctrl_on | spawn, st.ctrl_on)
        ctrl_on = torch.where(do_down[:, None], ctrl_on & ~kill, ctrl_on)
        ready_at = torch.where(do_up[:, None] & spawn, t_plus(ccfg.warmup),
                               st.ready_at)
        acted = do_up | do_down
        st = st._replace(
            ctrl_on=ctrl_on, ready_at=ready_at,
            up_dwell=torch.where(acted, 0.0, up_dwell),
            down_dwell=torch.where(acted, 0.0, down_dwell),
            cool_until=torch.where(acted, t_plus(ccfg.action_cooldown),
                                   st.cool_until))
        cnt = cnt._replace(scale_up=cnt.scale_up + measf * do_up,
                           scale_down=cnt.scale_down + measf * do_down)
    act_eff = eff_active(st)

    # --- capacity migration: the hottest region borrows from the coldest
    if ccfg.regions > 1:
        R = ccfg.regions
        rid_np = _region_ids(ccfg, M)
        rid = torch.as_tensor(rid_np, device=dev)
        counts = torch.as_tensor(np.bincount(rid_np, minlength=R),
                                 dtype=_F32, device=dev)
        rq = torch.zeros(S, R, dtype=_F32, device=dev).index_add_(
            1, rid, q) / counts
        hot = torch.argmax(rq, -1, keepdim=True)
        cold = torch.argmin(rq, -1, keepdim=True)
        gap = (rq.gather(-1, hot) - rq.gather(-1, cold))[:, 0]
        do_mig = (gap > ccfg.mig_threshold) & (tf >= st.mig_cool)
        delta = torch.minimum(
            torch.clamp_max(st.share.gather(-1, cold)[:, 0] - ccfg.share_min,
                            ccfg.mig_step),
            ccfg.share_max - st.share.gather(-1, hot)[:, 0])
        delta = torch.clamp_min(delta, 0.0) * do_mig
        share = st.share.scatter_add(-1, hot, delta[:, None])
        share = share.scatter_add(-1, cold, -delta[:, None])
        st = st._replace(share=share, mig_cool=torch.where(
            do_mig, t_plus(ccfg.mig_cooldown), st.mig_cool))
        cnt = cnt._replace(migrations=cnt.migrations + measf * do_mig)
        s_m_eff = s_m / share[:, rid]
    else:
        s_m_eff = s_m

    # --- admission: the AIMD fraction refills per-player token buckets
    if ccfg.admit:
        hot = qbar > ccfg.target_queue
        if ccfg.qos_floor > 0.0:
            hot = hot | (st.ema_qos < ccfg.qos_floor)
        if math.isfinite(ccfg.timeout_ceiling):
            hot = hot | (st.ema_timeout > ccfg.timeout_ceiling)
        frac = torch.where(hot, st.admit_frac * ccfg.admit_md,
                           torch.clamp_max(st.admit_frac
                                           + ccfg.admit_ai * dt, 1.0))
        frac = torch.clamp(frac, ccfg.admit_floor, 1.0)
        ncf = nc.to(_F32)
        tokens = torch.clamp_max(
            st.tokens + frac.repeat_interleave(K) * ncf, ccfg.burst)
        adm = torch.minimum(ncf, torch.floor(tokens)).to(torch.int32)
        tokens = tokens - adm.to(_F32)
        shed = ncf - adm.to(_F32)
        st = st._replace(admit_frac=frac, tokens=tokens)
        cnt = cnt._replace(shed_k=cnt.shed_k + measf * shed)
        nc_adm = adm
    else:
        shed = torch.zeros(nc.shape, dtype=_F32, device=dev)
        nc_adm = nc

    cnt = cnt._replace(
        admit_frac_sum=cnt.admit_frac_sum + measf * st.admit_frac,
        ctrl_up_m=cnt.ctrl_up_m + measf * (managed & act_eff),
        steps=cnt.steps + measf)
    return ControlCarry(st, cnt), act_eff, nc_adm, s_m_eff, shed


def control_observe(ccfg: ControlConfig, carry: ControlCarry,
                    obs: torch.Tensor, dt: float) -> ControlCarry:
    """Step-end pass: fold the fleet totals ``obs = [succ, issued,
    timeouts, attempts]`` ((4,), or (S, 4) with lanes) into the rolling
    averages the admission signal reads next step."""
    st, cnt = carry
    a = dt / max(ccfg.qos_window, dt)
    succ, iss, to, att = obs.unbind(-1)
    qos = succ / torch.clamp_min(iss, 1.0)
    tor = to / torch.clamp_min(att, 1.0)
    st = st._replace(ema_qos=(1.0 - a) * st.ema_qos + a * qos,
                     ema_timeout=(1.0 - a) * st.ema_timeout + a * tor)
    return ControlCarry(st, cnt)


# ---------------------------------------------------------------------------
# Readouts (one lane's accumulator and counters).
# ---------------------------------------------------------------------------

def _np(x, dtype=None) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def control_stats_stream(acc, ctrl: ControlCounters) -> dict:
    """Control-action accounting of a streaming run: scale actions per
    1k steps (thrash), the admission-drop fraction (shed over scheduled
    requests; ``acc.n_kc`` counts sheds as issued misses), the mean
    admitted fraction and the standby occupancy."""
    steps = max(float(_np(ctrl.steps)), 1.0)
    shed = float(_np(ctrl.shed_k, np.float64).sum())
    requests = float(_np(acc.n_kc, np.float64).sum())
    up = float(_np(ctrl.scale_up))
    down = float(_np(ctrl.scale_down))
    occ = _np(ctrl.ctrl_up_m, np.float64)
    return {
        "scale_up": up,
        "scale_down": down,
        "scale_actions_per_1k_steps": (up + down) / steps * 1e3,
        "migrations": float(_np(ctrl.migrations)),
        "shed": shed,
        "admission_drop_frac": shed / max(requests, 1.0),
        "mean_admit_frac": float(_np(ctrl.admit_frac_sum)) / steps,
        "standby_up_mean": float(occ.sum()) / steps,
    }


def per_tenant_qos_spread(acc) -> dict:
    """Per-player QoS dispersion, the fairness cost of shedding and
    churn; players with no issued requests are left out."""
    s = _np(acc.succ_kc, np.float64).sum(-1)
    n = _np(acc.n_kc, np.float64).sum(-1)
    has = n > 0
    if not has.any():
        return {"min": 0.0, "max": 0.0, "mean": 0.0, "std": 0.0,
                "spread": 0.0}
    r = s[has] / n[has]
    return {"min": float(r.min()), "max": float(r.max()),
            "mean": float(r.mean()), "std": float(r.std()),
            "spread": float(r.max() - r.min())}
