"""Discrete-time CC simulator (paper §VII testbed) on the card.

Port of the single-service path of ``repro/continuum/simulator.py``:
strategies ``qedgeproxy``, ``proxy_mity`` (any alpha) and
``dec_sarsa``, drivers as compiled, unsharded, resilience / control /
recorder / tenancy off, the fused round or the round scan, streaming
metrics (``run_sim_stream``) or full trajectories (``run_sim``), one
simulation or S of them as lanes of one run (``run_sim_batch``,
``run_sim_grid``). The instance model and the step are the
reference's: every step of ``dt`` issues up to ``max_clients`` rounds
of requests per load balancer; a request that finds q requests queued
at instance m sees ``rtt + (q + 1) * s_m * Z`` with ``Z ~ LogNormal(0,
proc_sigma^2)``; queues drain ``dt / (C * s_m)`` per round. Staggered
Alg-1 maintenance runs for ~K / maint_every players per step.

``lax.scan`` becomes a host loop over steps that never waits on the
card: the per-step placement-event flags come from the drivers on the
host before the loop (in place of ``lax.cond``), the step's time is a
host number, and the per-step outputs go into preallocated device
buffers read once at the end. With the fused round a ``qedgeproxy``
step runs the two CUDA kernels (``kernels.ops.round_step`` for the C
rounds, ``kernels.ops.bandit_maintenance_stats`` inside maintenance)
and plain PyTorch ops for the rest; ``proxy_mity``'s fused round is
batched PyTorch (``kernels.ops.round_step_gumbel``). The round scan
(``fused_round=False``, and always for ``dec_sarsa``, which reads its
own state between rounds) is a host loop over the C rounds whose keys
and noise are drawn for all rounds at once, before the loop.

**Lanes.** ``jax.vmap`` over the reference's run becomes a leading lane
axis carried through the step: S simulations (each its own base RTT,
drivers and key) advance together, one launch of each kernel a step for
all of them. The players of every lane are the rows of one strategy
state, lane s owning rows [s·K, (s+1)·K); queues, liveness, service
and drain rows are (S, M); every reduction over players or instances
stays within a lane, and a lane computes exactly what it computes
alone. A single run is the one-lane case.

Features the reference has beyond this path raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.continuum import metrics as qm
from repro_torch.continuum import scenarios as qs
from repro_torch.continuum.metrics import StepSeries, StreamOutputs
from repro_torch.continuum.scenarios import Drivers
from repro_torch.core import bandit as qb
from repro_torch.core import baselines as bl
from repro_torch.core import fmath, prand
from repro_torch.core.kde import normal_cdf
from repro_torch.core.oracle import step_regret
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ref import lane_of, lane_rows


@dataclass(frozen=True)
class SimConfig:
    """Every field of the reference ``SimConfig``; on this path the
    resilience, control, recorder and tenancy fields must stay
    neutral."""
    dt: float = 0.1                  # step length [s] = client period
    horizon: float = 300.0           # simulated seconds
    maint_every: int = 10            # QEdgeProxy decision interval H_d [steps]
    max_clients: int = 8             # per-LB client slots (rounds per step)
    service_time: float = 0.0055     # s_m: idle per-request processing [s]
    proc_sigma: float = 0.25         # lognormal sigma of processing noise
    tau: float = 0.080
    rho: float = 0.9
    window: float = 10.0
    ring: int = 64
    reward_ring: int = 512
    ev_pre: float = 10.0
    ev_bucket: float = 2.0
    ev_buckets: int = 30
    attempt_timeout: float = 0.0
    max_retries: int = 0
    retry_backoff: float = 0.005
    retry_deadline: bool = True
    breaker_threshold: int = 0
    breaker_cooldown: float = 2.0
    control: object = None
    recorder: object = None
    fused_round: bool = True
    tenancy: object = None

    @property
    def num_steps(self) -> int:
        return int(round(self.horizon / self.dt))

    @property
    def tenancy_on(self) -> bool:
        return self.tenancy is not None and self.tenancy.enabled

    @property
    def resilience_on(self) -> bool:
        return self.attempt_timeout > 0.0

    @property
    def control_on(self) -> bool:
        return self.control is not None and self.control.enabled

    @property
    def recorder_on(self) -> bool:
        return self.recorder is not None and self.recorder.enabled


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP {item})")


def _check_main_path(cfg: SimConfig, pshard) -> None:
    """Raise for every setting that leaves the ported path."""
    tn = cfg.tenancy
    if tn is not None and not tn.enabled:
        if abs(tn.taus[0] - cfg.tau) > 1e-12:
            raise ValueError(
                f"S=1 TenancyConfig tau {tn.taus[0]} != cfg.tau {cfg.tau}: "
                "the single-tenant path reads cfg.tau")
        if tn.scales[0] != 1.0:
            raise ValueError("S=1 TenancyConfig needs a neutral "
                             "service_scale: the single-tenant path reads "
                             "drivers.s_m unscaled")
    if cfg.tenancy_on:
        raise _not_ported("the multi-tenant engine", "A9")
    if cfg.resilience_on or cfg.max_retries or cfg.breaker_threshold:
        raise _not_ported("request-lifecycle resilience", "A9")
    if cfg.control_on:
        raise _not_ported("the closed-loop control plane", "A9")
    if cfg.recorder_on:
        raise _not_ported("the flight recorder", "A9")
    if pshard is not None:
        raise _not_ported("player sharding", "A10")


class SimOutputs(NamedTuple):
    """Per-step trajectories (leading axis T), ``trace=True`` only; a
    lane-batched run puts a lane axis (S,) before T."""
    rewards: torch.Tensor      # (T, K, C) 1/0 QoS success per client slot
    issued: torch.Tensor       # (T, K, C) request-issued mask
    choices: torch.Tensor      # (T, K, C) selected instance
    latency: torch.Tensor      # (T, K, C) end-to-end latency
    proc_lat: torch.Tensor     # (T, K, C) processing component
    arrivals: torch.Tensor     # (T, M) requests per instance
    queue: torch.Tensor        # (T, M) queue length at step start
    weights: torch.Tensor      # (T, K, M) routing distribution
    true_mu: torch.Tensor      # (T, K, M) oracle success probabilities
    regret: torch.Tensor       # (T, K) per-step oracle regret
    eps: torch.Tensor          # (T, K) exploration rate (qedgeproxy) or 0
    attempts: torch.Tensor     # (T, K, C) attempts per request (1 here)
    dropped: torch.Tensor      # (T, K, C) always False here


def _true_mu_tau(rtt, q, tau, sigma, service_time):
    """Closed-form P(rtt + (q+1) s Z <= tau), Z ~ LogNormal(0, sigma^2);
    ``q`` and ``service_time`` broadcast against ``rtt``."""
    margin = (tau - rtt) / ((q + 1.0) * service_time)
    safe = torch.clamp_min(margin, 1e-9)
    mu = normal_cdf(fmath.log(safe) / sigma)
    return torch.where(margin > 0, mu, 0.0)


def _true_mu(rtt, q, cfg: SimConfig, service_time):
    return _true_mu_tau(rtt, q, cfg.tau, cfg.proc_sigma, service_time)


# ---------------------------------------------------------------------------
# Strategy adapters: dicts of closures, as in the reference, over the
# players of every lane (K below counts them all; ``active`` is (S, M)).
#
# One change of interface: the round scan draws every round's selection
# noise before its loop, through ``draw(keys, pids)`` (``keys`` is the
# (S, C, 2) per-round selection keys; the result has leading (S, C)
# axes, or is None), and ``select(state, drawn, t, active, pids)`` gets
# its round's row (players of every lane). Each draw is the one the
# reference's ``select`` makes from that round's key.
# ---------------------------------------------------------------------------

def _round_keys(k_step, C: int):
    """(S, C, 2, 2): per lane and round r, ``split(fold_in(k_step, r))``,
    the round's selection and noise keys, from (S, 2) step keys."""
    rounds = torch.arange(C, device=k_step.device)
    return prand.split(prand.fold_in(k_step[..., None, :], rounds))


def _by_round(drawn):
    """Lane-major draws (S, C, K, ...) as round-major rows (C, S·K, ...)
    over the players of every lane (a tensor, a tuple, or None)."""
    if drawn is None:
        return None
    if isinstance(drawn, tuple):
        return tuple(_by_round(x) for x in drawn)
    S, C, K = drawn.shape[:3]
    return drawn.transpose(0, 1).reshape(C, S * K, *drawn.shape[3:])


def _noise(cfg: SimConfig, keys, pids):
    """(C, S·K) processing noise ``exp(sigma * N)`` from (S, C, 2) keys."""
    return _by_round(fmath.exp(cfg.proc_sigma * prand.player_normal(keys,
                                                                     pids)))


def qedgeproxy_strategy(params: qb.BanditParams, cfg: SimConfig, K: int,
                        M: int):
    def init(rtt, active, key, pids):
        return qb.init_state(K, M, params, cfg.ring, cfg.reward_ring, active,
                             key=key, pids=pids)

    def draw(keys, pids):
        return None                       # SWRR draws nothing

    def select(state, drawn, t, active, pids):
        choice, state, valid = qb.select(state)
        return choice, state

    def record(state, choice, lat, t, mask):
        return qb.record(state, params, choice, lat, t, mask)

    def maintain(state, rtt, t, lb_mask=None):
        return qb.maintenance(state, params, rtt, t, lb_mask)

    def maintain_subset(state, rtt, t, player_idx):
        return qb.maintenance_subset(state, params, rtt, t, player_idx)

    def record_feedback(state, choice, lat, t, mask):
        return qb.record_feedback(state, params, choice, lat, t, mask)

    def record_rings(state, choices, lats, t, mask):
        return qb.record_rings_batch(state, params, choices, lats, t, mask)

    def on_activity(state, new_active, rtt, t, moved):
        return qb.sync_active(state, params, new_active)  # moves ``moved``

    def weights(state):
        return state.weights

    def eps(state):
        return state.eps

    def fused_round(state, q, nc, act, t, rtt_t, s_m, served, k_step, pids):
        # all C rounds of every lane in one kernel call; the per-round
        # noise is drawn up front, each element the draw the
        # reference's round scan makes: a pure function of (step key,
        # round, player id). `t` is the step time as a host number.
        ks = _round_keys(k_step, cfg.max_clients)
        out = kernel_ops.round_step(
            state.weights, state.cw, state.err, state.cooldown_until,
            state.in_pool, state.active,
            state.lat_buf, state.ts_buf, state.ptr,
            state.r_buf, state.rts_buf, state.rptr,
            q, nc, _noise(cfg, ks[..., 1, :], pids), rtt_t, s_m, served, t,
            tau=params.tau, err_thresh=params.err_thresh,
            cooldown=params.cooldown)
        state = state._replace(
            weights=out.weights, cw=out.cw, err=out.err,
            cooldown_until=out.cooldown_until, in_pool=out.in_pool,
            lat_buf=out.lat_buf, ts_buf=out.ts_buf, ptr=out.ptr,
            r_buf=out.r_buf, rts_buf=out.rts_buf, rptr=out.rptr)
        return state, out.q, out.arrivals, out.choices, out.lats, out.procs

    return dict(init=init, draw=draw, select=select, record=record,
                maintain=maintain, maintain_subset=maintain_subset,
                record_feedback=record_feedback, record_rings=record_rings,
                on_activity=on_activity, weights=weights, eps=eps,
                fused_round=fused_round)


class PMState(NamedTuple):
    """proxy-mity's strategy state: its fixed routing weights."""
    weights: torch.Tensor


def proxy_mity_strategy(alpha: float, cfg: SimConfig, K: int, M: int):
    """Static proximity weights; requests sampled i.i.d. from them
    (proxy-mity randomizes per request; there is no SWRR state)."""

    def init(rtt, active, key, pids):
        return PMState(bl.proxy_mity_weights(rtt, alpha, active))

    def draw(keys, pids):
        return prand.player_gumbel(keys, pids, M)          # (S, C, K, M)

    def select(state, gumbel, t, active, pids):
        # per-player categorical: argmax(logits + Gumbel)
        choice = torch.argmax(fmath.log(state.weights + 1e-30) + gumbel,
                              dim=-1)
        return choice, state

    def keep(state, *args):
        return state                    # stateless per request, fixed weights

    def on_activity(state, new_active, rtt, t, moved):
        # the weights follow this step's RTT, so a lane whose liveness
        # did not change keeps the ones it has
        return qb.keep_lanes(moved, state._replace(
            weights=bl.proxy_mity_weights(rtt, alpha, new_active)), state)

    def weights(state):
        return state.weights

    def eps(state):
        return torch.zeros(K, dtype=torch.float32, device=state.weights.device)

    def fused_round(state, q, nc, act, t, rtt_t, s_m, served, k_step, pids):
        # selection is queue-independent: every round's Gumbel rows are
        # drawn and argmaxed at once; only the queues run in order
        ks = _round_keys(k_step, cfg.max_clients)
        q, arrivals, choices, lats, procs = kernel_ops.round_step_gumbel(
            state.weights, q, nc, _noise(cfg, ks[..., 1, :], pids),
            _by_round(prand.player_gumbel(ks[..., 0, :], pids, M)), rtt_t,
            s_m, served)
        return state, q, arrivals, choices, lats, procs

    return dict(init=init, draw=draw, select=select, record=keep,
                maintain=keep, record_feedback=keep, record_rings=keep,
                on_activity=on_activity, weights=weights, eps=eps,
                fused_round=fused_round)


class DSState(NamedTuple):
    """Dec-SARSA's strategy state."""
    inner: bl.DecSarsaState
    active: torch.Tensor
    pend_s: torch.Tensor      # state bucket used for the pending action


def dec_sarsa_strategy(params: bl.DecSarsaParams, cfg: SimConfig, K: int,
                       M: int, pshard=None):
    if pshard is not None:
        raise _not_ported("Dec-SARSA under player sharding", "A10")

    def init(rtt, active, key, pids):
        # the proximity-normalized Q divides by each lane's RTT maximum
        lanes = active.shape[0]
        rtt_max = lane_rows(rtt.reshape(lanes, -1).amax(-1)[:, None], K)
        return DSState(bl.decsarsa_init(K, M, rtt, params, rtt_max), active,
                       torch.zeros(K, dtype=torch.int32, device=rtt.device))

    def draw(keys, pids):
        return bl.decsarsa_draws(keys, M, pids)   # (S, C, K), (S, C, K, M)

    def select(state, drawn, t, active, pids):
        choice, s = bl.decsarsa_choose(state.inner, params, active, *drawn)
        return choice, state._replace(pend_s=s, active=active)

    def record(state, choice, lat, t, mask):
        reward = (lat <= params.tau).to(torch.float32)
        inner = bl.decsarsa_update(
            state.inner, params, state.pend_s, choice, reward, lat, mask)
        return state._replace(inner=inner)

    def maintain(state, rtt, t, lb_mask=None):
        return state

    def on_activity(state, new_active, rtt, t, moved):
        return state._replace(active=new_active)  # unmoved lanes: as they were

    def weights(state):
        # effective eps-greedy distribution for regret accounting
        q = state.inner.q
        act = lane_rows(state.active, K)
        qs = q[torch.arange(K, device=q.device), state.pend_s.to(torch.int64)]
        qs = torch.where(act, qs, torch.finfo(qs.dtype).min)
        greedy = torch.nn.functional.one_hot(torch.argmax(qs, -1), M).to(
            torch.float32)
        actf = act.to(torch.float32)
        uni = actf / torch.clamp_min(actf.sum(-1, keepdim=True), 1.0)
        e = state.inner.eps[:, None]
        return (1 - e) * greedy + e * uni

    def eps(state):
        return state.inner.eps

    return dict(init=init, draw=draw, select=select, record=record,
                maintain=maintain, on_activity=on_activity, weights=weights,
                eps=eps)


def make_strategy(name: str, cfg: SimConfig, K: int, M: int,
                  pshard=None, **kw):
    if name == "qedgeproxy":
        params = kw.get("params") or qb.BanditParams(
            tau=cfg.tau, rho=cfg.rho, window=cfg.window,
            **{k: v for k, v in kw.items() if k in qb.BanditParams._fields})
        return qedgeproxy_strategy(params, cfg, K, M)
    if name.startswith("proxy_mity"):
        return proxy_mity_strategy(kw.get("alpha", 1.0), cfg, K, M)
    if name == "dec_sarsa":
        params = kw.get("params") or bl.DecSarsaParams(tau=cfg.tau)
        return dec_sarsa_strategy(params, cfg, K, M, pshard)
    raise ValueError(f"unknown strategy {name!r}")


# ---------------------------------------------------------------------------
# Main simulation loop.
# ---------------------------------------------------------------------------

def _stagger_groups(k_phase, K_global: int, n_phases: int, width: int,
                    lo: int, K_local: int) -> torch.Tensor:
    """Balanced staggered maintenance clocks (the reference's layout).

    Players tile into contiguous blocks of ``n_phases``; block ``b``
    assigns its members one phase each through
    ``permutation(fold_in(k_phase, b), n_phases)``. Row ``p`` lists the
    local indices of the players due at phase ``p``, padded with the
    sentinel ``K_local`` (only in the last, partial block). Leading key
    axes batch: (S, 2) keys give (S, n_phases, width), one table a
    lane."""
    dev = k_phase.device
    bids = lo // n_phases + torch.arange(width, device=dev)
    perm = prand.permutation(prand.fold_in(k_phase[..., None, :], bids),
                             n_phases)
    inv = torch.argsort(perm, dim=-1)
    gplayer = bids[:, None] * n_phases + inv
    local = gplayer - lo
    ok = (gplayer < K_global) & (local >= 0) & (local < K_local)
    return torch.where(ok, local, K_local).transpose(-1, -2).to(torch.int32)


def _row(drawn, r: int):
    """Round ``r``'s row of a ``draw`` result (a tensor, a tuple, None)."""
    if drawn is None:
        return None
    if isinstance(drawn, tuple):
        return tuple(x[r] for x in drawn)
    return drawn[r]


def _lane_parts(strategy_name: str, cfg: SimConfig, K: int, M: int, S: int,
                fused: bool, trace: bool, warmup_steps: int, pshard,
                **strategy_kw):
    """``build_sim_parts`` for S lanes of K players each: ``rtt``
    (S, K, M), ``active0`` (S, M), ``key`` (S, 2) and (S, T, 2) keys
    out; every ``xs`` field and ``marks`` with a leading (S,) axis but
    ``t_idx`` and ``group_t``, which lists the due players of every
    lane numbered across the lanes (lane s's player k is ``s·K + k``;
    sentinel ``S·K``); ``changed`` an (S,) numpy bool array; the queue
    and liveness (S, M), the accumulator and ``ys`` with a leading (S,)
    axis."""
    _check_main_path(cfg, pshard)
    T, C, SK = cfg.num_steps, cfg.max_clients, S * K
    strat = make_strategy(strategy_name, cfg, SK, M, **strategy_kw)
    batched_record = fused and "record_rings" in strat
    subset_maint = fused and "maintain_subset" in strat
    fused_round_on = (cfg.fused_round and batched_record
                      and "fused_round" in strat)
    feed = strat["record_feedback"] if batched_record else strat["record"]
    n_phases = max(cfg.maint_every, 1)
    n_blocks = -(-K // n_phases)
    ev_pre_steps = max(1, int(round(cfg.ev_pre / cfg.dt)))
    ev_bucket_steps = max(1, int(round(cfg.ev_bucket / cfg.dt)))
    dt32 = np.float32(cfg.dt)

    def init_fn(rtt, active0, key, pids=None):
        dev = rtt.device
        if pids is None:
            pids = torch.arange(K, dtype=torch.int32, device=dev)
        k_init, k_phase, k_scan = prand.split(key, 3).unbind(-2)
        s0 = strat["init"](rtt.reshape(SK, M), active0, k_init, pids)
        q0 = torch.zeros(S, M, dtype=torch.float32, device=dev)
        # each lane's table, its players numbered across the lanes; the
        # sentinel becomes S·K
        g = _stagger_groups(k_phase, K, n_phases, n_blocks, 0, K).long()
        lane = torch.arange(S, device=dev)[:, None, None]
        g = torch.where(g < K, g + lane * K, SK)
        groups = g.transpose(0, 1).reshape(n_phases, S * n_blocks).to(
            torch.int32)
        acc = None if trace else qm.init_accumulator(
            K, M, C, n_marks=qs.MAX_MARKS, ev_buckets=cfg.ev_buckets,
            device=dev, lanes=S)
        keys = prand.split(k_scan, T)
        return (s0, q0, active0, acc, groups, pids, None, None, None), keys

    def round_scan(state, q, act, t, rtt_t, s_m, served, k_step, pids,
                   mask_all):
        """The C rounds in order: select, feedback, the shared queues.
        Every round's keys and noise are drawn before the loop."""
        dev = q.device
        ks = _round_keys(k_step, C)
        z = _noise(cfg, ks[..., 1, :], pids)             # (C, S·K)
        drawn = _by_round(strat["draw"](ks[..., 0, :], pids))
        kidx = torch.arange(SK, device=dev)
        lane = lane_of(SK, S, dev)
        arrivals = torch.zeros(S, M, dtype=torch.float32, device=dev)
        ch_r, lat_r, proc_r = [], [], []
        for r in range(C):
            mask = mask_all[:, r]
            choice, state = strat["select"](state, _row(drawn, r), t, act,
                                            pids)
            q1s = (q[lane, choice] + 1.0) * s_m[lane, choice]
            proc = q1s * z[r]
            # the reference's compiler fuses rtt + (q+1)s * z into one
            # FMA, so the sum rounds once (as in the fused round)
            lat = fmath.fma(q1s, z[r], rtt_t[kidx, choice])
            state = feed(state, choice, lat, t, mask)
            arr_r = torch.zeros(S * M, dtype=torch.float32,
                                device=dev).index_add_(
                0, lane * M + choice, mask.to(torch.float32)).reshape(S, M)
            q = torch.clamp_min(q + arr_r - served, 0.0)
            arrivals = arrivals + arr_r          # integer-valued: order-free
            ch_r.append(choice)
            lat_r.append(lat)
            proc_r.append(proc)
        choices = torch.stack(ch_r, dim=1).to(torch.int32)
        lats, procs = torch.stack(lat_r, dim=1), torch.stack(proc_r, dim=1)
        if batched_record:
            state = strat["record_rings"](state, choices, lats, t, mask_all)
        return state, q, arrivals, choices, lats, procs

    def step_fn(rtt, marks, carry, xs, changed):
        state, q, prev_active, acc, groups, pids, brk, ctl, rec = carry
        t_idx, nc, act, rtt_scale, cut_k, cut_m, s_m, k_step, group = xs
        dev = rtt.device
        t_host = float(np.float32(t_idx) * dt32)
        t = torch.full((), t_host, dtype=torch.float32, device=dev)

        # effective RTT and service rows for this step, the players of
        # every lane as rows
        rtt_t = (rtt * rtt_scale[:, None, :] + torch.minimum(
            cut_k[:, :, None], cut_m[:, None, :])).reshape(SK, M)

        # placement events (paper Alg 3/4), flagged on the host per lane;
        # each strategy moves only the lanes whose liveness changed
        if changed.any():
            state = strat["on_activity"](state, act, rtt_t, t,
                                         torch.as_tensor(changed, device=dev))

        # maintenance: only the player group whose clock fires
        if subset_maint:
            state = strat["maintain_subset"](state, rtt_t, t, group)
        else:
            lb_mask = torch.zeros(SK + 1, dtype=torch.bool, device=dev)
            lb_mask[group.to(torch.int64)] = True       # sentinel SK: dropped
            state = strat["maintain"](state, rtt_t, t, lb_mask[:SK])

        mu_true = _true_mu(rtt_t, lane_rows(q, SK), cfg,
                           lane_rows(s_m, SK))       # at step start
        w_now = strat["weights"](state)
        reg = step_regret(w_now, mu_true, act)
        q_start = q
        nc = nc.reshape(SK)
        mask_all = torch.arange(C, device=dev)[None, :] < nc[:, None]
        served_per_round = torch.full_like(s_m, cfg.dt) / (C * s_m)

        if fused_round_on:
            state, q, arrivals, choices, lats, procs = strat["fused_round"](
                state, q, nc, act, t_host, rtt_t, s_m, served_per_round,
                k_step, pids)
        else:
            state, q, arrivals, choices, lats, procs = round_scan(
                state, q, act, t, rtt_t, s_m, served_per_round, k_step,
                pids, mask_all)
        att_kc = mask_all.to(torch.int32).reshape(S, K, C)
        rewards = (lats <= cfg.tau).to(torch.float32).reshape(S, K, C)
        mask_kc = mask_all.reshape(S, K, C)
        choices, lats = choices.reshape(S, K, C), lats.reshape(S, K, C)
        procs = procs.reshape(S, K, C)
        reg = reg.reshape(S, K)
        if trace:
            ys = SimOutputs(
                rewards=rewards, issued=mask_kc, choices=choices,
                latency=lats, proc_lat=procs, arrivals=arrivals,
                queue=q_start, weights=w_now.reshape(S, K, M),
                true_mu=mu_true.reshape(S, K, M), regret=reg,
                eps=strat["eps"](state).reshape(S, K), attempts=att_kc,
                dropped=torch.zeros_like(mask_kc))
        else:
            acc = qm.update_accumulator(
                acc, rewards=rewards, issued=mask_kc, choices=choices,
                procs=procs, arrivals=arrivals, regret=reg,
                mu=mu_true.reshape(S, K, M), t_idx=t_idx,
                warmup_steps=warmup_steps, marks=marks,
                ev_pre_steps=ev_pre_steps, ev_bucket_steps=ev_bucket_steps,
                attempts=att_kc, dropped=torch.zeros_like(mask_kc))
            issf = mask_kc.to(torch.float32)
            ys = StepSeries(succ=(rewards * issf).sum((1, 2)),
                            issued=issf.sum((1, 2)), regret=reg.sum(-1),
                            attempts=att_kc.to(torch.float32).sum((1, 2)))
        return (state, q, act, acc, groups, pids, brk, ctl, rec), ys

    return init_fn, step_fn


def _with_active(state, f):
    """``state`` with ``f`` applied to its ``active`` field, if any."""
    if "active" in getattr(state, "_fields", ()):
        return state._replace(active=f(state.active))
    return state


def build_sim_parts(strategy_name: str, cfg: SimConfig, K: int, M: int,
                    fused: bool = True, trace: bool = True,
                    warmup_steps: int = 0, pshard=None, **strategy_kw):
    """The engine's two halves, ``(init_fn, step_fn)``.

    * ``init_fn(rtt, active0, key, pids=None) -> (carry0, keys)``: the
      strategy state, an empty queue and (streaming) accumulator, the
      stagger table and the (T, 2) per-step keys.
    * ``step_fn(rtt, marks, carry, xs, changed) -> (carry, ys)``: one
      step. ``xs = (t_idx, n_clients_t, active_t, rtt_scale_t,
      rtt_cut_k_t, rtt_cut_m_t, s_m_t, key_t, group_t)`` with ``t_idx``
      a host integer and ``group_t`` the players due for maintenance
      (padded with the sentinel ``K``); ``changed`` is the host flag
      "liveness differs from the previous step" that fires the Alg 3/4
      placement event. ``ys`` is a ``SimOutputs`` row in trace mode,
      a ``StepSeries`` row of 0-dim tensors otherwise.

    ``fused=False`` forces the reference's pre-fusion step structure
    (per-round ``record`` calls and full-width maintenance masked by
    ``lb_mask``); ``cfg.fused_round=False`` keeps the batched ring
    writes and subset maintenance but runs the C rounds as a scan
    instead of one fused call. The carry is the reference's 9 slots
    ``(state, queue, prev_active, acc, groups, pids, breaker, control,
    recorder)``; ``acc`` is None in trace mode and the last three are
    None on this path.
    """
    init1, step1 = _lane_parts(strategy_name, cfg, K, M, 1, fused, trace,
                               warmup_steps, pshard, **strategy_kw)

    def one(x):
        return None if x is None else type(x)(*(v[None] for v in x))

    def first(x):
        return None if x is None else type(x)(*(v[0] for v in x))

    def to_lanes(carry):
        state, q, prev, acc, *rest = carry
        return (_with_active(state, lambda a: a[None]), q[None], prev[None],
                one(acc), *rest)

    def from_lanes(carry):
        state, q, prev, acc, *rest = carry
        return (_with_active(state, lambda a: a[0]), q[0], prev[0],
                first(acc), *rest)

    def init_fn(rtt, active0, key, pids=None):
        carry, keys = init1(rtt[None], active0[None], key[None], pids)
        return from_lanes(carry), keys[0]

    def step_fn(rtt, marks, carry, xs, changed: bool):
        t_idx, *fields, key, group = xs
        carry, ys = step1(rtt[None], marks[None], to_lanes(carry),
                          (t_idx, *(f[None] for f in fields), key[None],
                           group), np.array([changed]))
        return from_lanes(carry), first(ys)

    return init_fn, step_fn


def _changed_flags(active: torch.Tensor) -> np.ndarray:
    """(T, S) host flags from (S, T, M) liveness: does lane s's step t
    differ from its step t-1 (step 0 compares with itself, as the carry
    starts at ``active[:, 0]``)."""
    a = active.cpu().numpy()
    prev = np.concatenate([a[:, :1], a[:, :-1]], axis=1)
    return (a != prev).any(-1).T


def _lane_drivers(drivers: Drivers, S: int) -> Drivers:
    """Drivers with a leading (S,) lane axis: a ``stack_drivers`` batch
    as it is, one shared schedule broadcast to every lane (as the
    reference batches when ``active`` is (S, T, M))."""
    if drivers.active.dim() == 3:
        if drivers.active.shape[0] != S:
            raise ValueError(f"{drivers.active.shape[0]} lanes of drivers "
                             f"for {S} lanes of rtt and keys")
        return drivers
    return Drivers(*(x[None].expand(S, *x.shape) for x in drivers))


def _build_lanes_fn(strategy_name: str, cfg: SimConfig, K: int, M: int,
                    S: int, fused: bool, trace: bool, warmup_steps: int,
                    pshard, **strategy_kw):
    """``run(rtts, drivers, keys, service_time=None, pids=None)`` of S
    lanes; outputs with a leading (S,) axis."""
    T = cfg.num_steps
    init_fn, step_fn = _lane_parts(
        strategy_name, cfg, K, M, S, fused=fused, trace=trace,
        warmup_steps=warmup_steps, pshard=pshard, **strategy_kw)

    def run(rtts, drivers: Drivers, keys, service_time=None, pids=None):
        dev = rtts.device
        drivers = _lane_drivers(drivers, S)
        if service_time is not None:
            drivers = drivers._replace(
                s_m=torch.full_like(drivers.s_m, service_time))
        carry, step_keys = init_fn(rtts, drivers.active[:, 0].contiguous(),
                                   keys, pids)
        changed = _changed_flags(drivers.active)
        # time-major copies, so a step reads contiguous (S, ...) rows
        by_step = [getattr(drivers, f).transpose(0, 1).contiguous()
                   for f in qs.STEP_FIELDS]
        step_keys = step_keys.transpose(0, 1).contiguous()
        n_phases = max(cfg.maint_every, 1)
        rows = None
        for i in range(T):
            xs = (i, *(f[i] for f in by_step), step_keys[i],
                  carry[4][i % n_phases])
            carry, ys = step_fn(rtts, drivers.marks, carry, xs, changed[i])
            if rows is None:
                rows = [torch.empty((T, *y.shape), dtype=y.dtype, device=dev)
                        for y in ys]
            for buf, y in zip(rows, ys):
                buf[i] = y
        host = [buf.cpu().movedim(0, 1).contiguous() for buf in rows]
        if trace:
            return SimOutputs(*host)
        return StreamOutputs(acc=carry[3], series=StepSeries(*host))

    return run


def build_sim_fn(strategy_name: str, cfg: SimConfig, K: int, M: int,
                 fused: bool = True, trace: bool = True,
                 warmup_steps: int = 0, pshard=None, **strategy_kw):
    """``run(rtt, drivers, key, service_time=None, pids=None)`` on the
    device of ``rtt``. ``trace=True`` returns ``SimOutputs``
    trajectories (O(T·K·M) memory: each step's row is written into
    preallocated device buffers, read to the host once at the end);
    ``trace=False`` returns ``StreamOutputs`` (the accumulator on the
    device, the O(T) series on the host). ``warmup_steps`` gates the
    accumulator and is ignored in trace mode. The run is the one-lane
    case of the lane-batched run."""
    run1 = _build_lanes_fn(strategy_name, cfg, K, M, 1, fused, trace,
                           warmup_steps, pshard, **strategy_kw)

    def run(rtt, drivers: Drivers, key, service_time=None, pids=None):
        one = Drivers(*(x[None] for x in drivers))
        return qm.lane(run1(rtt[None], one, key[None], service_time, pids), 0)

    return run


def _resolve_drivers(cfg, K, M, drivers, n_clients, active, device):
    if drivers is not None:
        if n_clients is not None or active is not None:
            raise ValueError("pass either drivers= or n_clients=/active=, "
                             "not both")
        return Drivers(*(x.to(device) for x in drivers))
    return qs.neutral_drivers(cfg, K, M, n_clients=n_clients, active=active,
                              device=device)


def _inputs(rtt, key, device):
    """``rtt`` as float32 and ``key`` as key words (an integer seed is
    ``prand.prng_key(seed)``), both on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    if not isinstance(rtt, torch.Tensor):
        rtt = torch.tensor(np.asarray(rtt), dtype=torch.float32)
    rtt = rtt.to(dev, torch.float32)
    key = (prand.prng_key(key, dev) if isinstance(key, int)
           else torch.as_tensor(key, dtype=torch.int64).to(dev))
    return dev, rtt, key


def _lane_inputs(rtts, keys, device):
    """``_inputs`` for S lanes: ``rtts`` (S, K, M), ``keys`` an (S, 2)
    tensor or S integer seeds."""
    if not isinstance(keys, torch.Tensor) and all(
            isinstance(k, int) for k in keys):
        keys = torch.stack([prand.prng_key(k) for k in keys])
    dev, rtts, keys = _inputs(rtts, keys, device)
    if rtts.dim() != 3 or keys.shape != (rtts.shape[0], 2):
        raise ValueError(f"lanes need (S, K, M) rtts and (S, 2) keys; got "
                         f"{tuple(rtts.shape)} and {tuple(keys.shape)}")
    return dev, rtts, keys


def run_sim(
    strategy_name: str,
    rtt,                          # (K, M) base LB->instance RTT [s]
    cfg: SimConfig,
    key,                          # (2,) key tensor, or an integer seed
    n_clients: torch.Tensor | None = None,   # (T, K)
    active: torch.Tensor | None = None,      # (T, M)
    drivers: Drivers | None = None,
    device=None,
    **strategy_kw,
) -> SimOutputs:
    """Run one topology x strategy for the full horizon, trace mode:
    ``SimOutputs`` trajectories on the host.

    Runs on ``device`` (default ``cuda``), as ``run_sim_stream``;
    ``drivers`` takes a compiled scenario, the ``n_clients``/``active``
    schedules wrap into neutral drivers. ``strategy_kw`` takes the
    strategy's parameters and ``fused=False``."""
    dev, rtt, key = _inputs(rtt, key, device)
    K, M = rtt.shape
    drv = _resolve_drivers(cfg, K, M, drivers, n_clients, active, dev)
    return build_sim_fn(strategy_name, cfg, K, M, trace=True,
                        **strategy_kw)(rtt, drv, key)


def run_sim_batch(
    strategy_name: str,
    rtts,                         # (S, K, M) one base RTT matrix per lane
    cfg: SimConfig,
    keys,                         # (S, 2) keys, or S integer seeds
    n_clients: torch.Tensor | None = None,   # (T, K), shared by the lanes
    active: torch.Tensor | None = None,      # (T, M), shared by the lanes
    drivers: Drivers | None = None,          # shared, or an (S, ·) batch
    device=None,
    **strategy_kw,
) -> SimOutputs:
    """S lanes of trace mode in one run: ``SimOutputs`` with a leading
    (S,) axis on every field. A ``scenarios.stack_drivers`` batch gives
    every lane its own compiled scenario; a plain ``Drivers`` (or the
    ``n_clients``/``active`` schedules) is shared by the lanes. Lane s
    equals ``run_sim`` on its rtt, drivers and key."""
    dev, rtts, keys = _lane_inputs(rtts, keys, device)
    S, K, M = rtts.shape
    drv = _resolve_drivers(cfg, K, M, drivers, n_clients, active, dev)
    return _build_lanes_fn(strategy_name, cfg, K, M, S, True, True, 0, None,
                           **strategy_kw)(rtts, drv, keys)


def _check_one_device(mesh) -> None:
    """A grid mesh of one device runs the plain lanes; more waits for
    the sharded grid."""
    if mesh is None:
        return
    size = getattr(mesh, "size", None)
    n = size() if callable(size) else None
    if n != 1:
        raise _not_ported("grid lanes over more than one device", "A10")


def build_sim_grid_fn(strategy_name: str, cfg: SimConfig, K: int, M: int,
                      mesh=None, warmup_steps: int = 0, fused: bool = True,
                      **strategy_kw):
    """``(run_grid, mesh)``: ``run_grid(rtts, drivers, keys)`` streams S
    lanes (``rtts`` (S, K, M), ``drivers`` an (S, ·) batch or shared,
    ``keys`` (S, 2)) and returns ``StreamOutputs`` with a leading (S,)
    axis, as the reference's single-device grid (its plain vmap) does.
    A mesh of more than one device is not ported (ROADMAP A10)."""
    _check_one_device(mesh)

    def run_grid(rtts, drivers: Drivers, keys):
        S = rtts.shape[0]
        return _build_lanes_fn(strategy_name, cfg, K, M, S, fused, False,
                               warmup_steps, None, **strategy_kw)(
            rtts, drivers, keys)

    return run_grid, mesh


def run_sim_grid(
    strategy_name: str,
    rtts,                         # (S, K, M) one base RTT matrix per lane
    cfg: SimConfig,
    keys,                         # (S, 2) keys, or S integer seeds
    n_clients: torch.Tensor | None = None,   # (T, K), shared by the lanes
    active: torch.Tensor | None = None,      # (T, M), shared by the lanes
    drivers: Drivers | None = None,          # shared, or an (S, ·) batch
    warmup_steps: int = 0,
    mesh=None,
    device=None,
    **strategy_kw,
) -> StreamOutputs:
    """Streaming lanes: ``run_sim_batch``'s semantics, ``StreamOutputs``
    with a leading (S,) axis (``metrics.lane`` takes one out). Lane s
    equals ``run_sim_stream`` on its rtt, drivers and key, bit for
    bit; each step launches each kernel once for all lanes."""
    _check_one_device(mesh)
    dev, rtts, keys = _lane_inputs(rtts, keys, device)
    S, K, M = rtts.shape
    drv = _resolve_drivers(cfg, K, M, drivers, n_clients, active, dev)
    run_grid, _ = build_sim_grid_fn(strategy_name, cfg, K, M, mesh=mesh,
                                    warmup_steps=warmup_steps, **strategy_kw)
    return run_grid(rtts, drv, keys)


def run_sim_stream(
    strategy_name: str,
    rtt,                          # (K, M) base LB->instance RTT [s]
    cfg: SimConfig,
    key,                          # (2,) key tensor, or an integer seed
    n_clients: torch.Tensor | None = None,   # (T, K)
    active: torch.Tensor | None = None,      # (T, M)
    drivers: Drivers | None = None,
    warmup_steps: int = 0,
    chunk_steps: int | None = None,
    mesh=None,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 1,
    resume: bool = False,
    stop_at_step: int | None = None,
    device=None,
    **strategy_kw,
) -> StreamOutputs:
    """Streaming run: O(K·M) device memory, O(T) scalar series.

    Runs on ``device`` (default ``cuda``); ``rtt``, ``key`` and the
    drivers move there. ``key`` is a ``(2,)`` tensor of uint32 words
    (``prand.prng_key(seed)``, or ``convert.key_to_torch`` of a JAX
    key) or an integer seed. Chunked horizons with checkpointing and
    player meshes are not ported yet and raise.
    """
    if chunk_steps is not None and chunk_steps < cfg.num_steps:
        raise _not_ported("chunked horizons (chunk_steps)", "A8")
    if mesh is not None:
        raise _not_ported("player meshes", "A10")
    if checkpoint_dir is not None or resume or stop_at_step is not None:
        raise _not_ported("checkpoint/resume", "A8")
    dev, rtt, key = _inputs(rtt, key, device)
    K, M = rtt.shape
    drv = _resolve_drivers(cfg, K, M, drivers, n_clients, active, dev)
    run = build_sim_fn(strategy_name, cfg, K, M, trace=False,
                       warmup_steps=warmup_steps, **strategy_kw)
    return run(rtt, drv, key)
