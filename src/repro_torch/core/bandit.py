"""QEdgeProxy MP-MAB core (paper §IV–V, Algorithms 1–4).

Port of ``repro/core/bandit.py``: the state, the request path (SWRR
selection, feedback, ring writes), the request lifecycle's circuit
breakers, vetoed and retried picks and censored observations, Alg-1
maintenance and the Alg 3/4 placement events. The state factorizes
over players (load balancers); every reduction is over the trailing
per-player axes.

State layout (R = ring-buffer capacity per (player, arm)):
  lat_buf (K,M,R) f32   end-to-end latency samples
  ts_buf  (K,M,R) f32   sample timestamps (NEG_INF = empty)
  ptr     (K,M)   i32   ring pointers
  mu_hat  (K,M)   f32   KDE success-probability estimates
  weights (K,M)   f32   routing weights (rows sum to 1 over the pool)
  cw      (K,M)   f32   SWRR current weights
  eps     (K,)    f32   exploration budget epsilon(t)
  err     (K,M)   i32   consecutive-error counters (Alg 2 line 5)
  cooldown_until (K,M) f32
  active  (M,)    bool  instance liveness (Alg 3/4); (S, M) with lanes
  in_pool (K,M)   bool  QoS pool membership Q_k(t)
  explore (K,M)   bool  exploration-pool membership X_k(t)
  r_buf   (K,Rq)  f32   own-request reward ring (QoS_a degradation test)
  rts_buf (K,Rq)  f32   reward timestamps
  rptr    (K,)    i32

Lanes: the state may hold S independent simulations side by side (the
reference's vmapped grid axis). Their players are the rows, lane s
owning rows [s·K/S, (s+1)·K/S), and ``active`` is (S, M), one row a
lane (``kernels.ref.lane_rows`` spreads it over the players). Every
function then computes for each lane what it computes for that lane
alone.

Functions return new tensors and leave their inputs untouched, as the
reference's pure functions do. ``t`` may be a 0-dim float32 tensor or a
float32-representable Python float; time arithmetic happens in float32.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import kde as kde_mod
from repro_torch.core import fmath, prand
from repro_torch.core.swrr import swrr_select
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ref import (_ring_scatter, _row_sum, _xla_row_sum,
                                     lane_rows)

_F32 = torch.float32
_I32 = torch.int32


class BanditParams(NamedTuple):
    """QoS requirements + algorithm hyperparameters (paper Table I/II)."""

    tau: float = 0.080          # latency threshold [s]
    rho: float = 0.9            # required success ratio
    window: float = 10.0        # sliding window W [s]
    gamma: float = 0.01         # epsilon-decay factor
    eta: float = 0.01           # score smoothing floor
    err_thresh: int = 5         # E_t
    cooldown: float = 10.0      # Delta_cd [s]
    decay_mode: int = 0         # 0: eps*=(1-gamma)  1: eps*=gamma (literal)
    kde_mode: int = 0           # 0: KDE  1: empirical fraction (ablation)
    min_bandwidth: float = 1e-4
    reset_hysteresis: float = 0.0   # QoS_a drop needed to trigger reset
    ucb_coef: float = 0.0       # >0 enables beyond-paper UCB bonus
    unseen_mu: float = -1.0     # <0 => rho - 1e-6 (paper Alg 3 semantics)
    weight_ema: float = 0.0     # beyond-paper: damp weight jumps


class BanditState(NamedTuple):
    lat_buf: torch.Tensor
    ts_buf: torch.Tensor
    ptr: torch.Tensor
    mu_hat: torch.Tensor
    weights: torch.Tensor
    cw: torch.Tensor
    eps: torch.Tensor
    err: torch.Tensor
    cooldown_until: torch.Tensor
    active: torch.Tensor
    in_pool: torch.Tensor
    explore: torch.Tensor
    r_buf: torch.Tensor
    rts_buf: torch.Tensor
    rptr: torch.Tensor

    @property
    def num_players(self) -> int:
        return self.lat_buf.shape[0]

    @property
    def num_arms(self) -> int:
        return self.lat_buf.shape[1]


NEG_INF = -1e30
_F32_MAX = torch.finfo(_F32).max


def _folded(a: float, b: float) -> float:
    """``a + b`` as a compiler folds two float32 constants."""
    return float(np.float32(a) + np.float32(b))


def init_state(
    num_players: int,
    num_arms: int,
    params: BanditParams,
    ring: int = 64,
    reward_ring: int = 512,
    active: torch.Tensor | None = None,
    key: torch.Tensor | None = None,
    pids: torch.Tensor | None = None,
    device=None,
) -> BanditState:
    """Paper Alg 1 lines 1–5: uniform weights, eps = 1 - rho.

    ``key`` randomizes the SWRR phase (``prand`` draws, keyed per global
    player id when ``pids`` is given), as in the reference. The state
    lives on ``active``'s device when it is given, else on ``device``
    (default ``cuda``). Lanes: an (S, M) ``active`` with an (S, 2)
    ``key`` and a lane's (num_players / S,) ``pids`` starts S lanes.
    """
    K, M, R = num_players, num_arms, ring
    dev = active.device if active is not None else resolve_device(device)
    if active is None:
        active = torch.ones(M, dtype=torch.bool, device=dev)
    act = lane_rows(active, K).to(_F32) * torch.ones(K, 1, dtype=_F32,
                                                     device=dev)
    n_act = torch.clamp_min(act.sum(-1, keepdim=True), 1.0)
    if key is None:
        cw0 = torch.zeros(K, M, dtype=_F32, device=dev)
    elif pids is not None:
        cw0 = prand.player_uniform_row(key, pids, M).reshape(K, M) \
            / torch.clamp_min(n_act, 1.0)
    else:
        cw0 = prand.uniform(key, (K, M)) / torch.clamp_min(n_act, 1.0)
    pool = lane_rows(active, K) & torch.ones(K, M, dtype=torch.bool,
                                             device=dev)
    return BanditState(
        lat_buf=torch.zeros(K, M, R, dtype=_F32, device=dev),
        ts_buf=torch.full((K, M, R), NEG_INF, dtype=_F32, device=dev),
        ptr=torch.zeros(K, M, dtype=_I32, device=dev),
        mu_hat=torch.zeros(K, M, dtype=_F32, device=dev),
        weights=act / n_act,
        cw=cw0,
        eps=torch.full((K,), 1.0 - params.rho, dtype=_F32, device=dev),
        err=torch.zeros(K, M, dtype=_I32, device=dev),
        cooldown_until=torch.full((K, M), NEG_INF, dtype=_F32, device=dev),
        active=active,
        in_pool=pool,
        explore=pool.clone(),
        r_buf=torch.zeros(K, reward_ring, dtype=_F32, device=dev),
        rts_buf=torch.full((K, reward_ring), NEG_INF, dtype=_F32, device=dev),
        rptr=torch.zeros(K, dtype=_I32, device=dev),
    )


def _time(t, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(t, dtype=_F32, device=like.device)


# ---------------------------------------------------------------------------
# Request path (Alg 2): select via SWRR, record feedback, cooldown.
# ---------------------------------------------------------------------------

def select(state: BanditState):
    """SWRR selection for every player. Returns (choice, state, valid)."""
    choice, cw, valid = swrr_select(state.weights, state.cw)
    return choice, state._replace(cw=cw), valid


def _record_control(state: BanditState, params: BanditParams,
                    choice: torch.Tensor, reward: torch.Tensor, t,
                    mask: torch.Tensor, cooldown_at=None) -> BanditState:
    """Error/cooldown/pool/weight part of one record round (Alg 2
    lines 5-9). Touches only (K, M) fields. ``cooldown_at`` overrides
    the deadline ``t + cooldown`` of a tripped arm with the caller's own
    rounding of that sum (the simulator's, as the reference's compiler
    rounds ``t_idx * dt + cooldown``)."""
    K, M, _ = state.lat_buf.shape
    t = _time(t, state.weights)
    ch = choice.to(torch.int64)
    kidx = torch.arange(K, device=ch.device)
    old_err = state.err[kidx, ch]
    new_err = torch.where(reward > 0, 0, old_err + 1).to(_I32)
    trip = mask & (new_err >= params.err_thresh)
    err = state.err.index_put(
        (kidx, ch),
        torch.where(mask, torch.where(trip, 0, new_err), old_err).to(_I32))
    if cooldown_at is None:
        cooldown_at = t + params.cooldown
    cd = state.cooldown_until.index_put(
        (kidx, ch), torch.where(trip, cooldown_at,
                                state.cooldown_until[kidx, ch]))

    # remove tripped arms from the pool immediately and renormalize
    tripped = torch.nn.functional.one_hot(ch, M).to(torch.bool) & trip[:, None]
    in_pool = state.in_pool & ~tripped
    w = torch.where(tripped, 0.0, state.weights)
    wsum = _row_sum(w)          # left to right, as the fused round sums
    act = lane_rows(state.active, K)
    remaining = in_pool & act
    rem_any = remaining.any(-1, keepdim=True)
    fallback = torch.where(rem_any, remaining, act & ~tripped).to(_F32)
    fallback = fallback / torch.clamp_min(fallback.sum(-1, keepdim=True), 1.0)
    weights = torch.where(wsum > 0, w / torch.clamp_min(wsum, 1e-30), fallback)

    # a cooled-down arm must not keep winning on stale SWRR credit
    cw = torch.where(tripped, 0.0, state.cw)
    return state._replace(err=err, cooldown_until=cd, in_pool=in_pool,
                          weights=weights, cw=cw)


def record(state: BanditState, params: BanditParams, choice: torch.Tensor,
           latency: torch.Tensor, t, mask: torch.Tensor,
           cooldown_at=None) -> BanditState:
    """Record one request per player (Alg 2 lines 4–9), vectorized.
    Masked players leave the state untouched; ``cooldown_at`` as in
    ``record_feedback``."""
    K, M, R = state.lat_buf.shape
    t = _time(t, state.weights)
    ch = choice.to(torch.int64)
    kidx = torch.arange(K, device=ch.device)
    reward = (latency <= params.tau).to(_F32)

    p = state.ptr[kidx, ch].to(torch.int64)
    idx = (kidx, ch, p)
    lat_buf = state.lat_buf.index_put(
        idx, torch.where(mask, latency, state.lat_buf[idx]))
    ts_buf = state.ts_buf.index_put(idx, torch.where(mask, t, state.ts_buf[idx]))
    ptr = state.ptr.index_put(
        (kidx, ch), torch.where(mask, (p + 1) % R, p).to(_I32))

    rp = state.rptr.to(torch.int64)
    r_buf = state.r_buf.index_put(
        (kidx, rp), torch.where(mask, reward, state.r_buf[kidx, rp]))
    rts_buf = state.rts_buf.index_put(
        (kidx, rp), torch.where(mask, t, state.rts_buf[kidx, rp]))
    rptr = torch.where(mask, (rp + 1) % state.r_buf.shape[1], rp).to(_I32)

    state = state._replace(lat_buf=lat_buf, ts_buf=ts_buf, ptr=ptr,
                           r_buf=r_buf, rts_buf=rts_buf, rptr=rptr)
    return _record_control(state, params, choice, reward, t, mask,
                           cooldown_at)


def record_feedback(state: BanditState, params: BanditParams,
                    choice: torch.Tensor, latency: torch.Tensor, t,
                    mask: torch.Tensor, cooldown_at=None) -> BanditState:
    """Control half of one record round: err/cooldown/pool/weights but
    no ring writes (pair with ``record_rings_batch``). ``cooldown_at``
    (a host number) replaces ``t + params.cooldown`` as a tripped arm's
    deadline."""
    reward = (latency <= params.tau).to(_F32)
    return _record_control(state, params, choice, reward, t, mask,
                           cooldown_at)


def record_rings_batch(state: BanditState, params: BanditParams,
                       choices: torch.Tensor, latencies: torch.Tensor, t,
                       mask: torch.Tensor) -> BanditState:
    """Ring-buffer half of a batch record: all C requests' latency,
    timestamp and reward samples land in one scatter whose final
    buffers equal C sequential ``record`` calls (the j-th masked write
    of the batch to arm m lands at ``(ptr + j) % R``; writes a later
    same-slot write would overwrite are dropped up front)."""
    lat_buf, ts_buf, ptr, r_buf, rts_buf, rptr = _ring_scatter(
        state.lat_buf, state.ts_buf, state.ptr, state.r_buf, state.rts_buf,
        state.rptr, choices, latencies, _time(t, state.weights), mask,
        params.tau)
    return state._replace(lat_buf=lat_buf, ts_buf=ts_buf, ptr=ptr,
                          r_buf=r_buf, rts_buf=rts_buf, rptr=rptr)


def record_batch(state: BanditState, params: BanditParams,
                 choices: torch.Tensor, latencies: torch.Tensor, t,
                 mask: torch.Tensor) -> BanditState:
    """Ingest all C requests of a step: one ring scatter plus an
    in-order replay of the (K, M) control flow over the C columns.
    Bit for bit equal to C sequential ``record`` calls."""
    state = record_rings_batch(state, params, choices, latencies, t, mask)
    for c in range(choices.shape[1]):
        state = record_feedback(state, params, choices[:, c],
                                latencies[:, c], t, mask[:, c])
    return state


# ---------------------------------------------------------------------------
# Request-lifecycle resilience: circuit breakers + censored observations.
#
# An Envoy-style breaker sits between the balancer and the wire: an arm
# whose last ``threshold`` attempts all timed out is ejected for
# ``cooldown`` seconds and traffic re-routes over the remaining pool;
# after the cooldown one half-open probe is admitted, a further timeout
# re-trips it and a success closes it. The state is (players, M), no
# cross-player terms; with lanes its rows are the players of every lane
# and ``active`` is (S, M).
# ---------------------------------------------------------------------------

class BreakerState(NamedTuple):
    """Per-(player, arm) circuit breaker state.

    fails      (K, M) i32  consecutive timed-out attempts
    open_until (K, M) f32  ejected until this sim time (NEG_INF = closed)
    """
    fails: torch.Tensor
    open_until: torch.Tensor


def breaker_init(num_players: int, num_arms: int, device=None) -> BreakerState:
    dev = resolve_device(device)
    return BreakerState(
        fails=torch.zeros(num_players, num_arms, dtype=_I32, device=dev),
        open_until=torch.full((num_players, num_arms), NEG_INF, dtype=_F32,
                              device=dev))


def breaker_is_open(brk: BreakerState, t) -> torch.Tensor:
    """(K, M) bool: arm currently ejected for this player."""
    return _time(t, brk.open_until) < brk.open_until


def breaker_update(brk: BreakerState, choice: torch.Tensor,
                   timed_out: torch.Tensor, attempted: torch.Tensor, t,
                   threshold: int, cooldown: float,
                   open_at=None) -> BreakerState:
    """Advance the breaker after one attempt per player: a success
    closes it (counter and ejection cleared), a timeout counts and at
    ``threshold`` opens the arm for ``cooldown`` seconds, leaving the
    counter at ``threshold - 1`` so the half-open probe re-trips on one
    failure. ``open_at`` overrides ``t + cooldown`` with the caller's
    own rounding of that sum."""
    K = brk.fails.shape[0]
    ch = choice.to(torch.int64)
    kidx = torch.arange(K, device=ch.device)
    old_f = brk.fails[kidx, ch]
    new_f = torch.where(timed_out, old_f + 1, 0).to(_I32)
    trip = attempted & (new_f >= threshold)
    new_f = torch.where(trip, threshold - 1, new_f).to(_I32)
    old_ou = brk.open_until[kidx, ch]
    if open_at is None:
        open_at = _time(t, old_ou) + cooldown
    new_ou = torch.where(trip, open_at,
                         torch.where(timed_out, old_ou, NEG_INF))
    return BreakerState(
        fails=brk.fails.index_put((kidx, ch),
                                  torch.where(attempted, new_f, old_f)),
        open_until=brk.open_until.index_put(
            (kidx, ch), torch.where(attempted, new_ou, old_ou)))


def breaker_reset_arms(brk: BreakerState, changed: torch.Tensor) -> BreakerState:
    """Clear the breaker columns of arms whose liveness changed (Alg 3/4
    purge the arm's bandit data the same way); ``changed`` is (M,) or
    (S, M)."""
    row = lane_rows(changed, brk.fails.shape[0])
    return BreakerState(fails=torch.where(row, 0, brk.fails).to(_I32),
                        open_until=torch.where(row, NEG_INF, brk.open_until))


def masked_pick(weights: torch.Tensor, ok: torch.Tensor,
                gumbel: torch.Tensor) -> torch.Tensor:
    """(K,) weighted sample over the arms ``ok`` allows (Gumbel trick):
    argmax of ``log(w + 1e-30) + g`` restricted to ``ok``, the log as
    the reference's compiler rounds it (``fmath.log``)."""
    score = fmath.log(weights + 1e-30) + gumbel
    return torch.argmax(torch.where(ok, score, NEG_INF), dim=-1)


def breaker_veto(choice: torch.Tensor, brk: BreakerState, t,
                 weights: torch.Tensor, active: torch.Tensor,
                 gumbel: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Re-route a pick whose arm is open to a weighted pick over closed
    active arms; fails open (no veto) when every active arm is open."""
    K = weights.shape[0]
    act = lane_rows(active, K)
    open_now = breaker_is_open(brk, t)
    ok = act & ~open_now
    ok = torch.where(ok.any(-1, keepdim=True), ok, act)
    alt = masked_pick(weights, ok, gumbel)
    ch = choice.to(torch.int64)
    blocked = mask & open_now[torch.arange(K, device=ch.device), ch]
    return torch.where(blocked, alt, ch)


def retry_pick(weights: torch.Tensor, active: torch.Tensor,
               avoid: torch.Tensor, open_now: torch.Tensor | None,
               gumbel: torch.Tensor) -> torch.Tensor:
    """A retry's arm: weighted pick over active, breaker-closed arms but
    the one that just failed; drops the breaker constraint when nothing
    is closed, and retries the failed arm when it is the only active
    one."""
    K, M = weights.shape
    act = lane_rows(active, K)
    ok = act & (torch.arange(M, device=weights.device)[None, :]
                != avoid.to(torch.int64)[:, None])
    if open_now is not None:
        okb = ok & ~open_now
        ok = torch.where(okb.any(-1, keepdim=True), okb, ok)
    ok = torch.where(ok.any(-1, keepdim=True), ok, act)
    return masked_pick(weights, ok, gumbel)


def censored_latency(attempt_timeout: float, tau: float) -> float:
    """The observation a timed-out attempt records: its lower bound
    pushed past the QoS threshold, so the KDE sees a miss (the safe
    direction for a balancer)."""
    return max(float(attempt_timeout), float(tau)) + float(tau)


# ---------------------------------------------------------------------------
# Maintenance (Alg 1): pools, KDE estimates, scores, weights, eps schedule.
# ---------------------------------------------------------------------------

def _rolling_qos(state: BanditState, t, window: float):
    """(QoS over [t-W, t), QoS over [t-2W, t-W)) per player."""
    t = _time(t, state.r_buf)
    ts = state.rts_buf
    cur_m = (ts >= t - window) & (ts < t)
    prev_m = (ts >= t - 2 * window) & (ts < t - window)

    def mean(mask):
        n = mask.sum(-1)
        s = (state.r_buf * mask).sum(-1)
        return torch.where(n > 0, s / torch.clamp_min(n, 1), 1.0), n

    cur, ncur = mean(cur_m)
    prev, nprev = mean(prev_m)
    return cur, prev, ncur, nprev


def maintenance(state: BanditState, params: BanditParams,
                rtt: torch.Tensor, t,
                lb_mask: torch.Tensor | None = None) -> BanditState:
    """One decision step of Alg 1 (lines 6–30), vectorized over players.

    ``lb_mask`` restricts the update to a subset of players. The window
    statistics go through ``kernels.ops.bandit_maintenance_stats``: the
    CUDA kernel on the card, its plain version on the CPU.
    """
    K, M, R = state.lat_buf.shape
    t = _time(t, state.weights)

    win = (state.ts_buf >= t - params.window) & (state.ts_buf < t) \
        & (state.ts_buf > NEG_INF / 2)

    if params.kde_mode == 0:
        mu_flat, proc_q_flat = kernel_ops.bandit_maintenance_stats(
            state.lat_buf.reshape(K * M, R), win.reshape(K * M, R),
            rtt.reshape(K * M), params.tau, params.rho,
            min_bandwidth=params.min_bandwidth)
        mu = mu_flat.reshape(K, M)
        proc_q = proc_q_flat.reshape(K, M)
    else:
        proc = torch.clamp_min(state.lat_buf - rtt[..., None], 0.0)
        proc_q = kde_mod.masked_quantile(proc, win, params.rho)
        mu = kde_mod.empirical_success_prob(state.lat_buf, win, params.tau)

    # --- best expected processing latency l^{p*} (line 8 / Alg 3 line 1) ---
    any_obs = win.sum((-1, -2)) > 0
    l_p_star = torch.where(any_obs, proc_q.min(-1).values, 0.0)
    l_p_star = torch.where(l_p_star >= _F32_MAX, 0.0, l_p_star)

    # --- feasible set F_k(t) (line 9) ---
    not_cd = t >= state.cooldown_until
    act = lane_rows(state.active, K)
    feasible = (rtt + l_p_star[:, None] <= params.tau) & not_cd & act
    n_samples = win.sum(-1)
    unseen_mu = params.unseen_mu if params.unseen_mu >= 0 else params.rho - 1e-6
    mu = torch.where(n_samples > 0, mu, unseen_mu)
    if params.ucb_coef > 0.0:                       # beyond-paper option
        total = torch.clamp_min(n_samples.sum(-1, keepdim=True).to(_F32), 1.0)
        bonus = params.ucb_coef * torch.sqrt(
            torch.log(total) / torch.clamp_min(n_samples.to(_F32), 1.0))
        mu = torch.clamp(mu + torch.where(n_samples > 0, bonus, 0.0), 0.0, 1.0)

    # --- pools (lines 13-19) ---
    exploit = feasible & (mu >= params.rho)
    explore = feasible & (mu < params.rho)
    in_pool = exploit | explore

    # --- budgets & scores (lines 20-22) ---
    eps = state.eps
    # the reference's compiler folds the two constants of ``(mu - rho)
    # + eta`` into one, ``mu + (eta - rho)``, rounded in float32
    s_e = torch.where(exploit, mu + _folded(-params.rho, params.eta), 0.0)
    s_x = torch.where(explore, mu + params.eta, 0.0)
    # the arms' sums in the reference compiler's order, both at once
    sum_e, sum_x = _xla_row_sum(torch.stack([s_e, s_x]))[..., None]
    has_e = sum_e[..., 0] > 0
    has_x = sum_x[..., 0] > 0
    w_e_budget = torch.where(has_x, 1.0 - eps, 1.0) * has_e
    w_x_budget = torch.where(has_e, eps, 1.0) * has_x
    w = s_e / torch.clamp_min(sum_e, 1e-30) * w_e_budget[:, None] \
        + s_x / torch.clamp_min(sum_x, 1e-30) * w_x_budget[:, None]
    # fallback: nothing feasible => uniform over active (keep traffic flowing)
    none = ~(has_e | has_x)
    uni = act.to(_F32)
    uni = uni / torch.clamp_min(uni.sum(-1, keepdim=True), 1.0)
    weights = torch.where(none[:, None], uni, w)

    if params.weight_ema > 0.0:     # beyond-paper damping
        mixed = (1.0 - params.weight_ema) * weights \
            + params.weight_ema * state.weights
        mixed = torch.where(in_pool | none[:, None], mixed, 0.0)
        msum = mixed.sum(-1, keepdim=True)
        weights = torch.where(msum > 0, mixed / torch.clamp_min(msum, 1e-30),
                              weights)

    # --- exploration schedule (lines 24-29) ---
    cur, prev, ncur, nprev = _rolling_qos(state, t, params.window)
    degraded = (ncur > 0) & (nprev > 0) \
        & (cur < prev - params.reset_hysteresis)
    if params.decay_mode == 0:
        eps_next = eps * (1.0 - params.gamma)
    else:
        eps_next = eps * params.gamma
    eps = torch.where(degraded, 1.0 - params.rho, eps_next)

    # keep SWRR state bounded & consistent with the new pool
    cw = torch.where(in_pool | none[:, None], state.cw, 0.0)

    if lb_mask is not None:
        keep = ~lb_mask
        mu = torch.where(keep[:, None], state.mu_hat, mu)
        weights = torch.where(keep[:, None], state.weights, weights)
        cw = torch.where(keep[:, None], state.cw, cw)
        eps = torch.where(keep, state.eps, eps)
        in_pool = torch.where(keep[:, None], state.in_pool, in_pool)
        explore = torch.where(keep[:, None], state.explore, explore)

    return state._replace(mu_hat=mu, weights=weights, cw=cw, eps=eps,
                          in_pool=in_pool, explore=explore)


def maintenance_subset(state: BanditState, params: BanditParams,
                       rtt: torch.Tensor, t,
                       player_idx: torch.Tensor) -> BanditState:
    """Alg 1 for a fixed-size subset of players; everyone else frozen.

    Gather -> ``maintenance`` -> scatter commits exactly what
    ``maintenance(..., lb_mask)`` would for the same players.
    ``player_idx`` entries must be unique; padding uses ``K``, as in
    the reference, which drops those rows with a ``mode="drop"``
    scatter. Torch has no such mode, so the scatter writes padding rows
    into one scratch row past the end, which is cut off again: no host
    sync filters them. With lanes the subset may take players of every
    lane, each against its own lane's liveness row.
    """
    K = state.lat_buf.shape[0]
    idx = player_idx.to(torch.int64)
    safe = torch.clamp_max(idx, K - 1)
    # one lane: the (M,) row is shared; lanes: each gathered player's own
    active = (state.active if state.active.dim() == 1
              else lane_rows(state.active, K)[safe])
    sub = state._replace(
        lat_buf=state.lat_buf[safe], ts_buf=state.ts_buf[safe],
        ptr=state.ptr[safe], mu_hat=state.mu_hat[safe],
        weights=state.weights[safe], cw=state.cw[safe], eps=state.eps[safe],
        err=state.err[safe], cooldown_until=state.cooldown_until[safe],
        in_pool=state.in_pool[safe], explore=state.explore[safe],
        r_buf=state.r_buf[safe], rts_buf=state.rts_buf[safe],
        rptr=state.rptr[safe], active=active)
    out = maintenance(sub, params, rtt[safe], t)

    tgt = torch.clamp_max(idx, K)              # padding -> scratch row K

    def put(field: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        padded = torch.cat((field, field[:1]))
        return padded.index_copy(0, tgt, rows)[:K]

    return state._replace(
        mu_hat=put(state.mu_hat, out.mu_hat),
        weights=put(state.weights, out.weights),
        cw=put(state.cw, out.cw),
        eps=put(state.eps, out.eps),
        in_pool=put(state.in_pool, out.in_pool),
        explore=put(state.explore, out.explore),
    )


# ---------------------------------------------------------------------------
# Placement events (Alg 3 / Alg 4).
# ---------------------------------------------------------------------------

def _onehot(m, M: int, device) -> torch.Tensor:
    return torch.arange(M, device=device) == torch.as_tensor(m, device=device)


def _arm(state: BanditState, m, lane) -> torch.Tensor:
    """The one-hot of arm ``m`` against ``state.active``: (M,), or with
    lanes (S, M), set in ``lane``'s row only."""
    M = state.lat_buf.shape[1]
    onehot = _onehot(m, M, state.weights.device)
    if state.active.dim() == 1:
        return onehot
    if lane is None:
        raise ValueError("a lane-batched state needs the event's lane")
    rows = torch.arange(state.active.shape[0], device=onehot.device)
    return (rows == lane)[:, None] & onehot[None, :]


def keep_lanes(moved: torch.Tensor, new, old):
    """A lane-batched strategy state that takes ``new`` in the lanes
    where ``moved`` (S,) and ``old`` in the others, so a lane an event
    does not touch stays bit for bit as it was. Every tensor, in nested
    states too, has a leading lane axis (S) or player axis (S·K) and is
    selected row by row."""
    S = moved.shape[0]
    if isinstance(new, tuple):
        return type(new)(*(keep_lanes(moved, a, b) for a, b in zip(new, old)))
    rows = moved if new.shape[0] == S else \
        moved.repeat_interleave(new.shape[0] // S)
    return torch.where(rows.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)


def instance_added(state: BanditState, params: BanditParams, m_new,
                   rtt: torch.Tensor, t, lane: int | None = None) -> BanditState:
    """Alg 3: activate arm; join pools lazily with weight 0. With lanes,
    ``lane`` names the lane whose instance came up."""
    K = state.lat_buf.shape[0]
    onehot = _arm(state, m_new, lane)
    row = lane_rows(onehot, K)
    ring = row[..., None]
    return state._replace(
        active=state.active | onehot,
        lat_buf=torch.where(ring, 0.0, state.lat_buf),
        ts_buf=torch.where(ring, NEG_INF, state.ts_buf),
        ptr=torch.where(row, 0, state.ptr).to(_I32),
        err=torch.where(row, 0, state.err).to(_I32),
        cooldown_until=torch.where(row, NEG_INF, state.cooldown_until),
        weights=torch.where(row, 0.0, state.weights),
        mu_hat=torch.where(row, params.rho - 1e-6, state.mu_hat),
    )


def sync_active(state: BanditState, params: BanditParams,
                new_active: torch.Tensor) -> BanditState:
    """Vectorized Alg 3 + Alg 4 against a target liveness vector: arms
    turning off are purged and weights renormalized, arms turning on
    are reset with weight 0 and optimistic mu. With lanes ((S, M)
    ``new_active``) only the lanes whose liveness changed move."""
    K = state.lat_buf.shape[0]
    added = new_active & ~state.active
    removed = state.active & ~new_active
    add_r, rem_r = lane_rows(added, K), lane_rows(removed, K)
    changed = add_r | rem_r
    w = torch.where(rem_r, 0.0, state.weights)
    wsum = _xla_row_sum(w)[:, None]
    unif = lane_rows(new_active, K).to(_F32)
    unif = unif / torch.clamp_min(unif.sum(-1, keepdim=True), 1.0)
    weights = torch.where(wsum > 0, w / torch.clamp_min(wsum, 1e-30), unif)
    weights = torch.where(add_r, 0.0, weights)
    out = state._replace(
        active=new_active,
        in_pool=state.in_pool & ~rem_r,
        explore=state.explore & ~rem_r,
        weights=weights,
        cw=torch.where(changed, 0.0, state.cw),
        lat_buf=torch.where(changed[..., None], 0.0, state.lat_buf),
        ts_buf=torch.where(changed[..., None], NEG_INF, state.ts_buf),
        ptr=torch.where(changed, 0, state.ptr).to(_I32),
        err=torch.where(changed, 0, state.err).to(_I32),
        cooldown_until=torch.where(changed, NEG_INF, state.cooldown_until),
        mu_hat=torch.where(add_r, params.rho - 1e-6, state.mu_hat),
    )
    if new_active.dim() == 1:
        return out
    return keep_lanes((added | removed).any(-1), out, state)


def instance_removed(state: BanditState, m_rem,
                     lane: int | None = None) -> BanditState:
    """Alg 4: purge local data for the arm; renormalize weights. With
    lanes, ``lane`` names the lane whose instance went down."""
    K = state.lat_buf.shape[0]
    onehot = _arm(state, m_rem, lane)
    row = lane_rows(onehot, K)
    ring = row[..., None]
    w = torch.where(row, 0.0, state.weights)
    wsum = _xla_row_sum(w)[:, None]
    unif = lane_rows(state.active & ~onehot, K).to(_F32)
    unif = unif / torch.clamp_min(unif.sum(-1, keepdim=True), 1.0)
    weights = torch.where(wsum > 0, w / torch.clamp_min(wsum, 1e-30), unif)
    out = state._replace(
        active=state.active & ~onehot,
        in_pool=state.in_pool & ~row,
        explore=state.explore & ~row,
        weights=weights,
        cw=torch.where(row, 0.0, state.cw),
        lat_buf=torch.where(ring, 0.0, state.lat_buf),
        ts_buf=torch.where(ring, NEG_INF, state.ts_buf),
        ptr=torch.where(row, 0, state.ptr).to(_I32),
        err=torch.where(row, 0, state.err).to(_I32),
        cooldown_until=torch.where(row, NEG_INF, state.cooldown_until),
    )
    if onehot.dim() == 1:
        return out
    return keep_lanes(onehot.any(-1), out, state)
