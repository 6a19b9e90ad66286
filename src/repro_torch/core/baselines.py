"""Baseline routing strategies the paper compares against (§VII-A5).

Port of ``repro/core/baselines.py``:

* ``proxy_mity_weights`` — Fahs & Pierre [3]: static proximity-biased
  weights; alpha=1.0 routes everything to the nearest instance,
  alpha=0.9 keeps 10% spread across the rest, fixed at initialization.
* ``DecSarsa*`` — Mattia & Beraldi [7] adapted per §VII-A5: each LB is
  a differential-SARSA agent; state is a recent-latency bucket, actions
  are instances, reward is the deadline indicator, eps-greedy per
  request.

The reference's quirks are kept as written (see ``decsarsa_update``).
Floats round as XLA:CPU rounds the jitted reference: its compiler
fuses ``0.3 * latency`` into the add of ``0.7 * last_lat`` and
``alpha_r * (reward - rbar)`` into the add of ``rbar``, which
``fmath.fma`` replays; ``q + beta * td`` stays a scatter-add of the
rounded product, as there.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import fmath, prand
from repro_torch.kernels.ref import _row_sum, lane_rows

_F32 = torch.float32


# ---------------------------------------------------------------------------
# proxy-mity
# ---------------------------------------------------------------------------

def proxy_mity_weights(rtt: torch.Tensor, alpha: float,
                       active: torch.Tensor | None = None) -> torch.Tensor:
    """alpha * onehot(nearest active) + (1-alpha) uniform over active.

    The nearest instance is the first minimal RTT (``torch.argmin``
    documents the first index on ties, as ``jnp.argmin`` breaks them).
    ``active`` is (M,), or (S, M) for S lanes of K/S players each."""
    K, M = rtt.shape
    if active is None:
        active = torch.ones(M, dtype=torch.bool, device=rtt.device)
    act = lane_rows(active, K)
    big = torch.finfo(rtt.dtype).max
    masked = torch.where(act, rtt, big)
    nearest = torch.argmin(masked, dim=-1)
    onehot = torch.nn.functional.one_hot(nearest, M).to(rtt.dtype)
    actf = act.to(rtt.dtype)
    uni = actf / torch.clamp_min(actf.sum(-1, keepdim=True), 1.0)
    w = alpha * onehot + (1.0 - alpha) * uni
    return w / torch.clamp_min(_row_sum(w), 1e-30)    # summed left to right


# ---------------------------------------------------------------------------
# Dec-SARSA
# ---------------------------------------------------------------------------

N_LOAD_BUCKETS = 4


class DecSarsaParams(NamedTuple):
    beta: float = 0.1          # Q learning rate
    alpha_r: float = 0.01      # average-reward step (differential SARSA)
    eps: float = 0.10          # eps-greedy exploration
    eps_decay: float = 0.999   # per-request decay
    eps_min: float = 0.01
    tau: float = 0.080
    # latency bucket edges relative to tau (state discretization)
    b1: float = 0.25
    b2: float = 0.6
    b3: float = 1.0


class DecSarsaState(NamedTuple):
    q: torch.Tensor           # (K, S, M) action values
    rbar: torch.Tensor        # (K,) average reward estimate
    prev_s: torch.Tensor      # (K,) i32 previous state id
    prev_a: torch.Tensor      # (K,) i32 previous action
    has_prev: torch.Tensor    # (K,) bool
    last_lat: torch.Tensor    # (K,) recent-latency EMA (state feature)
    eps: torch.Tensor         # (K,) current exploration rate


def decsarsa_init(num_players: int, num_arms: int, rtt: torch.Tensor,
                  params: DecSarsaParams,
                  rtt_max: torch.Tensor | None = None) -> DecSarsaState:
    """Optimistic Q biased by proximity, on ``rtt``'s device. ``rtt_max``
    is the global RTT maximum (the one cross-player term), defaulting to
    ``rtt.max()``; with lanes, a (K, 1) column of each player's lane's
    maximum."""
    K, M = num_players, num_arms
    dev = rtt.device
    if rtt_max is None:
        rtt_max = rtt.max()
    q0 = 0.5 + 0.5 * (1.0 - rtt / torch.clamp_min(rtt_max, 1e-9))
    q = q0[:, None, :].expand(K, N_LOAD_BUCKETS, M).to(_F32).contiguous()
    return DecSarsaState(
        q=q,
        rbar=torch.zeros(K, dtype=_F32, device=dev),
        prev_s=torch.zeros(K, dtype=torch.int32, device=dev),
        prev_a=torch.zeros(K, dtype=torch.int32, device=dev),
        has_prev=torch.zeros(K, dtype=torch.bool, device=dev),
        last_lat=torch.zeros(K, dtype=_F32, device=dev),
        eps=torch.full((K,), params.eps, dtype=_F32, device=dev),
    )


def _bucket(lat: torch.Tensor, p: DecSarsaParams) -> torch.Tensor:
    rel = lat / p.tau
    return ((rel > p.b1).to(torch.int32) + (rel > p.b2).to(torch.int32)
            + (rel > p.b3).to(torch.int32))


def decsarsa_draws(key: torch.Tensor, M: int,
                   pids: torch.Tensor | None = None, K: int | None = None):
    """The exploration draws ``decsarsa_select`` makes from ``key``:
    ``(u (..., K), gumbel (..., K, M))``. Leading key axes batch (one
    row of draws per key), so a step can draw all its rounds at once.
    With ``pids`` the draws are keyed per global player id; without,
    one bulk draw of ``K`` players."""
    sub = prand.split(key)
    ku, kc = sub[..., 0, :], sub[..., 1, :]
    if pids is not None:
        return prand.player_uniform(ku, pids), prand.player_gumbel(kc, pids, M)
    return prand.uniform(ku, (K,)), prand.gumbel(kc, (K, M))


def decsarsa_choose(state: DecSarsaState, params: DecSarsaParams,
                    active: torch.Tensor, u: torch.Tensor,
                    gumbel: torch.Tensor):
    """eps-greedy action per player from given draws; ``active`` is
    (M,), or (S, M) for S lanes. Returns ``(choice (K,) int64, s (K,)
    i32)``."""
    K = state.q.shape[0]
    s = _bucket(state.last_lat, params)
    qs = state.q[torch.arange(K, device=s.device), s.to(torch.int64)]
    neg = torch.finfo(qs.dtype).min
    act = lane_rows(active, K)
    qs = torch.where(act, qs, neg)
    greedy = torch.argmax(qs, dim=-1)
    rand = torch.argmax(torch.where(act, gumbel, neg), dim=-1)
    explore = u < state.eps
    return torch.where(explore, rand, greedy), s


def decsarsa_select(state: DecSarsaState, params: DecSarsaParams,
                    active: torch.Tensor, key: torch.Tensor,
                    pids: torch.Tensor | None = None):
    """eps-greedy action per player from the current state bucket.

    With ``pids`` the exploration draws are keyed per global player id
    (``prand``); without it, one bulk draw. Returns ``(choice, s)``."""
    K, _, M = state.q.shape
    u, gumbel = decsarsa_draws(key, M, pids, K)
    return decsarsa_choose(state, params, active, u, gumbel)


def decsarsa_update(state: DecSarsaState, params: DecSarsaParams,
                    s: torch.Tensor, a: torch.Tensor, reward: torch.Tensor,
                    latency: torch.Tensor,
                    mask: torch.Tensor) -> DecSarsaState:
    """Differential SARSA: Q[s,a] += beta (r - rbar + Q[s',a'] - Q[s,a]).

    As in the reference, the update gate ``mask & has_prev | mask``
    reduces to ``mask``, and the next action is greedy over Q[s'] with
    no liveness mask."""
    K = state.q.shape[0]
    kidx = torch.arange(K, device=s.device)
    s64, a64 = s.to(torch.int64), a.to(torch.int64)
    last_lat = torch.where(
        mask, fmath.fma(0.3, latency, 0.7 * state.last_lat), state.last_lat)
    s_next = _bucket(last_lat, params)
    a_next = torch.argmax(state.q[kidx, s_next.to(torch.int64)], dim=-1)

    q_sa = state.q[kidx, s64, a64]
    q_next = state.q[kidx, s_next.to(torch.int64), a_next]
    td = reward - state.rbar + q_next - q_sa
    upd = torch.where(mask & state.has_prev | mask, params.beta * td, 0.0)
    q = state.q.index_put((kidx, s64, a64), upd, accumulate=True)
    rbar = torch.where(
        mask, fmath.fma(params.alpha_r, reward - state.rbar, state.rbar),
        state.rbar)
    eps = torch.where(
        mask, torch.clamp_min(state.eps * params.eps_decay, params.eps_min),
        state.eps)
    return state._replace(
        q=q, rbar=rbar, prev_s=s_next, prev_a=a_next.to(torch.int32),
        has_prev=state.has_prev | mask, last_lat=last_lat, eps=eps)
