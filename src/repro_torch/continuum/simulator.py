"""Discrete-time CC simulator (paper §VII testbed) on the card.

Port of ``repro/continuum/simulator.py``: strategies ``qedgeproxy``,
``proxy_mity`` (any alpha) and ``dec_sarsa``, drivers as compiled, one
service or several, the fused round or the round scan, streaming
metrics (``run_sim_stream``) or full trajectories (``run_sim``), one
simulation or S of them as lanes of one run (``run_sim_batch``,
``run_sim_grid``), chunked horizons with checkpoint and resume, and
the players and the lanes split over ranks (``run_sim_players``,
``run_sim_grid(mesh=)``). The
instance model and the step are the reference's: every step of ``dt``
issues up to ``max_clients`` rounds of requests per load balancer; a
request that finds q requests queued at instance m sees ``rtt + (q +
1) * s_m * Z`` with ``Z ~ LogNormal(0, proc_sigma^2)``; queues drain
``dt / (C * s_m)`` per round. Staggered Alg-1 maintenance runs for ~K
/ maint_every players per step.

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

**Request lifecycle** (``attempt_timeout > 0``): each round makes up to
1 + ``max_retries`` attempts per request. A timed-out attempt is
observed as a censored latency (``core.bandit.censored_latency``), its
instance keeps the work, and the retry re-routes over the current
weights (``core.bandit.retry_pick``) after a backoff charged against
the request's deadline; ``breaker_threshold`` opens per-(player, arm)
circuit breakers. Every attempt's keys and noise are drawn before the
round loop, and resilience runs the round scan, as in the reference.

**Control plane** (``control=ControlConfig(...)``, streaming only): the
``continuum.control`` state rides in the carry; at step start it turns
the drivers into the effective liveness, admitted client slots and
service row that everything downstream sees (the fused round kernel
included), at step end it observes the fleet's QoS. An autoscaler's
liveness is device data, so with ``managed`` standby instances the
placement events run every step, masked to the lanes whose effective
liveness moved.

**Flight recorder** (``recorder=obs.RecorderConfig(...)``, streaming
only): ``obs.recorder.record_step`` appends the step's events (scenario
marks, control actions, breaker trips and resets, retry exhaustions,
sheds, QoS-miss spikes) to a fixed ring in the carry, one ring a lane,
without a host sync; ``StreamOutputs.rec`` returns it.

**Tenants** (``tenancy=continuum.tenancy.TenancyConfig(...)`` with two
or more tenants, streaming only): NT services share the fleet, each
with its own bandit fleet, deadline and client schedule; the queues are
shared (``_tenant_lane_parts``). The tenant step is the round scan; the
fused round kernel is single-service.

**Lanes.** ``jax.vmap`` over the reference's run becomes a leading lane
axis carried through the step: S simulations (each its own base RTT,
drivers and key) advance together, one launch of each kernel a step for
all of them. The players of every lane are the rows of one strategy
state, lane s owning rows [s·K, (s+1)·K); queues, liveness, service
and drain rows are (S, M); every reduction over players or instances
stays within a lane, and a lane computes exactly what it computes
alone. A single run is the one-lane case.

**Player sharding** (``PlayerSharding``; ``run_sim_players`` on a
``launch.mesh.make_continuum_mesh``): the reference's ``shard_map``
over the ``players`` axis becomes D ranks of ``torch.distributed``,
each running the program on its K/D players (global ids ``pids``; every
draw is keyed by global id, so the shards draw what the whole run
draws). The one cross-player coupling, the shared (M,) queues, takes
one all-reduce SUM of the round's (S, M) arrivals before the drain
(retries and tenants fold into the same one); the control plane sums
its step observation, Dec-SARSA takes its lane RTT maximum as an
all-reduce MAX, and the recorder writes fleet events on the shard
holding player 0 only. The fused round kernel is off (a collective
cannot sit inside it: the reference's rule), so a sharded step runs the
round scan. After the run every rank assembles the full-K outputs:
per-player fields concatenated (an all-reduce SUM of zero-filled
full-size buffers, each rank writing its slice), the fleet fields and
series summed, the recorder rings side by side. Arrivals are whole
numbers in float32, so their sums are exact in any order; the regret
series is the one sum reassociated.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.continuum import control as qc
from repro_torch.continuum import metrics as qm
from repro_torch.continuum import scenarios as qs
from repro_torch.continuum import tenancy as qt
from repro_torch.continuum.metrics import StepSeries, StreamOutputs
from repro_torch.continuum.scenarios import Drivers
from repro_torch.core import bandit as qb
from repro_torch.core import baselines as bl
from repro_torch.core import fmath, prand
from repro_torch.core.kde import normal_cdf
from repro_torch.core.oracle import step_regret
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ref import _xla_row_sum, lane_of, lane_rows
from repro_torch.launch.mesh import MeshAxis, tree_map
from repro_torch.obs import recorder as obr
from repro_torch.sharding import logical_to_spec
from repro_torch.sharding.collectives import all_reduce


@dataclass(frozen=True)
class SimConfig:
    """Every field of the reference ``SimConfig``.

    Request lifecycle (off by default): an attempt past
    ``attempt_timeout`` seconds is abandoned by the client and observed
    as a censored latency; with ``max_retries`` > 0 it is retried on a
    re-selected instance after ``retry_backoff * 2^(a-1)`` seconds, as
    long as the elapsed budget stays inside tau (``retry_deadline=False``
    drops that guard: the naive policy); ``breaker_threshold``
    consecutive timeouts on one (player, arm) open a breaker for
    ``breaker_cooldown`` seconds. ``control`` takes a
    ``continuum.control.ControlConfig``, ``recorder`` an
    ``obs.recorder.RecorderConfig`` (streaming only), ``tenancy`` a
    ``continuum.tenancy.TenancyConfig`` (two or more tenants: the
    multi-tenant engine, streaming only)."""
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
        return qt.tenancy_enabled(self)

    @property
    def resilience_on(self) -> bool:
        return self.attempt_timeout > 0.0

    @property
    def control_on(self) -> bool:
        return qc.control_enabled(self)

    @property
    def recorder_on(self) -> bool:
        return obr.recorder_enabled(self)


class PlayerSharding(NamedTuple):
    """Split the (K,) player axis over ``shards`` ranks: ``group`` is
    the players axis' process group (``launch.mesh.Mesh.axis``) and
    ``index`` this rank's place on it, which owns the global players
    [index·K/shards, (index+1)·K/shards). ``build_sim_players_fn`` and
    ``build_sim_grid_fn`` make it; a run given one takes the full
    inputs on every rank and returns the full-K outputs."""
    group: object
    shards: int
    index: int = 0

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce(x, self.group, "sum")

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce(x, self.group, "max")


def _check_main_path(cfg: SimConfig) -> None:
    """Raise for a degenerate tenancy config that disagrees with the
    single-service knobs it runs on."""
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


def _local_width(K: int, pshard, trace: bool = False) -> int:
    """This shard's player count; the reference's errors for a
    sharding that cannot split ``K`` or a trace-mode run."""
    if pshard is None or pshard.shards == 1:
        return K
    if trace:
        raise ValueError(
            "player sharding is streaming-only: trajectories are "
            "O(T*K*...) — the memory the sharding exists to split")
    if K % pshard.shards:
        raise ValueError(
            f"K={K} players must be a multiple of the {pshard.shards}-way "
            f"'players' axis of the mesh (pad K or reshape the mesh)")
    return K // pshard.shards


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
    attempts: torch.Tensor     # (T, K, C) attempts per request (1 + retries)
    dropped: torch.Tensor      # (T, K, C) deadline exhausted without completing


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
# reference's ``select`` makes from that round's key. ``record``,
# ``record_feedback`` and ``fused_round`` also take the step's
# ``t_plus``, which rounds a deadline ``t + c`` as the reference does.
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

    # ``t_plus`` rounds a tripped arm's deadline ``t + cooldown`` as the
    # reference's compiler does (one FMA of t_idx * dt + cooldown)
    def record(state, choice, lat, t, mask, t_plus):
        return qb.record(state, params, choice, lat, t, mask,
                         t_plus(params.cooldown))

    def maintain(state, rtt, t, lb_mask=None):
        return qb.maintenance(state, params, rtt, t, lb_mask)

    def maintain_subset(state, rtt, t, player_idx):
        return qb.maintenance_subset(state, params, rtt, t, player_idx)

    def record_feedback(state, choice, lat, t, mask, t_plus):
        return qb.record_feedback(state, params, choice, lat, t, mask,
                                  t_plus(params.cooldown))

    def record_rings(state, choices, lats, t, mask):
        return qb.record_rings_batch(state, params, choices, lats, t, mask)

    def on_activity(state, new_active, rtt, t, moved):
        return qb.sync_active(state, params, new_active)  # moves ``moved``

    def weights(state):
        return state.weights

    def eps(state):
        return state.eps

    def fused_round(state, q, nc, act, t, t_plus, rtt_t, s_m, served,
                    k_step, pids):
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
            cooldown=params.cooldown, cooldown_at=t_plus(params.cooldown))
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

    def fused_round(state, q, nc, act, t, t_plus, rtt_t, s_m, served,
                    k_step, pids):
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
    def init(rtt, active, key, pids):
        # the proximity-normalized Q divides by each lane's RTT maximum,
        # over the shards a MAX: the baseline's one cross-player reduction
        lanes = active.shape[0]
        lane_max = rtt.reshape(lanes, -1).amax(-1)
        if pshard is not None:
            lane_max = pshard.max(lane_max)
        rtt_max = lane_rows(lane_max[:, None], K)
        return DSState(bl.decsarsa_init(K, M, rtt, params, rtt_max), active,
                       torch.zeros(K, dtype=torch.int32, device=rtt.device))

    def draw(keys, pids):
        return bl.decsarsa_draws(keys, M, pids)   # (S, C, K), (S, C, K, M)

    def select(state, drawn, t, active, pids):
        choice, s = bl.decsarsa_choose(state.inner, params, active, *drawn)
        return choice, state._replace(pend_s=s, active=active)

    def record(state, choice, lat, t, mask, t_plus):
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
        return fmath.fma(e, uni, (1 - e) * greedy)

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


def _lane_groups(k_phase, K_glob: int, pids, S: int,
                 n_phases: int) -> torch.Tensor:
    """(n_phases, S·width) stagger table of S lanes from (S, 2) keys,
    for the K players ``pids`` (a contiguous block) of a K_glob-player
    fleet: each lane's table, its players numbered across the lanes
    (lane s's local player k is s·K + k), the sentinel S·K. Unsharded
    the width is ceil(K/n_phases); a shard touches at most
    ceil(K/n_phases) + 1 blocks (one straddled at each edge), the
    reference's width."""
    K = pids.shape[0]
    n_blocks = -(-K_glob // n_phases)
    width = (n_blocks if K == K_glob
             else min(n_blocks, -(-K // n_phases) + 1))
    lo = 0 if K == K_glob else int(pids[0])
    g = _stagger_groups(k_phase, K_glob, n_phases, width, lo, K).long()
    lane = torch.arange(S, device=k_phase.device)[:, None, None]
    g = torch.where(g < K, g + lane * K, S * K)
    return g.transpose(0, 1).reshape(n_phases, S * width).to(torch.int32)


def _t_plus(t_idx: int, dt32):
    """``t_plus(c)``: ``t + c`` at step ``t_idx`` as the reference's
    compiler rounds it, one FMA of ``t_idx * dt + c``."""
    def t_plus(c: float) -> float:
        return float(np.float32(np.float64(np.float32(t_idx))
                                * np.float64(dt32)
                                + np.float64(np.float32(c))))
    return t_plus


def _row(drawn, r: int):
    """Round ``r``'s row of a ``draw`` result (a tensor, a tuple, None)."""
    if drawn is None:
        return None
    if isinstance(drawn, tuple):
        return tuple(x[r] for x in drawn)
    return drawn[r]


def _by_attempt(drawn):
    """Lane-major retry draws (S, C, A-1, K, ...) as (C, A-1, S·K, ...)."""
    S, C, A1, K = drawn.shape[:4]
    return drawn.permute(1, 2, 0, 3, *range(4, drawn.dim())).reshape(
        C, A1, S * K, *drawn.shape[4:])


def _sum_shards(x: torch.Tensor, pshard) -> torch.Tensor:
    """``x`` summed over the player shards (the identity unsharded)."""
    return x if pshard is None else pshard.sum(x)


def _shard_pids(K: int, pshard, device) -> torch.Tensor:
    """(K,) int32 global ids of this shard's K players: its contiguous
    block of the fleet."""
    lo = 0 if pshard is None else pshard.index * K
    return torch.arange(lo, lo + K, dtype=torch.int32, device=device)


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
    axis; the breaker (S·K, M) and the control carry in the lane layout
    of ``continuum.control``. A tenant config dispatches to
    ``_tenant_lane_parts``.

    With ``pshard`` the halves are one shard's program: K stays the
    global count, every (K,) axis below is this shard's K/shards
    players, ``init_fn``'s ``pids`` are their global ids (by default
    the shard's contiguous block), and the accumulator's fleet fields
    and the series hold this shard's share (``_build_lanes_fn`` sums
    them once after the run)."""
    _check_main_path(cfg)
    if cfg.tenancy_on:
        return _tenant_lane_parts(strategy_name, cfg, K, M, S, fused, trace,
                                  warmup_steps, pshard, **strategy_kw)
    K_glob = K
    K = _local_width(K, pshard, trace)
    res_on = cfg.attempt_timeout > 0.0
    if not res_on and (cfg.max_retries or cfg.breaker_threshold):
        raise ValueError(
            "max_retries/breaker_threshold need attempt_timeout > 0: "
            "the per-attempt timeout is the failure signal both "
            "mechanisms respond to")
    brk_on = res_on and cfg.breaker_threshold > 0
    ctl_on = qc.control_enabled(cfg)
    ccfg = cfg.control
    if ctl_on and trace:
        raise ValueError(
            "the control plane is streaming-only: closed-loop runs are "
            "fleet-scale by construction (set trace=False)")
    rcfg = cfg.recorder
    rec_on = obr.recorder_enabled(cfg)
    if rec_on and trace:
        raise ValueError(
            "the flight recorder is streaming-only: trace=True already "
            "materializes full trajectories (set trace=False)")
    # an autoscaler's liveness is device data: placement events then run
    # every step, masked on the card, instead of from host flags
    managed = ctl_on and ccfg.managed > 0
    A = 1 + (cfg.max_retries if res_on else 0)
    censor = (qb.censored_latency(cfg.attempt_timeout, cfg.tau)
              if res_on else 0.0)
    T, C, SK = cfg.num_steps, cfg.max_clients, S * K
    strat = make_strategy(strategy_name, cfg, SK, M, pshard=pshard,
                          **strategy_kw)
    batched_record = fused and "record_rings" in strat
    subset_maint = fused and "maintain_subset" in strat
    # the round kernel holds all C rounds, so player sharding, which
    # sums each round's arrivals over the shards, runs the round scan
    fused_round_on = (cfg.fused_round and batched_record and not res_on
                      and pshard is None and "fused_round" in strat)
    feed = strat["record_feedback"] if batched_record else strat["record"]
    n_phases = max(cfg.maint_every, 1)
    ev_pre_steps = max(1, int(round(cfg.ev_pre / cfg.dt)))
    ev_bucket_steps = max(1, int(round(cfg.ev_bucket / cfg.dt)))
    dt32 = np.float32(cfg.dt)

    def init_fn(rtt, active0, key, pids=None):
        dev = rtt.device
        if pids is None:
            pids = _shard_pids(K, pshard, dev)
        k_init, k_phase, k_scan = prand.split(key, 3).unbind(-2)
        s0 = strat["init"](rtt.reshape(SK, M), active0, k_init, pids)
        q0 = torch.zeros(S, M, dtype=torch.float32, device=dev)
        groups = _lane_groups(k_phase, K_glob, pids, S, n_phases)
        acc = None if trace else qm.init_accumulator(
            K, M, C, n_marks=qs.MAX_MARKS, ev_buckets=cfg.ev_buckets,
            device=dev, lanes=S)
        brk = qb.breaker_init(SK, M, device=dev) if brk_on else None
        ctl = (qc.control_init(ccfg, SK, M, lanes=S, device=dev)
               if ctl_on else None)
        # one ring a lane, each the ring of its run alone
        rec = (obr.recorder_init(rcfg, K, M, brk_on, lanes=S, device=dev)
               if rec_on else None)
        keys = prand.split(k_scan, T)
        return (s0, q0, active0, acc, groups, pids, brk, ctl, rec), keys

    def round_scan(state, q, act, t, t_plus, rtt_t, s_m, served, k_step, pids,
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
            state = feed(state, choice, lat, t, mask, t_plus)
            arr_r = torch.zeros(S * M, dtype=torch.float32,
                                device=dev).index_add_(
                0, lane * M + choice, mask.to(torch.float32)).reshape(S, M)
            # every shard's requests of the round land on the shared
            # queues; ``arrivals`` keeps this shard's share
            q = torch.clamp_min(q + _sum_shards(arr_r, pshard) - served, 0.0)
            arrivals = arrivals + arr_r          # integer-valued: order-free
            ch_r.append(choice)
            lat_r.append(lat)
            proc_r.append(proc)
        choices = torch.stack(ch_r, dim=1).to(torch.int32)
        lats, procs = torch.stack(lat_r, dim=1), torch.stack(proc_r, dim=1)
        if batched_record:
            state = strat["record_rings"](state, choices, lats, t, mask_all)
        return state, q, arrivals, choices, lats, procs

    def resilient_scan(state, q, act, t, t_plus, rtt_t, s_m, served, k_step,
                       pids, mask_all, brk):
        """The C rounds with 1 + R attempts each: the breaker's veto,
        censored observations, retries re-routed and backed off inside
        the deadline, every attempt's arrivals on its round's queues.
        Every key is drawn before the loop: round r's veto key is
        ``fold_in(k_r, 101)``, attempt a's ``split(fold_in(k_r, 1000 +
        a))`` (pick, noise), with ``k_r = fold_in(k_step, r)``."""
        dev = q.device
        k_r = prand.fold_in(k_step[..., None, :],
                            torch.arange(C, device=dev))       # (S, C, 2)
        ks = prand.split(k_r)
        z = _noise(cfg, ks[..., 1, :], pids)
        drawn = _by_round(strat["draw"](ks[..., 0, :], pids))
        g_veto = (_by_round(prand.player_gumbel(prand.fold_in(k_r, 101),
                                                pids, M)) if brk_on else None)
        if A > 1:
            k_a = prand.split(prand.fold_in(
                k_r[..., None, :], 1000 + torch.arange(1, A, device=dev)))
            g_retry = _by_attempt(prand.player_gumbel(k_a[..., 0, :], pids,
                                                      M))
            z_retry = _by_attempt(fmath.exp(
                cfg.proc_sigma * prand.player_normal(k_a[..., 1, :], pids)))
        open_at = t_plus(cfg.breaker_cooldown)
        kidx = torch.arange(SK, device=dev)
        lane = lane_of(SK, S, dev)
        timeout = cfg.attempt_timeout

        def attempt(choice, z_a):
            q1s = (q[lane, choice] + 1.0) * s_m[lane, choice]
            return q1s * z_a, fmath.fma(q1s, z_a, rtt_t[kidx, choice])

        def arrive(m, choice):
            return torch.zeros(S * M, dtype=torch.float32,
                               device=dev).index_add_(
                0, lane * M + choice, m.to(torch.float32)).reshape(S, M)

        arrivals = torch.zeros(S, M, dtype=torch.float32, device=dev)
        rows = [[] for _ in range(8)]
        for r in range(C):
            mask = mask_all[:, r]
            choice, state = strat["select"](state, _row(drawn, r), t, act,
                                            pids)
            choice = choice.to(torch.int64)
            if brk_on:
                # the bandit's pick stands unless its breaker is open
                choice = qb.breaker_veto(choice, brk, t,
                                         strat["weights"](state), act,
                                         g_veto[r], mask)
            proc, lat = attempt(choice, z[r])
            timed_out = mask & (lat > timeout)
            obs = torch.where(timed_out, censor, lat)
            # a censored sample clips the processing sketch at the timeout
            proc_f = torch.where(timed_out, torch.clamp_max(proc, timeout),
                                 proc)
            elapsed = torch.where(mask, torch.clamp_max(lat, timeout), 0.0)
            if brk_on:
                brk = qb.breaker_update(brk, choice, timed_out, mask, t,
                                        cfg.breaker_threshold,
                                        cfg.breaker_cooldown, open_at)
            state = feed(state, choice, obs, t, mask, t_plus)
            arr = arrive(mask, choice)
            att_ch, att_obs, att_m = [choice], [obs], [mask]
            completed = mask & ~timed_out
            choice_f, pending = choice, timed_out
            for a in range(1, A):
                p = pending
                backoff = cfg.retry_backoff * (2.0 ** (a - 1))
                if cfg.retry_deadline:
                    # no retry that cannot finish inside the deadline
                    p = p & (elapsed + backoff < cfg.tau)
                open_now = qb.breaker_is_open(brk, t) if brk_on else None
                alt = qb.retry_pick(strat["weights"](state), act, choice_f,
                                    open_now, g_retry[r, a - 1])
                choice_a = torch.where(p, alt, choice_f)
                proc_a, lat_a = attempt(choice_a, z_retry[r, a - 1])
                to_a = p & (lat_a > timeout)
                obs_a = torch.where(to_a, censor, lat_a)
                elapsed = torch.where(
                    p, elapsed + backoff + torch.clamp_max(lat_a, timeout),
                    elapsed)
                if brk_on:
                    brk = qb.breaker_update(brk, choice_a, to_a, p, t,
                                            cfg.breaker_threshold,
                                            cfg.breaker_cooldown, open_at)
                state = feed(state, choice_a, obs_a, t, p, t_plus)
                arr = arr + arrive(p, choice_a)
                att_ch.append(choice_a)
                att_obs.append(obs_a)
                att_m.append(p)
                choice_f = torch.where(p, choice_a, choice_f)
                proc_f = torch.where(
                    to_a, torch.clamp_max(proc_a, timeout),
                    torch.where(p, proc_a, proc_f))
                completed = completed | (p & ~to_a)
                pending = to_a
            # the client's latency: the elapsed budget when the request
            # completed, the censor sentinel (> tau) when it dropped
            lat_out = torch.where(completed, elapsed, censor)
            att_n = sum(m.to(torch.int32) for m in att_m)
            # one sum over the shards a round, the retries folded in
            q = torch.clamp_min(q + _sum_shards(arr, pshard) - served, 0.0)
            arrivals = arrivals + arr            # integer-valued: order-free
            for buf, y in zip(rows, (choice_f, lat_out, proc_f, att_n,
                                     mask & ~completed, torch.stack(att_ch),
                                     torch.stack(att_obs),
                                     torch.stack(att_m))):
                buf.append(y)
        chf, lat, proc, att, drop, ach, aobs, am = (torch.stack(b)
                                                    for b in rows)
        if batched_record:
            # all C·A attempts in the step's one ring scatter, round-major
            # and attempt-minor
            def cols(x):
                return x.permute(2, 0, 1).reshape(SK, C * A)
            state = strat["record_rings"](state, cols(ach), cols(aobs), t,
                                          cols(am))
        return (state, q, arrivals, chf.T.to(torch.int32),
                lat.T.contiguous(), proc.T.contiguous(), att.T.contiguous(),
                drop.T.contiguous(), brk)

    def step_fn(rtt, marks, carry, xs, changed):
        state, q, prev_active, acc, groups, pids, brk, ctl, rec = carry
        t_idx, nc, act, rtt_scale, cut_k, cut_m, s_m, k_step, group = xs
        dev = rtt.device
        t_host = float(np.float32(t_idx) * dt32)
        t = torch.full((), t_host, dtype=torch.float32, device=dev)
        nc = nc.reshape(SK)
        t_plus = _t_plus(t_idx, dt32)

        # control plane: the effective drivers for everything downstream;
        # ``nc`` becomes the admitted slots, ``nc_sched`` the demand
        if ctl_on:
            nc_sched = nc
            cnt_pre = ctl.counters
            ctl, act, nc, s_m, _ = qc.control_actuate(
                ccfg, cfg.dt, t_host, ctl, q, act, nc, s_m,
                1.0 if t_idx >= warmup_steps else 0.0, t_plus)
            # the step's control actions for the recorder: the (S,)
            # counter increments (already warm-up gated)
            ctl_deltas = tuple(
                getattr(ctl.counters, f) - getattr(cnt_pre, f)
                for f in ("scale_up", "scale_down", "migrations")
            ) if rec_on else None

        # effective RTT and service rows for this step, the players of
        # every lane as rows
        rtt_t = (rtt * rtt_scale[:, None, :] + torch.minimum(
            cut_k[:, :, None], cut_m[:, None, :])).reshape(SK, M)

        # placement events (paper Alg 3/4): each strategy moves only the
        # lanes whose liveness changed, flagged on the host per lane, or
        # on the card every step under an autoscaler; liveness flips
        # also clear the arms' breakers
        if managed or changed.any():
            moved = ((act != prev_active).any(-1) if managed
                     else torch.as_tensor(changed, device=dev))
            state = strat["on_activity"](state, act, rtt_t, t, moved)
            if brk_on:
                brk = qb.breaker_reset_arms(brk, act != prev_active)

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
        mask_adm = torch.arange(C, device=dev)[None, :] < nc[:, None]
        mask_all = (torch.arange(C, device=dev)[None, :] < nc_sched[:, None]
                    if ctl_on else mask_adm)
        served_per_round = torch.full_like(s_m, cfg.dt) / (C * s_m)
        brk_open = None

        if res_on:
            if brk_on:
                brk_open = qb.breaker_is_open(brk, t).reshape(S, K, M)
            (state, q, arrivals, choices, lats, procs, att_kc, dropped,
             brk) = resilient_scan(state, q, act, t, t_plus, rtt_t, s_m,
                                   served_per_round, k_step, pids, mask_adm,
                                   brk)
        else:
            if fused_round_on:
                state, q, arrivals, choices, lats, procs = \
                    strat["fused_round"](state, q, nc, act, t_host, t_plus,
                                         rtt_t, s_m, served_per_round,
                                         k_step, pids)
            else:
                state, q, arrivals, choices, lats, procs = round_scan(
                    state, q, act, t, t_plus, rtt_t, s_m, served_per_round,
                    k_step, pids, mask_adm)
            att_kc = mask_adm.to(torch.int32)
            dropped = torch.zeros_like(mask_all)
        # retry exhaustions for the recorder, before the admission sheds
        # join ``dropped`` (sheds are a kind of their own)
        retry_drop_k = (dropped.to(torch.float32).sum(-1).reshape(S, K)
                        if rec_on and res_on else None)
        served_kc = shed_k = None
        if ctl_on and ccfg.admit:
            # admission-shed slots: issued misses from the client's view,
            # never served: censored to inf, dropped with no attempt, out
            # of the routing and latency statistics
            shed_kc = mask_all & ~mask_adm
            lats = torch.where(shed_kc, torch.inf, lats)
            dropped = dropped | shed_kc
            served_kc = mask_adm.reshape(S, K, C)
            if rec_on:
                shed_k = shed_kc.to(torch.float32).sum(-1).reshape(S, K)
        att_kc = att_kc.reshape(S, K, C)
        dropped = dropped.reshape(S, K, C)
        rewards = (lats <= cfg.tau).to(torch.float32).reshape(S, K, C)
        mask_kc = mask_all.reshape(S, K, C)
        choices, lats = choices.reshape(S, K, C), lats.reshape(S, K, C)
        procs = procs.reshape(S, K, C)
        reg = reg.reshape(S, K)
        issf = mask_kc.to(torch.float32)
        if trace:
            ys = SimOutputs(
                rewards=rewards, issued=mask_kc, choices=choices,
                latency=lats, proc_lat=procs, arrivals=arrivals,
                queue=q_start, weights=w_now.reshape(S, K, M),
                true_mu=mu_true.reshape(S, K, M), regret=reg,
                eps=strat["eps"](state).reshape(S, K), attempts=att_kc,
                dropped=dropped)
        else:
            acc = qm.update_accumulator(
                acc, rewards=rewards, issued=mask_kc, choices=choices,
                procs=procs, arrivals=arrivals, regret=reg,
                mu=mu_true.reshape(S, K, M), t_idx=t_idx,
                warmup_steps=warmup_steps, marks=marks,
                ev_pre_steps=ev_pre_steps, ev_bucket_steps=ev_bucket_steps,
                attempts=att_kc, dropped=dropped, brk_open=brk_open,
                served=served_kc)
            ys = StepSeries(succ=(rewards * issf).sum((1, 2)),
                            issued=issf.sum((1, 2)), regret=_xla_row_sum(reg),
                            attempts=att_kc.to(torch.float32).sum((1, 2)))
        if ctl_on:
            # step-end feedback: the fleet's QoS and timeout totals
            attf = att_kc.to(torch.float32)
            compl = issf * (1.0 - dropped.to(torch.float32))
            obs = torch.stack([(rewards * issf).sum((1, 2)), issf.sum((1, 2)),
                               (attf - compl).sum((1, 2)), attf.sum((1, 2))],
                              -1)
            # the whole fleet's, so the replicated controller agrees
            ctl = qc.control_observe(ccfg, ctl, _sum_shards(obs, pshard),
                                     cfg.dt)
        if rec_on:
            # the step's events, from what the step computed; every
            # lane appends to its own ring
            rec = obr.record_step(
                rcfg, rec, t_idx=t_idx, pids=pids, marks=marks,
                miss_k=((1.0 - rewards) * issf).sum(-1), iss_k=issf.sum(-1),
                retry_drop_k=retry_drop_k, shed_k=shed_k,
                open_now=(qb.breaker_is_open(brk, t).reshape(S, K, M)
                          if brk_on else None),
                ctl_deltas=ctl_deltas if ctl_on else None)
        return (state, q, act, acc, groups, pids, brk, ctl, rec), ys

    return init_fn, step_fn


# PRNG salt separating tenant round-key folds from every other fold off
# the round key: tenant s's draws are a pure function of (step key,
# round, tenant, player id), whatever the tenant count.
_TENANT_SALT = 7001


def _interference(other, xi: float):
    """``1 + xi * other`` as the reference's compiler rounds it: one
    FMA."""
    return fmath.fma(other, xi, 1.0)


def _backlog_work(b, s_eff):
    """(S, M) seconds of work outstanding, ``sum_i b[:, i] * s_eff[:,
    i]`` over the tenants as the reference's compiler sums it: an FMA
    chain, ``fma(b_3, s_3, fma(b_2, s_2, fma(b_1, s_1, b_0 * s_0)))``."""
    work = b[:, 0] * s_eff[:, 0]
    for i in range(1, b.shape[1]):
        work = fmath.fma(b[:, i], s_eff[:, i], work)
    return work


def _tenant_lane_parts(strategy_name: str, cfg: SimConfig, K: int, M: int,
                       S: int, fused: bool, trace: bool, warmup_steps: int,
                       pshard=None, **strategy_kw):
    """The multi-tenant engine: NT services on one shared fleet, S lanes
    of it. The reference's ``_build_tenant_parts`` in the lane layout.

    The same ``(init_fn, step_fn)`` contract and 9-slot carry as
    ``_lane_parts``: the strategy-state and accumulator slots hold
    NT-tuples (tenant i's bandit fleet over the S·K players of every
    lane, built with tau = taus[i]; its lane-batched accumulator), the
    queue is the shared (S, NT, M) per-tenant backlog, and ``ys`` is a
    ``StepSeries`` of (S, NT) rows; the breaker, control and recorder
    slots stay None. ``xs``'s ``n_clients`` is (S, NT, K).

    A request's position in line is the TOTAL backlog (a sum over
    tenants) at its instance; its service time is the tenant's
    effective row (``tenancy.TenancyConfig``: demand scale times the
    interference of the backlog other tenants hold); each round's drain
    is work-conserving processor sharing: the round's ``dt / C`` seconds
    retire the same fraction ``min(1, (dt / C) / work)`` of every
    tenant's backlog, ``work`` the seconds outstanding. Round r of
    tenant i draws from ``fold_in(fold_in(k_step, r), _TENANT_SALT +
    i)``, split into the selection and noise keys; every round's draws
    are made before the loop. The C rounds run as a scan (the fused
    round kernel is single-service and never launches here); with
    ``fused`` the rings are written once a step and maintenance runs
    on the due players, one maintenance launch per tenant a step for
    all lanes. Under ``pshard`` (one shard's program, as in
    ``_lane_parts``) the round's (S, NT, M) arrivals are summed over the
    shards in one all-reduce before the drain."""
    tn = cfg.tenancy
    NT = tn.S
    if trace:
        raise ValueError(
            "the multi-tenant engine is streaming-only: per-tenant "
            "trajectories are O(S*T*K*...) (set trace=False)")
    if cfg.resilience_on or cfg.max_retries or cfg.breaker_threshold:
        raise ValueError(
            "tenancy does not compose with the resilience layer yet: "
            "run multi-tenant configs with attempt_timeout=0, "
            "max_retries=0, breaker_threshold=0")
    if qc.control_enabled(cfg):
        raise ValueError(
            "tenancy does not compose with the control plane yet: "
            "run multi-tenant configs with control=None")
    if obr.recorder_enabled(cfg):
        raise ValueError(
            "tenancy does not compose with the flight recorder yet: "
            "run multi-tenant configs with recorder=None")
    if "params" in strategy_kw:
        raise ValueError(
            "explicit params= would share one tau across tenants; "
            "per-tenant params are derived from TenancyConfig.taus")
    K_glob = K
    K = _local_width(K, pshard)
    T, C, SK = cfg.num_steps, cfg.max_clients, S * K
    taus = tuple(float(x) for x in tn.taus)
    xi = float(tn.interference)
    strats = tuple(make_strategy(strategy_name,
                                 dataclasses.replace(cfg, tau=taus[i]), SK, M,
                                 pshard=pshard, **strategy_kw)
                   for i in range(NT))
    batched_record = fused and "record_rings" in strats[0]
    subset_maint = fused and "maintain_subset" in strats[0]
    feeds = tuple(st["record_feedback"] if batched_record else st["record"]
                  for st in strats)
    n_phases = max(cfg.maint_every, 1)
    ev_pre_steps = max(1, int(round(cfg.ev_pre / cfg.dt)))
    ev_bucket_steps = max(1, int(round(cfg.ev_bucket / cfg.dt)))
    dt32 = np.float32(cfg.dt)

    def total(q):
        """(S, M) backlog summed over tenants, in tenant order."""
        out = q[:, 0]
        for i in range(1, NT):
            out = out + q[:, i]
        return out

    @functools.cache
    def scales(device):
        # (1, NT, 1), uploaded once per device: no copy in the step
        return torch.tensor(tn.scales, dtype=torch.float32,
                            device=device)[None, :, None]

    def eff_service(q, q_tot, s_m):
        """(S, NT, M) effective service rows at the (S, NT, M) backlog:
        the tenant's demand scale, times ``1 + xi * other`` with
        ``other`` the share of the backlog other tenants hold (one FMA,
        as the reference's compiler rounds it)."""
        base = s_m[:, None, :] * scales(q.device)
        if xi == 0.0:
            return base
        other = (q_tot[:, None, :] - q) / (1.0 + q_tot[:, None, :])
        return base * _interference(other, xi)

    def init_fn(rtt, active0, key, pids=None):
        dev = rtt.device
        if pids is None:
            pids = _shard_pids(K, pshard, dev)
        k_init, k_phase, k_scan = prand.split(key, 3).unbind(-2)
        s0 = tuple(strats[i]["init"](rtt.reshape(SK, M), active0,
                                     prand.fold_in(k_init, i), pids)
                   for i in range(NT))
        q0 = torch.zeros(S, NT, M, dtype=torch.float32, device=dev)
        accs = tuple(qm.init_accumulator(
            K, M, C, n_marks=qs.MAX_MARKS, ev_buckets=cfg.ev_buckets,
            device=dev, lanes=S) for _ in range(NT))
        keys = prand.split(k_scan, T)
        groups = _lane_groups(k_phase, K_glob, pids, S, n_phases)
        return (s0, q0, active0, accs, groups, pids, None, None, None), keys

    def step_fn(rtt, marks, carry, xs, changed):
        states, q, prev_active, accs, groups, pids, _b, _c, _r = carry
        t_idx, nc, act, rtt_scale, cut_k, cut_m, s_m, k_step, group = xs
        dev = rtt.device
        t_host = float(np.float32(t_idx) * dt32)
        t = torch.full((), t_host, dtype=torch.float32, device=dev)
        t_plus = _t_plus(t_idx, dt32)
        rtt_t = (rtt * rtt_scale[:, None, :] + torch.minimum(
            cut_k[:, :, None], cut_m[:, None, :])).reshape(SK, M)

        # placement events, in every tenant's fleet, for the lanes whose
        # liveness changed
        if changed.any():
            moved = torch.as_tensor(changed, device=dev)
            states = tuple(strats[i]["on_activity"](states[i], act, rtt_t, t,
                                                    moved)
                           for i in range(NT))
        if subset_maint:
            states = tuple(strats[i]["maintain_subset"](states[i], rtt_t, t,
                                                        group)
                           for i in range(NT))
        else:
            lb_mask = torch.zeros(SK + 1, dtype=torch.bool, device=dev)
            lb_mask[group.to(torch.int64)] = True       # sentinel SK: dropped
            states = tuple(strats[i]["maintain"](states[i], rtt_t, t,
                                                 lb_mask[:SK])
                           for i in range(NT))

        # the oracle and regret per tenant at step start, against the
        # total backlog and the tenant's effective row
        q_tot = total(q)
        s_eff = eff_service(q, q_tot, s_m)
        q_rows = lane_rows(q_tot, SK)
        mu = tuple(_true_mu_tau(rtt_t, q_rows, taus[i], cfg.proc_sigma,
                                lane_rows(s_eff[:, i], SK))
                   for i in range(NT))
        reg = tuple(step_regret(strats[i]["weights"](states[i]), mu[i], act)
                    for i in range(NT))
        cols = torch.arange(C, device=dev)[None, :]
        masks = tuple(cols < nc[:, i].reshape(SK)[:, None]
                      for i in range(NT))

        # every round's keys and draws, tenant-minor: row r·NT + i
        k_r = prand.fold_in(k_step[..., None, :], torch.arange(C, device=dev))
        k_t = prand.fold_in(k_r[..., None, :],
                            _TENANT_SALT + torch.arange(NT, device=dev))
        ks = prand.split(k_t).reshape(S, C * NT, 2, 2)
        z = _noise(cfg, ks[..., 1, :], pids)                # (C·NT, S·K)
        drawn = _by_round(strats[0]["draw"](ks[..., 0, :], pids))
        kidx = torch.arange(SK, device=dev)
        lane = lane_of(SK, S, dev)
        arrivals = torch.zeros(S, NT, M, dtype=torch.float32, device=dev)
        rows = [([], [], []) for _ in range(NT)]
        states = list(states)
        drain = torch.full((S, M), cfg.dt / C, dtype=torch.float32,
                           device=dev)
        for r in range(C):
            if r:
                q_tot = total(q)
                s_eff = eff_service(q, q_tot, s_m)
            arr = torch.zeros(S * NT * M, dtype=torch.float32, device=dev)
            for i in range(NT):
                row = r * NT + i
                choice, st = strats[i]["select"](states[i], _row(drawn, row),
                                                 t, act, pids)
                # position in line is the TOTAL backlog; only the
                # service time is the tenant's
                q1s = (q_tot[lane, choice] + 1.0) * s_eff[lane, i, choice]
                proc = q1s * z[row]
                lat = fmath.fma(q1s, z[row], rtt_t[kidx, choice])
                mask = masks[i][:, r]
                states[i] = feeds[i](st, choice, lat, t, mask, t_plus)
                arr.index_add_(0, (lane * NT + i) * M + choice,
                               mask.to(torch.float32))
                for buf, y in zip(rows[i], (choice, lat, proc)):
                    buf.append(y)
            arr = arr.reshape(S, NT, M)
            # processor sharing: the round's dt/C seconds retire the same
            # fraction of every tenant's backlog; one sum over the
            # shards carries every tenant's arrivals
            b = q + _sum_shards(arr, pshard)
            f = torch.clamp_max(
                drain / torch.clamp_min(_backlog_work(b, s_eff), 1e-9), 1.0)
            q = b * (1.0 - f[:, None, :])
            arrivals = arrivals + arr            # integer-valued: order-free

        new_accs, succ, iss, regs = [], [], [], []
        for i in range(NT):
            ch, lat, proc = (torch.stack(x, dim=1) for x in rows[i])
            ch = ch.to(torch.int32)
            if batched_record:
                states[i] = strats[i]["record_rings"](states[i], ch, lat, t,
                                                      masks[i])
            rewards = (lat <= taus[i]).to(torch.float32).reshape(S, K, C)
            issued = masks[i].reshape(S, K, C)
            issf = issued.to(torch.float32)
            r_k = reg[i].reshape(S, K)
            new_accs.append(qm.update_accumulator(
                accs[i], rewards=rewards, issued=issued,
                choices=ch.reshape(S, K, C), procs=proc.reshape(S, K, C),
                arrivals=arrivals[:, i], regret=r_k,
                mu=mu[i].reshape(S, K, M), t_idx=t_idx,
                warmup_steps=warmup_steps, marks=marks,
                ev_pre_steps=ev_pre_steps, ev_bucket_steps=ev_bucket_steps,
                attempts=issued.to(torch.int32),
                dropped=torch.zeros_like(issued), brk_open=None,
                served=None))
            succ.append((rewards * issf).sum((1, 2)))
            iss.append(issf.sum((1, 2)))
            regs.append(r_k.sum(-1))
        # one value per tenant: the series come out (S, T, NT)
        ys = StepSeries(succ=torch.stack(succ, -1),
                        issued=torch.stack(iss, -1),
                        regret=torch.stack(regs, -1),
                        attempts=torch.stack(iss, -1))
        return (tuple(states), q, act, tuple(new_accs), groups, pids, None,
                None, None), ys

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
    recorder)`` in the reference's layout; ``acc`` is None in trace
    mode, ``breaker`` unless breakers are on, ``control`` unless a
    control mechanism is, and ``recorder`` unless ``cfg.recorder`` is
    on (an ``obs.recorder.RecorderState``).
    """
    init1, step1 = _lane_parts(strategy_name, cfg, K, M, 1, fused, trace,
                               warmup_steps, pshard, **strategy_kw)

    def one(x):
        return qm.each(x, lambda v: type(v)(*(a[None] for a in v)))

    def first(x):
        return qm.each(x, lambda v: type(v)(*(a[0] for a in v)))

    def to_lanes(carry):
        state, q, prev, acc, groups, pids, brk, ctl, rec = carry
        return (qm.each(state,
                        lambda st: _with_active(st, lambda a: a[None])),
                q[None], prev[None], one(acc), groups, pids, brk,
                None if ctl is None else qc.with_lane_axis(ctl), one(rec))

    def from_lanes(carry):
        state, q, prev, acc, groups, pids, brk, ctl, rec = carry
        return (qm.each(state,
                        lambda st: _with_active(st, lambda a: a[0])),
                q[0], prev[0], first(acc), groups, pids, brk,
                None if ctl is None else qc.without_lane_axis(ctl),
                first(rec))

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
    lanes; outputs with a leading (S,) axis. Under ``pshard`` every
    rank passes the full inputs, runs its shard's players and returns
    the full-K outputs (``_assemble_players``)."""
    T = cfg.num_steps
    init_fn, step_fn = _lane_parts(
        strategy_name, cfg, K, M, S, fused=fused, trace=trace,
        warmup_steps=warmup_steps, pshard=pshard, **strategy_kw)

    def run(rtts, drivers: Drivers, keys, service_time=None, pids=None):
        dev = rtts.device
        drivers = _lane_drivers(drivers, S)
        _check_tenant_drivers(cfg, drivers.n_clients, 4)
        if pshard is not None:
            rtts, drivers = _player_slice(rtts, drivers, K // pshard.shards,
                                          pshard.index)
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
        out = StreamOutputs(acc=carry[3], series=StepSeries(*host),
                            ctrl=_lane_counters(carry[7], S), rec=carry[8])
        return out if pshard is None else _assemble_players(out, pshard)

    return run


def _player_slice(rtts, drivers: Drivers, K: int, index: int):
    """Shard ``index``'s K players of lane-batched inputs: the rows of
    ``rtts`` (S, K·D, M) and the player axis (last) of ``n_clients`` and
    ``rtt_cut_k``."""
    sl = slice(index * K, (index + 1) * K)
    return rtts[:, sl], drivers._replace(
        n_clients=drivers.n_clients[..., sl],
        rtt_cut_k=drivers.rtt_cut_k[..., sl])


def _concat(x: torch.Tensor, axis: int, group, size: int,
            index: int) -> torch.Tensor:
    """The ranks' ``x`` side by side along ``axis``, on every rank of
    ``group``: a zero-filled full-size buffer that each rank writes its
    slice of, summed over the group (x + 0 is x)."""
    n = x.shape[axis]
    if n == 0:
        return x
    y = x.to(torch.int32) if x.dtype == torch.bool else x
    shape = list(y.shape)
    shape[axis] = n * size
    full = y.new_zeros(shape)
    full.narrow(axis, index * n, n).copy_(y)
    return all_reduce(full, group).to(x.dtype)


# Per-player accumulator fields (concatenated over the player shards)
# and fleet fields (summed); steps_measured is the same on every shard.
_PLAYER_FIELDS = ("succ_kc", "n_kc", "choice_counts", "regret_k", "vb_k",
                  "prev_mu", "att_k", "timeout_k", "drop_k", "open_km")
_FLEET_FIELDS = ("arrivals_m", "proc_hist", "ev_succ", "ev_n")


def _assemble_players(out: StreamOutputs, pshard) -> StreamOutputs:
    """One shard's lane-batched ``StreamOutputs`` as the whole fleet's,
    on every rank, laid out as the reference's ``_stream_specs`` (the
    player axis is axis 1 behind the lanes): per-player fields and the
    control plane's ``shed_k`` concatenated to full K, the fleet fields
    and the series summed, the recorder's rings side by side ((S,
    D·cap) with (S, D) pointers, which ``obs.recorder_events`` splits)."""
    def cat(x):
        return _concat(x, 1, pshard.group, pshard.shards, pshard.index)

    def acc_of(a):
        return a._replace(**{f: cat(getattr(a, f)) for f in _PLAYER_FIELDS},
                          **{f: pshard.sum(getattr(a, f))
                             for f in _FLEET_FIELDS})

    return StreamOutputs(
        acc=qm.each(out.acc, acc_of),
        series=StepSeries(*(pshard.sum(y) for y in out.series)),
        ctrl=(None if out.ctrl is None
              else out.ctrl._replace(shed_k=cat(out.ctrl.shed_k))),
        rec=tree_map(cat, out.rec))


def _check_tenant_drivers(cfg: SimConfig, n_clients, dims: int) -> None:
    """A tenant run's ``n_clients`` must carry the tenant axis before K
    (``dims`` axes in all, lanes included)."""
    NT = qt.tenancy_size(cfg)
    if NT and (n_clients.dim() != dims or n_clients.shape[-2] != NT):
        raise ValueError(
            f"multi-tenant run needs a (T, S={NT}, K) n_clients schedule "
            f"(got {tuple(n_clients.shape)}): compile with "
            "scenarios.compile_tenant_scenario / tenant_neutral_drivers / "
            "broadcast_tenants")


def _lane_counters(ctl, S: int):
    """A lane-batched control carry's counters with every field's
    leading axis the lanes (``shed_k`` (S, K)), for ``metrics.lane``."""
    if ctl is None:
        return None
    cnt = ctl.counters
    return cnt._replace(shed_k=cnt.shed_k.reshape(S, -1))


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
    case of the lane-batched run. With ``pshard`` (streaming only) it is
    one rank's part of a player-sharded run: every rank of the players
    group calls it with the full inputs and gets the full-K outputs, the
    recorder's rings side by side ((D·cap,) with a (D,) ``ptr``)."""
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
    drv = qs.neutral_drivers(cfg, K, M, n_clients=n_clients, active=active,
                             device=device)
    if cfg.tenancy_on:
        # schedules built here serve every tenant; drivers passed in must
        # carry the tenant axis already (the run checks)
        drv = qs.broadcast_tenants(drv, cfg.tenancy.S)
    return drv


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


def _split_axis(mesh, logical: str) -> str | None:
    """The mesh axis that the partitioning rules split the logical
    ``grid`` (lanes) or ``players`` axis over (``sharding
    .logical_to_spec``), None where they split it over none."""
    spec = dict(zip(("grid", "players"),
                    logical_to_spec(("grid", "players"), mesh)))
    name = spec[logical]
    if isinstance(name, tuple):
        raise ValueError(f"the {logical!r} rule splits over {name}: the "
                         "simulator splits a logical axis over one mesh axis")
    return name


def _split_size(mesh, logical: str) -> int:
    name = _split_axis(mesh, logical)
    return 1 if name is None else mesh.axis_size(name)


def _mesh_axis(mesh, logical: str) -> MeshAxis:
    """This rank's place on the mesh axis that splits ``logical`` (an
    axis of one where none does); makes the mesh's groups on first
    use."""
    name = _split_axis(mesh, logical)
    return MeshAxis(None, 1, 0) if name is None else mesh.axis(name)


def _mesh_sharding(mesh) -> PlayerSharding | None:
    """This rank's ``PlayerSharding`` on ``mesh`` (None where the
    players split over no axis of more than one rank): the one place a
    1-way split becomes the plain program."""
    ax = _mesh_axis(mesh, "players")
    return None if ax.size == 1 else PlayerSharding(ax.group, ax.size,
                                                    ax.index)


def build_sim_grid_fn(strategy_name: str, cfg: SimConfig, K: int, M: int,
                      mesh=None, warmup_steps: int = 0, fused: bool = True,
                      **strategy_kw):
    """``(run_grid, mesh)``: ``run_grid(rtts, drivers, keys)`` streams S
    lanes (``rtts`` (S, K, M), ``drivers`` an (S, ·) batch or shared,
    ``keys`` (S, 2)) and returns ``StreamOutputs`` with a leading (S,)
    axis on every rank.

    ``mesh`` (default ``launch.mesh.make_grid_mesh()``, every rank on
    ``data``) spreads the lanes over the axis that the partitioning
    rules give the logical ``grid`` axis (``data``), each rank running
    its S/D lanes; a 2-D (``data``, ``players``) mesh also splits every
    lane's players over the ``players`` rule's axis (``players``,
    ``PlayerSharding``). A rule that splits nothing leaves that axis'
    ranks running the same lanes whole.
    Lanes that do not fill the data axis are padded with copies of the
    last lane, sliced off the outputs. A mesh of one rank runs the plain
    lanes. Lanes are independent, so each equals its run alone: the
    counts exactly, and the floats too but the regret series, which a
    players axis reassociates."""
    from repro_torch.launch.mesh import make_grid_mesh

    mesh = make_grid_mesh() if mesh is None else mesh
    _local_width(K, PlayerSharding(None, _split_size(mesh, "players")))

    def lanes(S, pshard):
        return _build_lanes_fn(strategy_name, cfg, K, M, S, fused, False,
                               warmup_steps, pshard, **strategy_kw)

    def run_grid(rtts, drivers: Drivers, keys):
        S = rtts.shape[0]
        if mesh.size() == 1:
            return lanes(S, None)(rtts, drivers, keys)
        pshard = _mesh_sharding(mesh)
        dax = _mesh_axis(mesh, "grid")
        drivers = _lane_drivers(drivers, S)
        pad = (-S) % dax.size
        if pad:
            def padded(x):
                return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
            rtts, keys = padded(rtts), padded(keys)
            drivers = Drivers(*(padded(x) for x in drivers))
        n = (S + pad) // dax.size
        mine = slice(dax.index * n, (dax.index + 1) * n)
        out = lanes(n, pshard)(rtts[mine],
                               Drivers(*(x[mine] for x in drivers)),
                               keys[mine])
        if dax.size > 1:
            out = tree_map(lambda x: _concat(x, 0, dax.group, dax.size,
                                             dax.index), out)
        return tree_map(lambda x: x[:S], out) if pad else out

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
    bit; each step launches each kernel once for all lanes. ``mesh``
    spreads the lanes over ranks (``build_sim_grid_fn``); every rank
    calls this with the same inputs and gets every lane."""
    dev, rtts, keys = _lane_inputs(rtts, keys, device)
    S, K, M = rtts.shape
    drv = _resolve_drivers(cfg, K, M, drivers, n_clients, active, dev)
    run_grid, _ = build_sim_grid_fn(strategy_name, cfg, K, M, mesh=mesh,
                                    warmup_steps=warmup_steps, **strategy_kw)
    return run_grid(rtts, drv, keys)


def build_sim_players_fn(strategy_name: str, cfg: SimConfig, K: int, M: int,
                         mesh=None, warmup_steps: int = 0, fused: bool = True,
                         **strategy_kw):
    """``(run, mesh)``: ``run(rtt, drivers, key)`` is one streaming
    simulation whose K players split over the mesh axis that the
    partitioning rules give the logical ``players`` axis (``players``)
    of ``mesh`` (default ``launch.mesh.make_continuum_mesh()``, every
    rank on it). Each rank holds K/D players' bandit state and runs their
    selection, feedback and maintenance; one all-reduce of the round's
    (M,) arrivals keeps the shared queues equal on every rank. Every
    rank calls ``run`` with the full inputs and gets the full-K
    ``StreamOutputs``, equal to the unsharded run: the counts exactly,
    the per-player floats exactly, the summed regret series to float32
    reassociation. A players axis of one gives the plain streaming
    program."""
    from repro_torch.launch.mesh import make_continuum_mesh

    mesh = make_continuum_mesh() if mesh is None else mesh
    _local_width(K, PlayerSharding(None, _split_size(mesh, "players")))

    def run(rtt, drivers: Drivers, key):
        return build_sim_fn(strategy_name, cfg, K, M, fused=fused,
                            trace=False, warmup_steps=warmup_steps,
                            pshard=_mesh_sharding(mesh), **strategy_kw)(
            rtt, drivers, key)

    return run, mesh


def run_sim_players(
    strategy_name: str,
    rtt,                          # (K, M) base LB->instance RTT [s]
    cfg: SimConfig,
    key,                          # (2,) key tensor, or an integer seed
    n_clients: torch.Tensor | None = None,   # (T, K)
    active: torch.Tensor | None = None,      # (T, M)
    drivers: Drivers | None = None,
    warmup_steps: int = 0,
    mesh=None,
    device=None,
    **strategy_kw,
) -> StreamOutputs:
    """Player-sharded streaming run: ``run_sim_stream``'s semantics, the
    K load balancers of one simulation split over the ranks of
    ``mesh``'s players axis (``build_sim_players_fn``). The giant-fleet
    mode: the K·M·R bandit state splits D ways. Every rank calls it
    with the same inputs; a 1-way players axis is the plain program."""
    dev, rtt, key = _inputs(rtt, key, device)
    K, M = rtt.shape
    drv = _resolve_drivers(cfg, K, M, drivers, n_clients, active, dev)
    run, _ = build_sim_players_fn(strategy_name, cfg, K, M, mesh=mesh,
                                  warmup_steps=warmup_steps, **strategy_kw)
    return run(rtt, drv, key)


def build_sim_chunks(strategy_name: str, cfg: SimConfig, K: int, M: int,
                     fused: bool = True, warmup_steps: int = 0,
                     **strategy_kw):
    """Chunked-horizon streaming: ``(init_fn, chunk_fn)``.

    ``init_fn`` is ``build_sim_parts``'s. ``chunk_fn(rtt, carry, t_idx,
    drivers, keys, service_time=None) -> (carry, StepSeries)`` runs the
    steps ``t_idx`` (global indices, a range or a tensor) on
    ``drivers``, a ``scenarios.slice_drivers`` slice over them, and
    ``keys``, the same slice of ``init_fn``'s per-step keys; the series
    are device tensors of the chunk's length. Chunks in order equal the
    whole horizon's run bit for bit: a chunk's first placement flag is
    read from the carry (one host read a chunk)."""
    init_fn, step_fn = build_sim_parts(
        strategy_name, cfg, K, M, fused=fused, trace=False,
        warmup_steps=warmup_steps, **strategy_kw)
    n_phases = max(cfg.maint_every, 1)

    def chunk_fn(rtt, carry, t_idx, drivers: Drivers, keys,
                 service_time=None):
        _check_tenant_drivers(cfg, drivers.n_clients, 3)
        if service_time is not None:
            drivers = drivers._replace(
                s_m=torch.full_like(drivers.s_m, service_time))
        steps = [int(i) for i in t_idx]
        a = drivers.active.cpu().numpy()
        prev = np.concatenate([carry[2].cpu().numpy()[None], a[:-1]])
        changed = (a != prev).any(-1)
        rows = []
        for i, ti in enumerate(steps):
            xs = (ti, *(getattr(drivers, f)[i] for f in qs.STEP_FIELDS),
                  keys[i], carry[4][ti % n_phases])
            carry, ys = step_fn(rtt, drivers.marks, carry, xs,
                                bool(changed[i]))
            rows.append(ys)
        return carry, StepSeries(*(torch.stack(c) for c in zip(*rows)))

    return init_fn, chunk_fn


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
    key) or an integer seed. ``ctrl`` of the result holds the control
    counters when ``cfg.control`` is on, ``rec`` the flight recorder's
    ring when ``cfg.recorder`` is.

    ``chunk_steps`` drives the horizon in chunks of that many steps
    (``build_sim_chunks``); chunked and unchunked runs follow the same
    steps on the same keys and are equal bit for bit.
    ``checkpoint_dir`` commits the carry and the series drained so far
    every ``checkpoint_every`` chunks (``checkpoint.Checkpointer``:
    snapshot on the caller's thread, written in the background);
    ``resume=True`` restarts from the directory's latest checkpoint (an
    empty directory is a cold start) and equals the uninterrupted run
    exactly. ``stop_at_step`` halts at the first chunk boundary at or
    past that step and returns the partial result. All three need
    ``chunk_steps`` < the horizon.

    ``mesh`` with a players axis of more than one rank routes to
    ``run_sim_players`` (every rank calls this with the same inputs),
    which does not compose with ``chunk_steps``.
    """
    if mesh is not None and _split_size(mesh, "players") > 1:
        if chunk_steps is not None:
            raise ValueError(
                "player sharding and chunk_steps do not compose yet: "
                "the chunked carry holds shard-local maintenance groups")
        return run_sim_players(
            strategy_name, rtt, cfg, key, n_clients=n_clients,
            active=active, drivers=drivers, warmup_steps=warmup_steps,
            mesh=mesh, device=device, **strategy_kw)
    dev, rtt, key = _inputs(rtt, key, device)
    K, M = rtt.shape
    T = cfg.num_steps
    drv = _resolve_drivers(cfg, K, M, drivers, n_clients, active, dev)
    if chunk_steps is None or chunk_steps >= T:
        if checkpoint_dir is not None or stop_at_step is not None:
            raise ValueError(
                "checkpoint_dir/resume/stop_at_step need the chunked "
                "loop: pass chunk_steps < num_steps")
        run = build_sim_fn(strategy_name, cfg, K, M, trace=False,
                           warmup_steps=warmup_steps, **strategy_kw)
        return run(rtt, drv, key)

    init_fn, chunk_fn = build_sim_chunks(
        strategy_name, cfg, K, M, warmup_steps=warmup_steps, **strategy_kw)
    carry, keys = init_fn(rtt, drv.active[0], key)
    ckpt = None
    start = 0
    parts: list = []                 # device series of chunks not drained
    done: StepSeries | None = None   # host series drained so far
    if checkpoint_dir is not None:
        from repro_torch.checkpoint import Checkpointer, config_hash
        ckpt = Checkpointer(checkpoint_dir)
        meta = {"config_hash": config_hash(cfg), "horizon_steps": int(T)}
        if resume and ckpt.latest_step() is not None:
            # the fresh carry is the structure; the series keeps the
            # length it was saved with
            template = {"carry": carry, "series": StepSeries(
                *(np.zeros(0, np.float32) for _ in StepSeries._fields))}
            restored, start = ckpt.restore(template)
            carry, done = restored["carry"], restored["series"]

    def drain() -> StepSeries | None:
        """Fold the pending device chunks into the host series."""
        nonlocal parts, done
        if parts:
            prev = [done] if done is not None else []
            host = [StepSeries(*(x.cpu().numpy() for x in p)) for p in parts]
            done = StepSeries(*(np.concatenate([getattr(p, f)
                                                for p in prev + host])
                                for f in StepSeries._fields))
            parts = []
        return done

    chunks_done = 0
    for lo in range(start, T, chunk_steps):
        if stop_at_step is not None and lo >= stop_at_step:
            break
        hi = min(lo + chunk_steps, T)
        carry, ys = chunk_fn(rtt, carry, range(lo, hi),
                             qs.slice_drivers(drv, lo, hi), keys[lo:hi])
        parts.append(ys)
        chunks_done += 1
        if (ckpt is not None and hi < T
                and chunks_done % checkpoint_every == 0):
            ckpt.save(hi, {"carry": carry, "series": drain()},
                      blocking=False, meta=meta)
    series = drain() or StepSeries(
        *(np.zeros(0, np.float32) for _ in StepSeries._fields))
    if ckpt is not None:
        ckpt.wait()
    series = StepSeries(*(torch.from_numpy(np.ascontiguousarray(x))
                          for x in series))
    ctl = carry[7]
    # the ring rides the chunked carry and the checkpoint: chunked,
    # checkpointed and resumed runs end with the same ring bit for bit
    return StreamOutputs(acc=carry[3], series=series,
                         ctrl=None if ctl is None else ctl.counters,
                         rec=carry[8])
