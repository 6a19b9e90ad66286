"""Discrete-time CC simulator (paper §VII testbed), the streaming main path.

Port of the single-service path of ``repro/continuum/simulator.py``:
strategy ``qedgeproxy``, drivers as compiled, unsharded, the fused
round, resilience / control / recorder / tenancy off, streaming
metrics. The instance model and the step are the reference's: every
step of ``dt`` issues up to ``max_clients`` rounds of requests per load
balancer; a request that finds q requests queued at instance m sees
``rtt + (q + 1) * s_m * Z`` with ``Z ~ LogNormal(0, proc_sigma^2)``;
queues drain ``dt / (C * s_m)`` per round. Staggered Alg-1 maintenance
runs for ~K / maint_every players per step.

``lax.scan`` becomes a host loop over steps that never waits on the
card: the per-step placement-event flags come from the drivers on the
host before the loop (in place of ``lax.cond``), the step's time is a
host number, and the ``StepSeries`` scalars go into preallocated
device buffers read once at the end. Per step the card runs the two
CUDA kernels (``kernels.ops.round_step`` for the C rounds,
``kernels.ops.bandit_maintenance_stats`` inside maintenance) and plain
PyTorch ops for the rest.

Features the reference has beyond this path raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.continuum import metrics as qm
from repro_torch.continuum import scenarios as qs
from repro_torch.continuum.metrics import StepSeries, StreamOutputs
from repro_torch.continuum.scenarios import Drivers
from repro_torch.core import bandit as qb
from repro_torch.core import fmath, prand
from repro_torch.core.kde import normal_cdf
from repro_torch.core.oracle import step_regret
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kernel_ops


@dataclass(frozen=True)
class SimConfig:
    """Every field of the reference ``SimConfig``; on this path the
    resilience, control, recorder and tenancy fields must stay neutral
    and ``fused_round`` on."""
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


def _check_main_path(cfg: SimConfig, fused: bool, trace: bool, pshard) -> None:
    """Raise for every setting that leaves the ported main path."""
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
    if not (cfg.fused_round and fused):
        raise _not_ported("the unfused round scan", "A5")
    if trace:
        raise _not_ported("trace mode (SimOutputs trajectories)", "A5")
    if pshard is not None:
        raise _not_ported("player sharding", "A10")


def _true_mu_tau(rtt, q, tau, sigma, service_time):
    """Closed-form P(rtt + (q+1) s Z <= tau), Z ~ LogNormal(0, sigma^2)."""
    margin = (tau - rtt) / ((q[None, :] + 1.0) * service_time)
    safe = torch.clamp_min(margin, 1e-9)
    mu = normal_cdf(fmath.log(safe) / sigma)
    return torch.where(margin > 0, mu, 0.0)


def _true_mu(rtt, q, cfg: SimConfig, service_time):
    return _true_mu_tau(rtt, q, cfg.tau, cfg.proc_sigma, service_time)


# ---------------------------------------------------------------------------
# Strategy adapter: a dict of closures, as in the reference.
# ---------------------------------------------------------------------------

def qedgeproxy_strategy(params: qb.BanditParams, cfg: SimConfig, K: int,
                        M: int):
    """The reference's strategy adapter, cut to the closures the ported
    engine calls (the unfused round scan and the resilience path use
    the others; ROADMAP A5, A9)."""
    def init(rtt, active, key, pids):
        return qb.init_state(K, M, params, cfg.ring, cfg.reward_ring, active,
                             key=key, pids=pids)

    def maintain_subset(state, rtt, t, player_idx):
        return qb.maintenance_subset(state, params, rtt, t, player_idx)

    def on_activity(state, new_active, rtt, t):
        return qb.sync_active(state, params, new_active)

    def weights(state):
        return state.weights

    def fused_round(state, q, nc, act, t, rtt_t, s_m, served, k_step, pids):
        # all C rounds in one kernel call; the per-round noise is drawn
        # up front, each element the draw the reference's round scan
        # makes: a pure function of (step key, round, player id). `t` is
        # the step time as a host number.
        C = cfg.max_clients
        rkeys = prand.fold_in(k_step, torch.arange(C, device=k_step.device))
        ks = prand.split(rkeys)                          # (C, 2, 2)
        z = fmath.exp(cfg.proc_sigma * prand.player_normal(ks[:, 1], pids))
        out = kernel_ops.round_step(
            state.weights, state.cw, state.err, state.cooldown_until,
            state.in_pool, state.active,
            state.lat_buf, state.ts_buf, state.ptr,
            state.r_buf, state.rts_buf, state.rptr,
            q, nc, z, rtt_t, s_m, served, t,
            tau=params.tau, err_thresh=params.err_thresh,
            cooldown=params.cooldown)
        state = state._replace(
            weights=out.weights, cw=out.cw, err=out.err,
            cooldown_until=out.cooldown_until, in_pool=out.in_pool,
            lat_buf=out.lat_buf, ts_buf=out.ts_buf, ptr=out.ptr,
            r_buf=out.r_buf, rts_buf=out.rts_buf, rptr=out.rptr)
        return state, out.q, out.arrivals, out.choices, out.lats, out.procs

    return dict(init=init, maintain_subset=maintain_subset,
                on_activity=on_activity, weights=weights,
                fused_round=fused_round)


def make_strategy(name: str, cfg: SimConfig, K: int, M: int,
                  pshard=None, **kw):
    if name == "qedgeproxy":
        params = kw.get("params") or qb.BanditParams(
            tau=cfg.tau, rho=cfg.rho, window=cfg.window,
            **{k: v for k, v in kw.items() if k in qb.BanditParams._fields})
        return qedgeproxy_strategy(params, cfg, K, M)
    if name.startswith("proxy_mity") or name == "dec_sarsa":
        raise _not_ported(f"strategy {name!r}", "A6")
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
    sentinel ``K_local`` (only in the last, partial block)."""
    dev = k_phase.device
    bids = lo // n_phases + torch.arange(width, device=dev)
    perm = prand.permutation(prand.fold_in(k_phase, bids), n_phases)
    inv = torch.argsort(perm, dim=-1)
    gplayer = bids[:, None] * n_phases + inv
    local = gplayer - lo
    ok = (gplayer < K_global) & (local >= 0) & (local < K_local)
    return torch.where(ok, local, K_local).T.to(torch.int32)


def build_sim_parts(strategy_name: str, cfg: SimConfig, K: int, M: int,
                    fused: bool = True, trace: bool = True,
                    warmup_steps: int = 0, pshard=None, **strategy_kw):
    """The engine's two halves, ``(init_fn, step_fn)``.

    * ``init_fn(rtt, active0, key, pids=None) -> (carry0, keys)``: the
      strategy state, an empty queue and accumulator, the stagger table
      and the (T, 2) per-step keys.
    * ``step_fn(rtt, marks, carry, xs, changed) -> (carry, ys)``: one
      step. ``xs = (t_idx, n_clients_t, active_t, rtt_scale_t,
      rtt_cut_k_t, rtt_cut_m_t, s_m_t, key_t, group_t)`` with ``t_idx``
      a host integer and ``group_t`` the players due for maintenance
      (padded with the sentinel ``K``); ``changed`` is the host flag
      "liveness differs from the previous step" that fires the Alg 3/4
      placement event. ``ys`` is a ``StepSeries`` row of 0-dim tensors.

    The carry is the reference's 9 slots ``(state, queue, prev_active,
    acc, groups, pids, breaker, control, recorder)``; the last three
    are ``None`` on this path.
    """
    _check_main_path(cfg, fused, trace, pshard)
    T, C = cfg.num_steps, cfg.max_clients
    strat = make_strategy(strategy_name, cfg, K, M, **strategy_kw)
    n_phases = max(cfg.maint_every, 1)
    n_blocks = -(-K // n_phases)
    ev_pre_steps = max(1, int(round(cfg.ev_pre / cfg.dt)))
    ev_bucket_steps = max(1, int(round(cfg.ev_bucket / cfg.dt)))
    dt32 = np.float32(cfg.dt)

    def init_fn(rtt, active0, key, pids=None):
        dev = rtt.device
        if pids is None:
            pids = torch.arange(K, dtype=torch.int32, device=dev)
        k_init, k_phase, k_scan = prand.split(key, 3).unbind(0)
        s0 = strat["init"](rtt, active0, k_init, pids)
        q0 = torch.zeros(M, dtype=torch.float32, device=dev)
        groups = _stagger_groups(k_phase, K, n_phases, n_blocks, 0, K)
        acc = qm.init_accumulator(K, M, C, n_marks=qs.MAX_MARKS,
                                  ev_buckets=cfg.ev_buckets, device=dev)
        keys = prand.split(k_scan, T)
        return (s0, q0, active0, acc, groups, pids, None, None, None), keys

    def step_fn(rtt, marks, carry, xs, changed: bool):
        state, q, prev_active, acc, groups, pids, brk, ctl, rec = carry
        t_idx, nc, act, rtt_scale, cut_k, cut_m, s_m, k_step, group = xs
        dev = rtt.device
        t_host = float(np.float32(t_idx) * dt32)
        t = torch.full((), t_host, dtype=torch.float32, device=dev)

        # effective RTT and service row for this step
        rtt_t = rtt * rtt_scale[None, :] + torch.minimum(
            cut_k[:, None], cut_m[None, :])

        # placement events (paper Alg 3/4), flagged on the host
        if changed:
            state = strat["on_activity"](state, act, rtt_t, t)

        # maintenance: only the player group whose clock fires
        state = strat["maintain_subset"](state, rtt_t, t, group)

        mu_true = _true_mu(rtt_t, q, cfg, s_m)       # (K, M) at step start
        reg = step_regret(strat["weights"](state), mu_true, act)
        mask_all = torch.arange(C, device=dev)[None, :] < nc[:, None]
        served_per_round = torch.full_like(s_m, cfg.dt) / (C * s_m)

        state, q, arrivals, choices, lats, procs = strat["fused_round"](
            state, q, nc, act, t_host, rtt_t, s_m, served_per_round,
            k_step, pids)
        att_kc = mask_all.to(torch.int32)
        rewards = (lats <= cfg.tau).to(torch.float32)
        acc = qm.update_accumulator(
            acc, rewards=rewards, issued=mask_all, choices=choices,
            procs=procs, arrivals=arrivals, regret=reg, mu=mu_true,
            t_idx=t_idx, warmup_steps=warmup_steps, marks=marks,
            ev_pre_steps=ev_pre_steps, ev_bucket_steps=ev_bucket_steps,
            attempts=att_kc, dropped=torch.zeros_like(mask_all))
        issf = mask_all.to(torch.float32)
        ys = StepSeries(succ=(rewards * issf).sum(), issued=issf.sum(),
                        regret=reg.sum(),
                        attempts=att_kc.to(torch.float32).sum())
        return (state, q, act, acc, groups, pids, brk, ctl, rec), ys

    return init_fn, step_fn


def _changed_flags(active: torch.Tensor) -> list[bool]:
    """Host flags: does step t's liveness differ from step t-1's (step 0
    compares with itself, as the carry starts at ``active[0]``)."""
    a = active.cpu().numpy()
    prev = np.concatenate([a[:1], a[:-1]])
    return list((a != prev).any(-1))


def build_sim_fn(strategy_name: str, cfg: SimConfig, K: int, M: int,
                 fused: bool = True, trace: bool = True,
                 warmup_steps: int = 0, pshard=None, **strategy_kw):
    """``run(rtt, drivers, key, service_time=None, pids=None) ->
    StreamOutputs`` on the device of ``rtt``; only the streaming mode
    (``trace=False``) is ported."""
    T = cfg.num_steps
    init_fn, step_fn = build_sim_parts(
        strategy_name, cfg, K, M, fused=fused, trace=trace,
        warmup_steps=warmup_steps, pshard=pshard, **strategy_kw)

    def run(rtt, drivers: Drivers, key, service_time=None, pids=None):
        dev = rtt.device
        if service_time is not None:
            drivers = drivers._replace(
                s_m=torch.full_like(drivers.s_m, service_time))
        carry, keys = init_fn(rtt, drivers.active[0], key, pids)
        changed = _changed_flags(drivers.active)
        n_phases = max(cfg.maint_every, 1)
        series = torch.empty(len(StepSeries._fields), T, dtype=torch.float32,
                             device=dev)
        for i in range(T):
            xs = (i, *(getattr(drivers, f)[i] for f in qs.STEP_FIELDS),
                  keys[i], carry[4][i % n_phases])
            carry, ys = step_fn(rtt, drivers.marks, carry, xs, changed[i])
            series[:, i] = torch.stack(ys)
        host = series.cpu()
        return StreamOutputs(acc=carry[3], series=StepSeries(*host.unbind(0)))

    return run


def _resolve_drivers(cfg, K, M, drivers, n_clients, active, device):
    if drivers is not None:
        if n_clients is not None or active is not None:
            raise ValueError("pass either drivers= or n_clients=/active=, "
                             "not both")
        return Drivers(*(x.to(device) for x in drivers))
    return qs.neutral_drivers(cfg, K, M, n_clients=n_clients, active=active,
                              device=device)


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
    key) or an integer seed. Chunked horizons, player meshes and
    checkpointing are not ported yet and raise.
    """
    if chunk_steps is not None and chunk_steps < cfg.num_steps:
        raise _not_ported("chunked horizons (chunk_steps)", "A5")
    if mesh is not None:
        raise _not_ported("player meshes", "A10")
    if checkpoint_dir is not None or resume or stop_at_step is not None:
        raise _not_ported("checkpoint/resume", "A8")
    dev = resolve_device(device)
    if not isinstance(rtt, torch.Tensor):
        rtt = torch.tensor(np.asarray(rtt), dtype=torch.float32)
    rtt = rtt.to(dev, torch.float32)
    key = (prand.prng_key(key, dev) if isinstance(key, int)
           else torch.as_tensor(key, dtype=torch.int64).to(dev))
    K, M = rtt.shape
    drv = _resolve_drivers(cfg, K, M, drivers, n_clients, active, dev)
    run = build_sim_fn(strategy_name, cfg, K, M, trace=False,
                       warmup_steps=warmup_steps, **strategy_kw)
    return run(rtt, drv, key)
