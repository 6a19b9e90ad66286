"""Metrics for the paper's §VII figures and the multi-tenant readouts.

Port of ``repro/continuum/metrics.py``: the simulator's step loop
carries an O(K·M) ``MetricAccumulator`` on the device and fills O(T)
scalar ``StepSeries``; the ``*_stream`` readouts turn them into the Figs 3-9
and regret statistics on the host. The per-instance latency quantile
(Fig. 8) comes from a fixed geometric histogram sketch, as in the
reference. The trace-mode readouts compute the same statistics from
full ``SimOutputs`` trajectories.

Every count here is an integer-valued float32 sum (``index_add_`` in
place of ``segment_sum``), so the order in which CUDA's atomic adds
land cannot change it.

Lanes: a lane-batched run carries one accumulator for S independent
simulations, every field with a leading (S,) axis, and its series are
(S, T); ``lane`` takes one lane's ``StreamOutputs`` out. The event
readouts ``event_windows_from_series`` and ``event_recovery`` read the
recovery windows of one lane. A tenant run carries a tuple of NT
accumulators and (T, NT) series; the ``tenant_*`` readouts and the
fairness indices read them.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

# Geometric bins for the processing-latency sketch: 1e-4 s .. 10 s, 128
# bins (~9.5% spacing).
PROC_HIST_BINS = 128
_PROC_EDGES = np.geomspace(1e-4, 10.0, PROC_HIST_BINS - 1).astype(np.float32)


@functools.cache
def _edges(device: torch.device) -> torch.Tensor:
    # one upload per device, so the step loop never copies from the host
    return torch.from_numpy(_PROC_EDGES).to(device)


class MetricAccumulator(NamedTuple):
    """O(K·M) on-device sufficient statistics for Figs 3-9 + regret.

    Post-warmup fields accumulate once ``t_idx >= warmup_steps``; regret
    and the variation budget cover the whole horizon. ``ev_succ`` /
    ``ev_n`` are the event-relative recovery windows (slot 0 the
    pre-event baseline, slots 1..B consecutive post-event buckets).
    With the request lifecycle off, ``att_k`` equals issued requests
    and timeouts, drops and open breakers stay zero."""
    succ_kc: torch.Tensor        # (K, C) post-warmup QoS successes per client slot
    n_kc: torch.Tensor           # (K, C) post-warmup issued requests per client slot
    arrivals_m: torch.Tensor     # (M,)  post-warmup arrivals per instance
    choice_counts: torch.Tensor  # (K, M) post-warmup issued requests per (LB, instance)
    proc_hist: torch.Tensor      # (M, B) post-warmup processing-latency sketch
    regret_k: torch.Tensor       # (K,)  full-horizon oracle regret partial sum
    vb_k: torch.Tensor           # (K,)  empirical variation budget partial sum
    prev_mu: torch.Tensor        # (K, M) previous step's true mu (variation carry)
    steps_measured: torch.Tensor  # ()   f32 count of post-warmup steps
    ev_succ: torch.Tensor        # (E, 1+B) QoS successes per event window
    ev_n: torch.Tensor           # (E, 1+B) issued requests per event window
    att_k: torch.Tensor          # (K,)  post-warmup attempts (incl. retries)
    timeout_k: torch.Tensor      # (K,)  post-warmup timed-out attempts
    drop_k: torch.Tensor         # (K,)  post-warmup dropped requests
    open_km: torch.Tensor        # (K, M) post-warmup breaker-open step counts


class StepSeries(NamedTuple):
    """Per-step scalar streams (leading axis T)."""
    succ: torch.Tensor      # (T,) fleet-wide QoS successes this step
    issued: torch.Tensor    # (T,) fleet-wide issued requests this step
    regret: torch.Tensor    # (T,) system regret this step
    attempts: torch.Tensor  # (T,) fleet-wide attempts


class StreamOutputs(NamedTuple):
    """``ctrl`` holds the control plane's ``ControlCounters`` when a
    closed-loop config is on (lanes: every field with a leading (S,)
    axis, ``shed_k`` (S, K)), else ``None``; ``rec`` holds the flight
    recorder's ``obs.recorder.RecorderState`` when ``SimConfig.recorder``
    is on (lanes: one ring a lane, (S, cap) arrays and an (S, 1)
    ``ptr``), else ``None``."""
    acc: MetricAccumulator
    series: StepSeries
    ctrl: object = None
    rec: object = None


def is_tenant_run(x) -> bool:
    """Whether ``x`` (``StreamOutputs.acc``, a carry's strategy or
    accumulator slot) is a tenant run's: a plain tuple with one member
    a tenant, where a single-service run holds one NamedTuple."""
    return type(x) is tuple


def each(x, f):
    """``f(x)``, or the tuple of ``f`` of each tenant's member of a
    tenant run's ``x``; None stays None."""
    if x is None:
        return None
    if is_tenant_run(x):
        return tuple(f(v) for v in x)
    return f(x)


def init_accumulator(K: int, M: int, C: int, bins: int = PROC_HIST_BINS, *,
                     n_marks: int, ev_buckets: int, device: torch.device,
                     lanes: int | None = None) -> MetricAccumulator:
    """Zeroed accumulator; ``n_marks``/``ev_buckets`` must match the
    drivers (``scenarios.MAX_MARKS``) and ``SimConfig.ev_buckets``.
    ``lanes=S`` gives every field a leading (S,) axis."""
    lead = () if lanes is None else (lanes,)

    def z(*shape):
        return torch.zeros(lead + shape, dtype=torch.float32, device=device)

    return MetricAccumulator(
        succ_kc=z(K, C), n_kc=z(K, C), arrivals_m=z(M),
        choice_counts=z(K, M), proc_hist=z(M, bins), regret_k=z(K),
        vb_k=z(K), prev_mu=z(K, M), steps_measured=z(),
        ev_succ=z(n_marks, 1 + ev_buckets), ev_n=z(n_marks, 1 + ev_buckets),
        att_k=z(K), timeout_k=z(K), drop_k=z(K), open_km=z(K, M))


def update_accumulator(
    acc: MetricAccumulator,
    *,
    rewards: torch.Tensor,      # (K, C) 1/0 QoS outcome (unmasked)
    issued: torch.Tensor,       # (K, C) bool request-issued mask
    choices: torch.Tensor,      # (K, C) selected instance
    procs: torch.Tensor,        # (K, C) processing-latency component
    arrivals: torch.Tensor,     # (M,)  arrivals this step
    regret: torch.Tensor,       # (K,)  per-player oracle regret this step
    mu: torch.Tensor,           # (K, M) true success probabilities this step
    t_idx: int,                 # global step index (a host integer)
    warmup_steps: int,
    marks: torch.Tensor | None = None,   # (E,) event-onset steps, -1 padded
    ev_pre_steps: int = 1,
    ev_bucket_steps: int = 1,
    attempts: torch.Tensor | None = None,
    dropped: torch.Tensor | None = None,
    brk_open: torch.Tensor | None = None,
    served: torch.Tensor | None = None,
) -> MetricAccumulator:
    """One on-device accumulator update; everything here is O(K·M).

    ``t_idx`` is a host integer (the step loop runs on the host), so the
    warmup and first-step gates cost no device work. A lane-batched
    accumulator (``init_accumulator(lanes=S)``) takes every argument
    with a leading (S,) axis and updates each lane as it would alone."""
    arrays = dict(rewards=rewards, issued=issued, choices=choices,
                  procs=procs, arrivals=arrivals, regret=regret, mu=mu,
                  marks=marks, attempts=attempts, dropped=dropped,
                  brk_open=brk_open, served=served)
    if acc.succ_kc.dim() == 3:
        return _update_lanes(acc, t_idx, warmup_steps, ev_pre_steps,
                             ev_bucket_steps, **arrays)
    one = {k: None if v is None else v[None] for k, v in arrays.items()}
    out = _update_lanes(MetricAccumulator(*(x[None] for x in acc)), t_idx,
                        warmup_steps, ev_pre_steps, ev_bucket_steps, **one)
    return MetricAccumulator(*(x[0] for x in out))


def _update_lanes(acc: MetricAccumulator, t_idx: int, warmup_steps: int,
                  ev_pre_steps: int, ev_bucket_steps: int, *, rewards,
                  issued, choices, procs, arrivals, regret, mu, marks,
                  attempts, dropped, brk_open, served) -> MetricAccumulator:
    """``update_accumulator`` over a leading (S,) lane axis."""
    S, K, C = rewards.shape
    _, M, B = acc.proc_hist.shape
    dev = rewards.device
    issf = issued.to(torch.float32)
    servf = issf if served is None else served.to(torch.float32)
    meas = 1.0 if t_idx >= warmup_steps else 0.0
    ch = choices.to(torch.int64)
    lane = torch.arange(S, device=dev)[:, None, None]

    # latency sketch + routing histogram: one flat index_add_ each
    pbin = torch.clamp(torch.searchsorted(_edges(dev), procs, right=False),
                       0, B - 1)
    hist_upd = torch.zeros(S * M * B, dtype=torch.float32,
                           device=dev).index_add_(
        0, ((lane * M + ch) * B + pbin).reshape(-1),
        servf.reshape(-1)).reshape(S, M, B)
    kidx = torch.arange(K, device=dev)[None, :, None]
    choice_upd = torch.zeros(S * K * M, dtype=torch.float32,
                             device=dev).index_add_(
        0, ((lane * K + kidx) * M + ch).reshape(-1),
        servf.reshape(-1)).reshape(S, K, M)

    # event-relative recovery windows, each lane against its own marks:
    # rows outside every window add 0.0 to slot 0 where the reference
    # drops them (x + 0.0 == x)
    ev_succ, ev_n = acc.ev_succ, acc.ev_n
    if marks is not None:
        _, E, B1 = ev_succ.shape
        rel = t_idx - marks.to(torch.int64)
        pre = (rel >= -ev_pre_steps) & (rel < 0)
        pb = torch.where(rel >= 0,
                         torch.div(rel, ev_bucket_steps, rounding_mode="floor"),
                         B1)
        slot = torch.where(pre, 0, 1 + pb)
        valid = (marks >= 0) & (pre | ((rel >= 0) & (pb < B1 - 1)))
        slot = torch.where(valid, slot, 0)
        sidx = torch.arange(S, device=dev)[:, None].expand(S, E)
        eidx = torch.arange(E, device=dev)[None, :].expand(S, E)
        vf = valid.to(torch.float32)
        succ = (rewards * issf).sum((1, 2))[:, None]
        ev_succ = ev_succ.index_put((sidx, eidx, slot), vf * succ,
                                    accumulate=True)
        ev_n = ev_n.index_put((sidx, eidx, slot),
                              vf * issf.sum((1, 2))[:, None], accumulate=True)

    att = issf if attempts is None else attempts.to(torch.float32)
    dropf = (torch.zeros_like(issf) if dropped is None
             else dropped.to(torch.float32))
    completed = issf * (1.0 - dropf)
    open_upd = (acc.open_km if brk_open is None
                else acc.open_km + meas * brk_open.to(torch.float32))

    if t_idx > 0:
        vb_step = torch.abs(mu - acc.prev_mu).max(-1).values
    else:
        vb_step = torch.zeros_like(acc.vb_k)
    return MetricAccumulator(
        succ_kc=acc.succ_kc + meas * rewards * issf,
        n_kc=acc.n_kc + meas * issf,
        arrivals_m=acc.arrivals_m + meas * arrivals,
        choice_counts=acc.choice_counts + meas * choice_upd,
        proc_hist=acc.proc_hist + meas * hist_upd,
        regret_k=acc.regret_k + regret,
        vb_k=acc.vb_k + vb_step,
        prev_mu=mu,
        steps_measured=acc.steps_measured + meas,
        ev_succ=ev_succ,
        ev_n=ev_n,
        att_k=acc.att_k + meas * att.sum(-1),
        timeout_k=acc.timeout_k + meas * (att - completed).sum(-1),
        drop_k=acc.drop_k + meas * dropf.sum(-1),
        open_km=open_upd,
    )


# ---------------------------------------------------------------------------
# Readouts (host side).
# ---------------------------------------------------------------------------

def _np(x, dtype=None) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


# ---------------------------------------------------------------------------
# Trace-mode readouts (full SimOutputs trajectories).
# ---------------------------------------------------------------------------

def per_client_success(outs, warmup_steps: int = 0):
    """(K, C) fraction of each client's requests meeting QoS + presence
    mask (Fig. 5)."""
    r = _np(outs.rewards)[warmup_steps:]
    m = _np(outs.issued)[warmup_steps:]
    n = np.maximum(m.sum(0), 1)
    return (r * m).sum(0) / n, m.sum(0) > 0


def client_qos_satisfaction(outs, rho: float,
                            warmup_steps: int = 0) -> float:
    """% of clients whose success ratio >= rho (Fig. 3)."""
    ratio, present = per_client_success(outs, warmup_steps)
    return _qos_satisfaction(ratio, present, rho)


def jain_fairness(outs, reachable: np.ndarray | None = None,
                  warmup_steps: int = 0) -> float:
    """Jain's index over per-instance request totals (Fig. 4)."""
    return _jain(_np(outs.arrivals)[warmup_steps:].sum(0), reachable)


def rolling_qos(outs, window_steps: int) -> np.ndarray:
    """(T,) rolling overall QoS success rate (Fig. 6)."""
    issued = _np(outs.issued)
    r = (_np(outs.rewards) * issued).sum((1, 2))
    return _rolling_ratio(r, issued.sum((1, 2)).astype(np.float64),
                          window_steps)


def per_lb_rolling_qos(outs, window_steps: int) -> np.ndarray:
    """(T, K) rolling per-LB QoS success rate."""
    issued = _np(outs.issued)
    r = (_np(outs.rewards) * issued).sum(2)
    n = issued.sum(2).astype(np.float64)
    return np.stack([_rolling_ratio(r[:, k], n[:, k], window_steps)
                     for k in range(r.shape[1])], axis=1)


def request_rate_per_instance(outs, dt: float,
                              warmup_steps: int = 0) -> np.ndarray:
    """(M,) average req/s per instance (Fig. 7)."""
    a = _np(outs.arrivals)[warmup_steps:]
    return a.sum(0) / (a.shape[0] * dt)


def p90_proc_latency(outs, warmup_steps: int = 0) -> np.ndarray:
    """(M,) p90 of processing latency per instance (Fig. 8)."""
    proc = _np(outs.proc_lat)[warmup_steps:]
    m = _np(outs.issued)[warmup_steps:]
    ch = _np(outs.choices)[warmup_steps:]
    out = np.zeros(outs.arrivals.shape[1])
    for i in range(len(out)):
        vals = proc[m & (ch == i)]
        out[i] = np.percentile(vals, 90) if vals.size else 0.0
    return out


def per_lb_request_distribution(outs, lb: int,
                                warmup_steps: int = 0) -> np.ndarray:
    """(M,) share of LB ``lb``'s requests per instance (Fig. 9)."""
    m = _np(outs.issued)[warmup_steps:, lb]
    ch = _np(outs.choices)[warmup_steps:, lb]
    counts = np.bincount(ch[m], minlength=outs.arrivals.shape[1])
    counts = counts.astype(np.float64)
    return counts / max(counts.sum(), 1.0)


def cumulative_regret(outs) -> np.ndarray:
    """(T,) system regret sum_k R_k(t) (Eq. 9)."""
    return np.cumsum(_np(outs.regret).sum(1))


def variation_budget_emp(outs) -> np.ndarray:
    """(K,) empirical V_k(T) from the true-mu trajectory (Def. 1)."""
    return np.abs(np.diff(_np(outs.true_mu), axis=0)).max(-1).sum(0)


def resilience_stats(outs, warmup_steps: int = 0) -> dict:
    """Request-lifecycle counters from a trace; timeouts per slot are
    ``attempts - completed``."""
    att = _np(outs.attempts, np.float64)[warmup_steps:]
    drop = _np(outs.dropped)[warmup_steps:]
    m = _np(outs.issued)[warmup_steps:]
    return _resilience_dict(
        requests=m.sum(), attempts=att.sum(),
        timeouts=(att - (m & ~drop)).sum(), drops=(drop & m).sum())


def _resilience_dict(*, requests, attempts, timeouts, drops) -> dict:
    requests, attempts = float(requests), float(attempts)
    timeouts, drops = float(timeouts), float(drops)
    return {
        "requests": requests,
        "attempts": attempts,
        "retries": attempts - requests,
        "timeouts": timeouts,
        "drops": drops,
        "retry_rate": (attempts - requests) / max(requests, 1.0),
        "timeout_rate": timeouts / max(attempts, 1.0),
        "drop_rate": drops / max(requests, 1.0),
    }


# ---------------------------------------------------------------------------
# Streaming readouts (MetricAccumulator / StepSeries).
# ---------------------------------------------------------------------------

def per_client_success_stream(acc: MetricAccumulator):
    """(K, C) per-client success ratio + presence mask (Fig. 5)."""
    s, n = _np(acc.succ_kc), _np(acc.n_kc)
    return s / np.maximum(n, 1), n > 0


def _qos_satisfaction(ratio, present, rho) -> float:
    ok = (ratio >= rho) & present
    return 100.0 * ok.sum() / max(present.sum(), 1)


def client_qos_satisfaction_stream(acc: MetricAccumulator,
                                   rho: float) -> float:
    """% of clients whose success ratio >= rho (Fig. 3)."""
    ratio, present = per_client_success_stream(acc)
    return _qos_satisfaction(ratio, present, rho)


def _jain(x: np.ndarray, reachable: np.ndarray | None) -> float:
    if reachable is not None:
        x = x[reachable]
    s = x.sum()
    if s <= 0:
        return 0.0
    return float(s * s / (len(x) * (x * x).sum()))


def jain_fairness_stream(acc: MetricAccumulator,
                         reachable: np.ndarray | None = None) -> float:
    """Jain's index over per-instance request totals (Fig. 4)."""
    return _jain(_np(acc.arrivals_m), reachable)


def request_rate_per_instance_stream(acc: MetricAccumulator,
                                     dt: float) -> np.ndarray:
    """(M,) average req/s per instance (Fig. 7)."""
    steps = max(float(_np(acc.steps_measured)), 1.0)
    return _np(acc.arrivals_m) / (steps * dt)


def proc_latency_quantile_stream(acc: MetricAccumulator,
                                 q: float = 0.9) -> np.ndarray:
    """(M,) q-quantile of processing latency from the histogram sketch
    (Fig. 8)."""
    hist = _np(acc.proc_hist, np.float64)
    M, B = hist.shape
    centers = np.empty(B)
    centers[0] = _PROC_EDGES[0]
    centers[1:-1] = np.sqrt(_PROC_EDGES[:-1] * _PROC_EDGES[1:])
    centers[-1] = _PROC_EDGES[-1]
    n = hist.sum(1)
    rank = q * np.maximum(n - 1.0, 0.0)
    cum = hist.cumsum(1)
    idx = np.argmax(cum > rank[:, None], axis=1)
    return np.where(n > 0, centers[idx], 0.0)


def _rolling_ratio(r: np.ndarray, n: np.ndarray,
                   window_steps: int) -> np.ndarray:
    """(T,) windowed sum(r)/sum(n) with a growing left edge."""
    T = len(r)
    cs_r = np.concatenate([[0.0], np.cumsum(r, dtype=np.float64)])
    cs_n = np.concatenate([[0.0], np.cumsum(n, dtype=np.float64)])
    lo = np.maximum(0, np.arange(T) - window_steps + 1)
    hi = np.arange(1, T + 1)
    return (cs_r[hi] - cs_r[lo]) / np.maximum(cs_n[hi] - cs_n[lo], 1.0)


def rolling_qos_series(series: StepSeries, window_steps: int) -> np.ndarray:
    """(T,) rolling overall QoS success rate from the per-step streams
    (Fig. 6)."""
    return _rolling_ratio(_np(series.succ),
                          _np(series.issued).astype(np.float64),
                          window_steps)


def per_lb_request_distribution_stream(acc: MetricAccumulator,
                                       lb: int) -> np.ndarray:
    """(M,) share of LB ``lb``'s post-warmup requests per instance
    (Fig. 9)."""
    counts = _np(acc.choice_counts, np.float64)[lb]
    return counts / max(counts.sum(), 1.0)


def cumulative_regret_series(series: StepSeries) -> np.ndarray:
    """(T,) cumulative system regret from the per-step stream."""
    return np.cumsum(_np(series.regret, np.float64))


def variation_budget_stream(acc: MetricAccumulator) -> np.ndarray:
    """(K,) empirical V_k(T) partial sum (Def. 1)."""
    return _np(acc.vb_k)


def resilience_stats_stream(acc: MetricAccumulator) -> dict:
    """Post-warmup attempt, retry, timeout and drop counts and rates."""
    return _resilience_dict(
        requests=_np(acc.n_kc, np.float64).sum(),
        attempts=_np(acc.att_k, np.float64).sum(),
        timeouts=_np(acc.timeout_k, np.float64).sum(),
        drops=_np(acc.drop_k, np.float64).sum())


def breaker_open_fraction_stream(acc: MetricAccumulator) -> np.ndarray:
    """(K, M) share of post-warmup steps each (player, arm) breaker was
    open."""
    steps = max(float(_np(acc.steps_measured)), 1.0)
    return _np(acc.open_km, np.float64) / steps


def goodput_offered_series(series: StepSeries, dt: float,
                           window_steps: int) -> tuple[np.ndarray, np.ndarray]:
    """Rolling (goodput, offered) req/s from the per-step streams:
    requests that met their deadline, and every attempt on the wire
    (retries included); the gap is work that satisfied nobody."""
    succ = _np(series.succ, np.float64)
    att = _np(series.attempts, np.float64)
    T = len(succ)
    cs_s = np.concatenate([[0.0], np.cumsum(succ)])
    cs_a = np.concatenate([[0.0], np.cumsum(att)])
    lo = np.maximum(0, np.arange(T) - window_steps + 1)
    hi = np.arange(1, T + 1)
    span = (hi - lo) * dt
    return (cs_s[hi] - cs_s[lo]) / span, (cs_a[hi] - cs_a[lo]) / span


# ---------------------------------------------------------------------------
# Multi-tenant fairness (NT services on one fleet).
#
# A tenant run (``SimConfig.tenancy`` with two or more tenants) returns a
# TUPLE of NT accumulators in ``StreamOutputs.acc``, one per service,
# and (T, NT) series. The readouts below take that tuple: per-tenant
# QoS, how evenly the shared fleet serves the tenants (Gini, Jain,
# Herfindahl over per-tenant outcomes), and whether the NT bandit fleets
# partitioned the instances among themselves.
# ---------------------------------------------------------------------------

def gini_index(x) -> float:
    """Gini coefficient of a non-negative allocation vector: 0 equal,
    towards 1 concentrated, from the sorted-rank identity ``2 * sum(i *
    x_(i)) / (n * sum(x)) - (n + 1) / n``. Empty or all-zero: 0.0."""
    x = np.asarray(x, np.float64)
    n = x.size
    if n == 0:
        return 0.0
    s = x.sum()
    if s <= 0.0:
        return 0.0
    xs = np.sort(x)
    i = np.arange(1, n + 1, dtype=np.float64)
    return float(2.0 * (i * xs).sum() / (n * s) - (n + 1.0) / n)


def jain_index(x) -> float:
    """Jain's fairness index ``(sum x)^2 / (n * sum x^2)``: 1 equal, 1/n
    one-hot. Empty or all-zero: 1.0.

    The vector is divided by its maximum first, so the squares cannot
    underflow: on ``[5e-324]`` or ``[1e-310, 1e-310]`` the reference's
    unscaled ``x * x`` flushes to 0 and leaves [1/n, 1]; this gives 1.0.
    On other vectors the two agree to a few ULP."""
    x = np.asarray(x, np.float64)
    n = x.size
    if n == 0:
        return 1.0
    if x.sum() <= 0.0:
        return 1.0
    y = x / x.max()
    s = y.sum()
    return float(s * s / (n * (y * y).sum()))


def herfindahl_index(x) -> float:
    """Herfindahl-Hirschman concentration ``sum (x_i / sum x)^2``: 1/n
    spread, 1 one-hot; ``jain = 1 / (n * hhi)``. Empty: 0.0; all-zero:
    the uniform 1/n."""
    x = np.asarray(x, np.float64)
    n = x.size
    if n == 0:
        return 0.0
    s = x.sum()
    if s <= 0.0:
        return 1.0 / n
    p = x / s
    return float((p * p).sum())


def tenant_qos_stream(accs) -> np.ndarray:
    """(NT,) post-warmup QoS success ratio per tenant."""
    return np.array([_np(a.succ_kc, np.float64).sum()
                     / max(_np(a.n_kc, np.float64).sum(), 1.0)
                     for a in accs])


def tenant_qos_satisfaction_stream(accs, rho: float) -> np.ndarray:
    """(NT,) per-tenant % of clients with success ratio >= rho (Fig. 3
    within each tenant's clients)."""
    return np.array([client_qos_satisfaction_stream(a, rho) for a in accs])


def tenant_served_stream(accs) -> np.ndarray:
    """(NT,) post-warmup issued requests per tenant: the load share the
    fleet carried for each service."""
    return np.array([_np(a.n_kc, np.float64).sum() for a in accs])


def tenant_fairness_stream(accs) -> dict:
    """Cross-tenant fairness over the QoS outcome each tenant got and
    the load share each placed: ``gini_qos``/``jain_qos``/``hhi_qos``
    over the per-tenant QoS ratios, ``gini_load``/``jain_load``/
    ``hhi_load`` over the per-tenant served totals."""
    qos = tenant_qos_stream(accs)
    load = tenant_served_stream(accs)
    return {
        "gini_qos": gini_index(qos),
        "jain_qos": jain_index(qos),
        "hhi_qos": herfindahl_index(qos),
        "gini_load": gini_index(load),
        "jain_load": jain_index(load),
        "hhi_load": herfindahl_index(load),
    }


def tenant_partition_stream(accs) -> dict:
    """Did the tenants' bandit fleets partition the shared instances?
    Each tenant's routing profile is its per-instance share of requests
    (``choice_counts`` summed over players); the pairwise overlap
    ``sum_m min(P_i[m], P_j[m])`` is 1 for identical spreads and 0 for
    disjoint ones. ``mean_overlap`` is the mean over pairs (1.0 under
    two tenants), ``partition_index`` its complement."""
    profiles = []
    for a in accs:
        c = _np(a.choice_counts, np.float64).sum(0)
        profiles.append(c / max(c.sum(), 1.0))
    n = len(profiles)
    if n < 2:
        return {"mean_overlap": 1.0, "partition_index": 0.0}
    overlaps = [np.minimum(profiles[i], profiles[j]).sum()
                for i in range(n) for j in range(i + 1, n)]
    mean_overlap = float(np.mean(overlaps))
    return {"mean_overlap": mean_overlap,
            "partition_index": 1.0 - mean_overlap}


# ---------------------------------------------------------------------------
# Lanes and event-relative recovery (scenario engine).
# ---------------------------------------------------------------------------

def lane(outs, s: int):
    """Lane ``s`` of a lane-batched ``StreamOutputs`` or ``SimOutputs``:
    every tensor's leading (S,) axis indexed at ``s``; the recorder's
    ring becomes lane s's (cap,) ring with its (1,) ``ptr``, the layout
    of a single run. A tenant run's accumulator tuple becomes the tuple
    of lane s's NT accumulators, its (S, T, NT) series (T, NT)."""
    def pick(x):
        if x is None:
            return None
        if isinstance(x, tuple):
            vals = [pick(v) for v in x]
            return tuple(vals) if is_tenant_run(x) else type(x)(*vals)
        return x[s]
    return pick(outs)


def event_windows_from_series(succ: np.ndarray, issued: np.ndarray,
                              marks: np.ndarray, ev_pre_steps: int,
                              ev_bucket_steps: int,
                              ev_buckets: int) -> tuple[np.ndarray, np.ndarray]:
    """The accumulator's ``ev_succ``/``ev_n`` windows computed after the
    fact from per-step scalar series: the trace-mode counterpart, for
    stream against trace checks and for reading recovery off a
    ``run_sim`` trajectory."""
    succ, issued, marks = _np(succ), _np(issued), _np(marks)
    E = marks.shape[0]
    ev_s = np.zeros((E, 1 + ev_buckets), np.float64)
    ev_n = np.zeros((E, 1 + ev_buckets), np.float64)
    T = len(succ)
    for e, m in enumerate(marks):
        if m < 0:
            continue
        lo = max(0, m - ev_pre_steps)
        ev_s[e, 0] = succ[lo:m].sum()
        ev_n[e, 0] = issued[lo:m].sum()
        for b in range(ev_buckets):
            blo, bhi = m + b * ev_bucket_steps, m + (b + 1) * ev_bucket_steps
            if blo >= T:
                break
            ev_s[e, 1 + b] = succ[blo:bhi].sum()
            ev_n[e, 1 + b] = issued[blo:bhi].sum()
    return ev_s, ev_n


def event_recovery(acc_or_windows, bucket_s: float,
                   threshold: float = 0.95) -> list[dict]:
    """Per-event adaptation statistics from the recovery windows (an
    accumulator of one lane, or ``(ev_succ, ev_n)``).

    One dict per real (non-sentinel) event: ``pre`` (QoS ratio in the
    pre-window), ``dip`` (worst post-bucket ratio) at ``dip_s``,
    ``steady`` (mean of the last <= 3 data-bearing post buckets),
    ``recovered`` and ``recovery_s``: the left edge of the first post
    bucket at or after the dip with ratio >= ``threshold * steady``
    (``None`` when it never comes). Recovery is measured from the dip,
    as ramped events dip buckets after their onset.

    Degenerate windows are NaN-explicit, as in the reference: an event
    with no data-bearing post bucket gives ``pre`` (itself NaN without
    pre-window requests), NaN ``dip``/``dip_s``/``steady``,
    ``recovered=False``, ``recovery_s=None``; a non-positive or
    non-finite ``steady`` gives ``recovered=False``, ``recovery_s=None``.
    Sentinel rows (no data anywhere) are skipped."""
    if isinstance(acc_or_windows, MetricAccumulator):
        ev_s = _np(acc_or_windows.ev_succ, np.float64)
        ev_n = _np(acc_or_windows.ev_n, np.float64)
    else:
        ev_s, ev_n = (_np(x, np.float64) for x in acc_or_windows)
    out = []
    for e in range(ev_s.shape[0]):
        post_n = ev_n[e, 1:]
        has = post_n > 0
        pre = (ev_s[e, 0] / ev_n[e, 0]) if ev_n[e, 0] > 0 else float("nan")
        if not has.any():
            if ev_n[e, 0] <= 0:
                continue            # sentinel row: no data anywhere
            out.append({"pre": float(pre), "dip": float("nan"),
                        "dip_s": float("nan"), "steady": float("nan"),
                        "recovered": False, "recovery_s": None})
            continue
        ratio = ev_s[e, 1:][has] / post_n[has]
        steady = float(ratio[-3:].mean())
        dip_idx = int(np.argmin(ratio))
        bucket_left = np.flatnonzero(has)
        recovery_s = None
        if np.isfinite(steady) and steady > 0.0:
            rec_mask = ratio[dip_idx:] >= threshold * steady
            if rec_mask.any():
                rec_idx = dip_idx + int(np.argmax(rec_mask))
                recovery_s = float(bucket_left[rec_idx] * bucket_s)
        out.append({"pre": float(pre), "dip": float(ratio.min()),
                    "dip_s": float(bucket_left[dip_idx] * bucket_s),
                    "steady": steady, "recovered": recovery_s is not None,
                    "recovery_s": recovery_s})
    return out
