#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check its kernels.

    python3 chip_smoke.py                       # the check: one card, minutes
    python3 chip_smoke.py --profile build/prof  # also a profiler breakdown

Phases, one JSON line each; any failure exits non-zero:

1. device   -- the card (``nvidia-smi`` name and power limit).
2. build    -- every ``src/repro_torch/kernels/csrc/*.cu`` for sm_90a.
3. kernels  -- each CUDA kernel against its plain PyTorch version on the
               card, at the main path's shapes and at a small one.
4. testbed  -- ``run_sim_stream("qedgeproxy")`` at the paper's 30x10
               testbed for 180 s; at least 90% of clients must reach rho.
5. fleet    -- the K=1000 x M=50 anchor cell for 300 steps; both kernels
               must launch once per step.
6. times    -- each kernel, its plain version and its bound, at the
               fleet shapes, by CUDA events.

The last lines are the ``nvidia-smi`` line, the ``{"kernels": [...]}``
line and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (NVIDIA data sheet)

MAINT_TOL = 1e-5    # |mu| error: 64-term sums reassociated, CUDA erff/powf ULPs
ROUND_RTOL = 0.0    # the round kernel rounds every float as its plain version

TESTBED_HORIZON = 180.0                     # s: the paper's run
FLEET = dict(K=1000, M=50, horizon=30.0)    # the anchor cell, 300 steps
# (maintenance rows, K, M) of the kernel checks: the fleet's shapes, then
# the testbed's
KERNEL_SIZES = ((-(-FLEET["K"] // 10) * FLEET["M"], FLEET["K"], FLEET["M"]),
                (30, 30, 10))


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------------------
# Inputs, made from a seed.
# ---------------------------------------------------------------------------

def maintenance_inputs(rows: int, R: int, seed: int, dev):
    """Latency windows with ties, empty rows and full rows."""
    import torch
    rng = np.random.default_rng(seed)
    lat = rng.uniform(0.005, 0.15, (rows, R)).astype(np.float32)
    lat[rng.uniform(size=(rows, R)) < 0.3] = np.float32(0.05)    # ties
    mask = rng.uniform(size=(rows, R)) < rng.uniform(0.0, 1.0, (rows, 1))
    mask[0::7] = False                                           # empty
    mask[1::7] = True                                            # full
    mask[2::7] = False
    mask[2::7, :1] = True                                        # one sample
    rtt = rng.uniform(0.002, 0.04, rows).astype(np.float32)
    rtt[3::7] = np.float32(0.05)                   # proc = max(lat - rtt, 0) ties at 0
    return (torch.from_numpy(lat).to(dev), torch.from_numpy(mask).to(dev),
            torch.from_numpy(rtt).to(dev))


def round_inputs(K: int, M: int, C: int, R: int, Rq: int, seed: int, dev):
    """A mid-run round-step state: some arms cooling down and out of the
    pool, some instances inactive, error counters near the threshold,
    queues deep enough that latencies straddle tau."""
    import torch
    rng = np.random.default_rng(seed)
    f32 = np.float32
    t = f32(123.4)
    active = rng.uniform(size=M) > 0.1
    active[0] = True
    cooling = rng.uniform(size=(K, M)) < 0.1
    in_pool = (rng.uniform(size=(K, M)) < 0.8) & ~cooling & active[None, :]
    w = rng.uniform(size=(K, M)).astype(f32) * in_pool
    w[rng.uniform(size=K) < 0.05] = 0.0            # all-zero rows: fallback
    w = (w / np.maximum(w.sum(-1, keepdims=True), f32(1e-30))).astype(f32)
    cw = rng.uniform(-0.5, 0.5, (K, M)).astype(f32)
    err = rng.integers(0, 5, (K, M)).astype(np.int32)
    cooldown = np.where(cooling, t + f32(5.0), f32(-1e30)).astype(f32)
    lat_buf = rng.uniform(0.005, 0.15, (K, M, R)).astype(f32)
    ts_buf = np.where(rng.uniform(size=(K, M, R)) < 0.7,
                      rng.uniform(100.0, 123.3, (K, M, R)), -1e30).astype(f32)
    ptr = rng.integers(0, R, (K, M)).astype(np.int32)
    r_buf = (rng.uniform(size=(K, Rq)) < 0.9).astype(f32)
    rts_buf = rng.uniform(100.0, 123.3, (K, Rq)).astype(f32)
    rptr = rng.integers(0, Rq, K).astype(np.int32)
    q = rng.uniform(0.0, 15.0, M).astype(f32)
    nc = rng.integers(0, C + 1, K).astype(np.int32)
    nc[:3] = 0                                     # rows that issue nothing
    z = np.exp(0.25 * rng.standard_normal((C, K))).astype(f32)
    rtt = rng.uniform(0.002, 0.045, (K, M)).astype(f32)
    s_m = np.full(M, 0.0055, f32)
    served = (f32(0.1) / (f32(C) * s_m)).astype(f32)
    arrays = (w, cw, err, cooldown, in_pool, active, lat_buf, ts_buf, ptr,
              r_buf, rts_buf, rptr, q, nc, z, rtt, s_m, served)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in arrays) + (float(t),)


# ---------------------------------------------------------------------------
# Phases.
# ---------------------------------------------------------------------------

def phase_kernels(dev) -> dict:
    """Each kernel against its plain version on the same inputs."""
    import torch
    from repro_torch.kernels import kde, ref, round_fused
    errs = {}
    for seed, (rows, _, _) in enumerate(KERNEL_SIZES, 1):
        lat, mask, rtt = maintenance_inputs(rows, 64, seed, dev)
        mu, q = kde.fused_maintenance(lat, mask, rtt, 0.08, 0.9)
        mu_p, q_p = ref.bandit_maintenance_stats(lat, mask, rtt, 0.08, 0.9)
        torch.cuda.synchronize()
        if not torch.equal(q, q_p):
            bad = (q != q_p).nonzero()[:5].flatten().tolist()
            raise AssertionError(f"maintenance q differs at rows {bad}")
        err = (mu - mu_p).abs().max().item()
        if not err <= MAINT_TOL:
            raise AssertionError(f"maintenance mu error {err} > {MAINT_TOL}")
        errs.setdefault("fused_maintenance", err)
        emit(phase="kernels", kernel="fused_maintenance", rows=rows, R=64,
             q_exact=True, mu_max_abs_err=err, tol=MAINT_TOL)

    names = ref.RoundStepOut._fields
    for seed, (_, K, M) in enumerate(KERNEL_SIZES, 3):
        args = round_inputs(K, M, 8, 64, 512, seed, dev)
        kw = dict(tau=0.08, err_thresh=5, cooldown=10.0)
        out = round_fused.round_step_swrr(*args, **kw)
        plain = ref.round_step_swrr(*args, **kw)
        torch.cuda.synchronize()
        worst = 0.0
        for name, a, b in zip(names, out, plain):
            if a.dtype.is_floating_point:
                e = (a - b).abs().max().item()
                worst = max(worst, e)
                ok = torch.allclose(a, b, rtol=ROUND_RTOL, atol=0.0)
            else:
                ok = torch.equal(a, b.to(a.dtype))
            if not ok:
                raise AssertionError(f"round_step_swrr {name} differs "
                                     f"(K={K}, M={M})")
        errs.setdefault("round_step_swrr", worst)
        trips = int((args[3] != out.cooldown_until).sum())
        emit(phase="kernels", kernel="round_step_swrr", K=K, M=M, C=8,
             R=64, Rq=512, exact=True, max_abs_err=worst, trips=trips)
    return errs


def check_conservation(acc) -> None:
    """Every measured request lands once in each per-instance count."""
    issued = float(acc.n_kc.sum())
    for name in ("arrivals_m", "choice_counts", "proc_hist", "att_k"):
        got = float(getattr(acc, name).sum())
        if got != issued:
            raise AssertionError(f"{name} counts {got} requests, "
                                 f"{issued} were issued")
    if not bool(acc.regret_k.isfinite().all()):
        raise AssertionError("non-finite regret")


def phase_testbed(dev) -> None:
    """The paper's 30x10 testbed, as examples/continuum_sim.py runs it."""
    from repro_torch.continuum import (SimConfig, client_qos_satisfaction_stream,
                                       jain_fairness_stream, make_topology,
                                       rolling_qos_series, run_sim_stream)
    cfg = SimConfig(horizon=TESTBED_HORIZON)
    warm = int(min(60.0, TESTBED_HORIZON / 3) / cfg.dt)
    topo = make_topology(1, 30, 10, device=dev)
    t0 = time.perf_counter()
    out = run_sim_stream("qedgeproxy", topo.lb_instance_rtt(), cfg, 7,
                         warmup_steps=warm, device=dev)
    secs = time.perf_counter() - t0
    check_conservation(out.acc)
    sat = client_qos_satisfaction_stream(out.acc, cfg.rho)
    fair = jain_fairness_stream(out.acc)
    steady = float(rolling_qos_series(out.series,
                                      int(cfg.window / cfg.dt))[warm:].mean())
    emit(phase="testbed", K=30, M=10, steps=cfg.num_steps,
         clients_ge_rho_pct=sat, jain_fairness=fair, steady_qos=steady,
         seconds=secs)
    if not sat >= 90.0:
        raise AssertionError(f"clients >= rho {sat}% < 90%")


def fleet_inputs(dev, horizon: float):
    import torch
    from repro_torch.continuum import SimConfig
    K, M = FLEET["K"], FLEET["M"]
    cfg = SimConfig(horizon=horizon)
    rtt = np.random.default_rng(0).uniform(0.002, 0.04, (K, M))
    return cfg, torch.tensor(rtt, dtype=torch.float32, device=dev)


def phase_fleet(dev) -> dict:
    """The K=1000 x M=50 anchor cell; the launches prove the path."""
    import torch
    from repro_torch.continuum import client_qos_satisfaction_stream, run_sim_stream
    from repro_torch.kernels import kde, round_fused
    cfg, rtt = fleet_inputs(dev, FLEET["horizon"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kde.fused_maintenance.launches = 0
    round_fused.round_step_swrr.launches = 0
    t0 = time.perf_counter()
    out = run_sim_stream("qedgeproxy", rtt, cfg, 7, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {"round_step_swrr": round_fused.round_step_swrr.launches,
                "fused_maintenance": kde.fused_maintenance.launches}
    steps = cfg.num_steps
    issued = out.series.issued
    emit(phase="fleet", K=FLEET["K"], M=FLEET["M"], C=8, R=64, Rq=512,
         steps=steps, seconds=secs, steps_per_s=steps / secs,
         peak_mem_bytes=torch.cuda.max_memory_allocated(dev),
         launches=launches,
         clients_ge_rho_pct=client_qos_satisfaction_stream(out.acc, cfg.rho),
         requests=float(issued.sum()))
    check_conservation(out.acc)
    for name, n in launches.items():
        if n != steps:
            raise AssertionError(f"{name} launched {n} times in {steps} steps")
    return launches


def phase_times(dev, launches: dict, errs: dict) -> list:
    """Kernel, plain version and bound at the fleet shapes."""
    from repro_torch.kernels import kde, ref, round_fused
    (rows, K, M), C, R, Rq = KERNEL_SIZES[0], 8, 64, 512
    lat, mask, rtt = maintenance_inputs(rows, R, 5, dev)
    m_args = (lat, mask, rtt, 0.08, 0.9)
    m_bytes = nbytes(lat, mask, rtt) + 2 * rows * 4
    r_args = round_inputs(K, M, C, R, Rq, 6, dev)
    kw = dict(tau=0.08, err_thresh=5, cooldown=10.0)
    state_in = r_args[:12]
    r_bytes = (nbytes(*r_args[:18])
               + nbytes(*(x for i, x in enumerate(state_in) if i != 5))
               + 2 * M * 4 + 3 * K * C * 4)        # q, arrivals; choices, lats, procs
    rows_out = []
    for name, src, replaces, kern, plain, args, kwargs, by, iters in (
            ("round_step_swrr", "src/repro_torch/kernels/csrc/round_fused.cu",
             "src/repro/kernels/round_fused.py:183",
             round_fused.round_step_swrr, ref.round_step_swrr, r_args, kw,
             r_bytes, 20),
            ("fused_maintenance", "src/repro_torch/kernels/csrc/maintenance.cu",
             "src/repro/kernels/kde.py:127", kde.fused_maintenance,
             ref.bandit_maintenance_stats, m_args, {}, m_bytes, 200)):
        ms = cuda_ms(lambda: kern(*args, **kwargs), iters)
        plain_ms = cuda_ms(lambda: plain(*args, **kwargs), max(iters // 10, 3))
        rows_out.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name], max_abs_err=errs[name], ms=ms,
            plain_ms=plain_ms, bound_ms=by / HBM_BYTES_PER_S * 1e3,
            bound_by="bytes", library_ms=None))
        emit(phase="times", bytes=by, **rows_out[-1])
    return rows_out


def phase_profile(dev, trace_dir: Path) -> None:
    """torch.profiler over 20 fleet steps: device time by kernel name.
    The busy time sums the device-side events only (an op's device time
    repeats its kernels')."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.continuum import run_sim_stream
    cfg, rtt = fleet_inputs(dev, 2.0)
    run_sim_stream("qedgeproxy", rtt, cfg, 7, device=dev)      # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_sim_stream("qedgeproxy", rtt, cfg, 7, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    dev_us = sum(e.self_device_time_total for e in kernels)
    ops = sorted((e for e in events if e.device_type == DeviceType.CPU
                  and e.key.startswith("aten::")), key=lambda e: -e.count)
    emit(phase="profile", steps=cfg.num_steps, wall_s=wall,
         device_busy_us=dev_us, device_busy_share=dev_us / (wall * 1e6),
         kernel_launches=sum(e.count for e in kernels),
         top_kernels=[dict(name=e.key[:60], us=e.self_device_time_total,
                           calls=e.count) for e in kernels[:8]],
         top_ops=[dict(name=e.key, calls=e.count) for e in ops[:8]])
    trace_dir.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace_dir / "fleet_trace.json"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR", type=Path,
                    help="add a torch.profiler breakdown of fleet steps and "
                         "write its Chrome trace to DIR/fleet_trace.json")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    emit(phase="device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    build_s = _build.build()
    emit(phase="build", seconds=build_s,
         sources=[str(s.relative_to(ROOT)) for s in _build.sources()],
         ptxas=[ln.strip() for ln in
                (_build.BUILD_DIR / "build.log").read_text().splitlines()
                if "registers" in ln or "spill" in ln])
    errs = phase_kernels(dev)
    phase_testbed(dev)
    launches = phase_fleet(dev)
    kernels = phase_times(dev, launches, errs)
    if args.profile is not None:
        phase_profile(dev, args.profile)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
