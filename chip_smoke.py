#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA card and check its kernels.

    python3 chip_smoke.py                       # the check: one card, minutes
    python3 chip_smoke.py --profile build/prof  # also profiler breakdowns

Phases, one JSON line each; any failure exits non-zero:

1. device    -- the card (``nvidia-smi`` name and power limit).
2. build     -- every ``src/repro_torch/kernels/csrc/*.cu`` for sm_90a.
3. kernels   -- each CUDA kernel against its plain PyTorch version on the
                card, at the main paths' shapes and at small ones.
4. testbed   -- ``run_sim_stream("qedgeproxy")`` at the paper's 30x10
                testbed for 180 s; at least 90% of clients must reach rho.
5. fleet     -- the K=1000 x M=50 anchor cell for 300 steps; both
                simulator kernels must launch once per step.
6. serve     -- ``repro_torch.launch.serve`` with qwen3-4b at its
                published width behind the QEdgeProxy router (3 replicas,
                one slow); every request answers with finite logits, the
                attention kernels launch once per layer per prefill /
                decode call, maintenance once per router maintenance, and
                every front-end weighs the slow replica below each fast one.
7. decode_graph -- mamba2-1.3b's decode step replayed as a CUDA graph
                against the same step run eagerly: exactly equal.
   serve_ssm -- the same cell with mamba2-1.3b at its published width: the
                SSD kernel launches once per layer per prefill, maintenance
                once per router maintenance, the same gates.
8. times     -- each kernel, its plain version, the one PyTorch call that
                computes the same function (where there is one) and its
                bound, at the main paths' shapes, by CUDA events; then
                serve_shares: each serving kernel's time x launches over
                its serve run's median prefill / decode call.
9. profile   -- with ``--profile``: torch.profiler over 20 fleet steps and
                over one prefill and one decode call of each served model.

The last lines are the ``nvidia-smi`` line, the ``{"kernels": [...]}``
line and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (NVIDIA data sheet)
BF16_FLOP_PER_S = 989e12           # H100 SXM dense bf16 tensor cores (data sheet)

MAINT_TOL = 1e-5    # |mu| error: 64-term sums reassociated, CUDA erff/powf ULPs
ROUND_RTOL = 0.0    # the round kernel rounds every float as its plain version
# KDE alone: tests/test_kernels.py's bound (64-term sums reassociated, erff)
KDE_TOL = dict(rtol=2e-5, atol=2e-6)

TESTBED_HORIZON = 180.0                     # s: the paper's run
FLEET = dict(K=1000, M=50, horizon=30.0)    # the anchor cell, 300 steps
# (maintenance rows, K, M) of the kernel checks: the fleet's shapes, then
# the testbed's
KERNEL_SIZES = ((-(-FLEET["K"] // 10) * FLEET["M"], FLEET["K"], FLEET["M"]),
                (30, 30, 10))

# The serving cell: qwen3-4b at its published width; a prompt of 1000 is
# not a multiple of the prefill kernel's 64-row blocks and the 1016-slot
# cache ends mid-tile in decode.
SERVE = dict(replicas=3, frontends=4, requests=30, batch=4, prompt_len=1000,
             decode_steps=16, tau=1.0, slow_replica=2)
HEADS = dict(Hq=32, Hkv=8, D=128)                  # qwen3-4b attention
# max |kernel - plain| at unit-scale inputs: float32 sums reassociated,
# CUDA's expf; bfloat16 outputs round to 2**-8 of their magnitude
ATTN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# (B, Hq, Hkv, S, D, dtype, causal, window): the serve prefill first
FLASH_CASES = ((SERVE["batch"], HEADS["Hq"], HEADS["Hkv"], SERVE["prompt_len"],
                HEADS["D"], "bfloat16", True, None),
               (2, 4, 2, 200, 64, "float32", True, 48),
               (2, 4, 1, 130, 32, "float32", False, None),
               (1, 4, 4, 40, 16, "float32", False, 8))
# (B, Hq, Hkv, S, D, dtype, lengths): the serve decode cache first
DECODE_CASES = ((SERVE["batch"], HEADS["Hq"], HEADS["Hkv"],
                 SERVE["prompt_len"] + SERVE["decode_steps"], HEADS["D"],
                 "bfloat16", (1, 512, 513, 1016)),
                (2, 8, 2, 100, 64, "float32", (1, 64)),
                (2, 4, 1, 40, 16, "float32", (40, 17)))
# SSD, element by element (|out - plain| <= atol + rtol |plain|): float32
# to tests/test_kernels.py's rtol = atol = 1e-3 (the chunked form
# reassociates the decays); a bfloat16 output to one bfloat16 step of
# its own magnitude (rtol 2**-7: the two float32 results, a few ULPs
# apart, may round to neighbouring bfloat16 values) plus atol 1e-2 for
# outputs near 0, where float32 sums in another order over 1000 rows of
# magnitude ~10 differ by ~1e-4
SSD_TOL = {"float32": dict(rtol=1e-3, atol=1e-3),
           "bfloat16": dict(rtol=2.0 ** -7, atol=1e-2)}
SSM = dict(H=64, P=64, N=128, chunk=256)           # mamba2-1.3b SSD
# (B, S, H, P, N, chunk, dtype, model-made inputs): the serve prefill
# first; then tests/test_kernels.py's mamba2-like case, a ragged S at the
# reduced config's widths and a ragged S with three heads
SSD_CASES = ((SERVE["batch"], SERVE["prompt_len"], SSM["H"], SSM["P"],
              SSM["N"], SSM["chunk"], "bfloat16", True),
             (1, 256, 2, 64, 128, 128, "float32", False),
             (2, 130, 4, 16, 8, 16, "float32", False),
             (1, 77, 3, 32, 16, 64, "float32", True))
# (rows, R): benchmarks/footprint.py's shape, then tests/test_kernels.py's
KDE_SIZES = ((65536, 64), (300, 64))


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


def attention_inputs(B: int, Hq: int, Hkv: int, S: int, D: int, dtype: str,
                     seed: int, dev):
    """Unit-scale prefill q (B,Hq,S,D), k and v (B,Hkv,S,D), drawn on the
    card from a seeded generator."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device=dev)
                 .to(getattr(torch, dtype))
                 for shape in ((B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D)))


def decode_inputs(B: int, Hq: int, Hkv: int, S: int, D: int, dtype: str,
                  lengths, seed: int, dev):
    """Unit-scale decode q (B,Hq,D), a cache k and v (B,Hkv,S,D), and the
    (B,) int32 valid lengths."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device=dev)
               .to(getattr(torch, dtype))
               for shape in ((B, Hq, D), (B, Hkv, S, D), (B, Hkv, S, D)))
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device=dev)


def ssd_inputs(B: int, S: int, H: int, P: int, N: int, dtype: str,
               model: bool, seed: int, dev):
    """x (B,S,H,P), dt (B,S,H), A (H,), Bm and Cm (B,S,N), drawn on the
    card. ``model``: as mamba2 makes them (dt = softplus around -2, A =
    -linspace(1, 16)); else as tests/test_kernels.py draws them (dt in
    [0.001, 0.1], A in [-2, -0.5])."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((B, S, H, P), generator=gen, device=dev)
    if model:
        dt = F.softplus(-2.0 + 0.5 * torch.randn((B, S, H), generator=gen,
                                                 device=dev))
        A = -torch.linspace(1.0, 16.0, H, device=dev)
    else:
        dt = 0.001 + 0.099 * torch.rand((B, S, H), generator=gen, device=dev)
        A = -(0.5 + 1.5 * torch.rand((H,), generator=gen, device=dev))
    Bm = torch.randn((B, S, N), generator=gen, device=dev)
    Cm = torch.randn((B, S, N), generator=gen, device=dev)
    return x.to(getattr(torch, dtype)), dt, A, Bm, Cm


def kde_inputs(rows: int, R: int, seed: int, dev):
    """tests/test_kernels.py's KDE inputs, with empty rows."""
    import torch
    rng = np.random.default_rng(seed)
    lat = rng.exponential(0.03, (rows, R)).astype(np.float32)
    mask = rng.uniform(size=(rows, R)) < 0.7
    mask[0::97] = False
    bw = rng.uniform(1e-3, 1e-2, rows).astype(np.float32)
    return (torch.from_numpy(lat).to(dev), torch.from_numpy(mask).to(dev),
            torch.from_numpy(bw).to(dev))


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

    from repro_torch.kernels import decode_attention, flash_attention
    for seed, case in enumerate(FLASH_CASES, 10):
        B, Hq, Hkv, S, D, dtype, causal, window = case
        q, k, v = attention_inputs(B, Hq, Hkv, S, D, dtype, seed, dev)
        out = flash_attention.flash_attention(q, k, v, causal=causal,
                                              window=window)
        plain = ref.attention(q, k, v, causal=causal, window=window)
        err = check_close("flash_attention", out, plain, ATTN_TOL[dtype])
        errs.setdefault("flash_attention", err)
        emit(phase="kernels", kernel="flash_attention", B=B, Hq=Hq, Hkv=Hkv,
             S=S, D=D, dtype=dtype, causal=causal, window=window,
             max_abs_err=err, tol=ATTN_TOL[dtype])
    for seed, case in enumerate(DECODE_CASES, 20):
        B, Hq, Hkv, S, D, dtype, lengths = case
        q, k, v, length = decode_inputs(B, Hq, Hkv, S, D, dtype, lengths,
                                        seed, dev)
        out = decode_attention.decode_attention(q, k, v, length)
        plain = ref.decode_attention(q, k, v, length)
        err = check_close("decode_attention", out, plain, ATTN_TOL[dtype])
        errs.setdefault("decode_attention", err)
        emit(phase="kernels", kernel="decode_attention", B=B, Hq=Hq,
             Hkv=Hkv, S=S, D=D, dtype=dtype, lengths=list(lengths),
             max_abs_err=err, tol=ATTN_TOL[dtype])

    from repro_torch.kernels import ssd
    for seed, case in enumerate(SSD_CASES, 40):
        B, S, H, P, N, chunk, dtype, model = case
        args = ssd_inputs(B, S, H, P, N, dtype, model, seed, dev)
        out = ssd.ssd(*args, chunk=chunk)
        plain = ref.ssd(*args)
        torch.cuda.synchronize()
        diff = (out.float() - plain.float()).abs()
        err = diff.max().item()
        scale = plain.float().abs().max().item()
        tol = SSD_TOL[dtype]
        # the worst element's share of its own allowance (NaN fails)
        used = (diff / (tol["atol"] + tol["rtol"] * plain.float().abs())
                ).max().item()
        if not (out.shape == plain.shape and out.dtype == plain.dtype
                and used <= 1.0):
            raise AssertionError(f"ssd {case}: max abs error {err} at output "
                                 f"scale {scale}, {used} of the allowance "
                                 f"{tol}")
        errs.setdefault("ssd", err)
        emit(phase="kernels", kernel="ssd", B=B, S=S, H=H, P=P, N=N,
             chunk=chunk, dtype=dtype, model_inputs=model, max_abs_err=err,
             out_max_abs=scale, out_rms=plain.float().square().mean().sqrt()
             .item(), allowance_used=used, **tol)
    for seed, (rows, R) in enumerate(KDE_SIZES, 50):
        lat, mask, bw = kde_inputs(rows, R, seed, dev)
        out = kde.kde_success_prob(lat, mask, 0.08, bw)
        plain = ref.kde_success_prob(lat, mask, 0.08, bw)
        torch.cuda.synchronize()
        err = (out - plain).abs().max().item()
        if not torch.allclose(out, plain, **KDE_TOL):
            raise AssertionError(f"kde_success_prob ({rows}, {R}): max abs "
                                 f"error {err}, tol {KDE_TOL}")
        errs.setdefault("kde_success_prob", err)
        emit(phase="kernels", kernel="kde_success_prob", rows=rows, R=R,
             max_abs_err=err, **KDE_TOL)
    return errs


def check_close(name: str, out, plain, tol: float) -> float:
    """max |out - plain| in float32; raises past ``tol`` (NaN included)
    or on a shape or dtype that differs."""
    import torch
    torch.cuda.synchronize()
    if out.shape != plain.shape or out.dtype != plain.dtype:
        raise AssertionError(f"{name}: {out.shape} {out.dtype} != plain "
                             f"{plain.shape} {plain.dtype}")
    err = (out.float() - plain.float()).abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{name}: max abs error {err} > {tol}")
    return err


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


def memory_baseline(dev) -> dict:
    """Free the cuBLAS workspaces that earlier phases' matrix products
    leave allocated, then start a new peak. Returns the bytes those
    workspaces held and the bytes still held, which a path's peak is
    measured above."""
    import torch
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    torch._C._cuda_clearCublasWorkspaces()
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    return dict(cublas_workspace_bytes=before - held, held_bytes=held)


def peak_above(dev, base: dict) -> int:
    """Peak bytes allocated since ``memory_baseline``, above what it held."""
    import torch
    return torch.cuda.max_memory_allocated(dev) - base["held_bytes"]


def phase_fleet(dev) -> dict:
    """The K=1000 x M=50 anchor cell; the launches prove the path."""
    import torch
    from repro_torch.continuum import client_qos_satisfaction_stream, run_sim_stream
    from repro_torch.kernels import kde, round_fused
    cfg, rtt = fleet_inputs(dev, FLEET["horizon"])
    base = memory_baseline(dev)
    for fn in all_kernels():
        fn.launches = 0
    t0 = time.perf_counter()
    out = run_sim_stream("qedgeproxy", rtt, cfg, 7, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {"round_step_swrr": round_fused.round_step_swrr.launches,
                "fused_maintenance": kde.fused_maintenance.launches,
                "kde_success_prob": kde.kde_success_prob.launches}
    steps = cfg.num_steps
    issued = out.series.issued
    emit(phase="fleet", K=FLEET["K"], M=FLEET["M"], C=8, R=64, Rq=512,
         steps=steps, seconds=secs, steps_per_s=steps / secs,
         peak_mem_bytes=peak_above(dev, base), **base, launches=launches,
         clients_ge_rho_pct=client_qos_satisfaction_stream(out.acc, cfg.rho),
         requests=float(issued.sum()))
    check_conservation(out.acc)
    needs = dict(round_step_swrr=steps, fused_maintenance=steps,
                 kde_success_prob=0)
    for name, n in needs.items():
        if launches[name] != n:
            raise AssertionError(f"{name} launched {launches[name]} times in "
                                 f"{steps} steps, the path needs {n}")
    return launches


def phase_serve(dev, phase: str, arch: str, per_prefill: tuple,
                per_decode: tuple) -> dict:
    """The serving cell through the launcher a user runs, with ``arch``
    at its published width; the launches prove the path: each kernel of
    ``per_prefill`` (``per_decode``) once per layer per prefill (decode
    call), maintenance once per router maintenance. Returns the launch
    counts and the per-call medians."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import kde
    from repro_torch.launch import serve
    argv = ["--arch", arch, "--device", "cuda"]
    for key, val in SERVE.items():
        argv += [f"--{key.replace('_', '-')}", str(val)]
    cfg = get_config(arch)
    base = memory_baseline(dev)
    for fn in all_kernels():
        fn.launches = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        router = serve.main(argv)
    secs = time.perf_counter() - t0
    kernels = (*per_prefill, *per_decode, kde.fused_maintenance,
               kde.kde_success_prob)
    launches = {fn.__name__: fn.launches for fn in kernels}
    *text, last = out.getvalue().strip().splitlines()
    print("\n".join(text), file=sys.stderr)
    rep = json.loads(last)
    prefill_ms = float(np.median(rep["prefill_s"])) * 1e3
    decode_ms = float(np.median(rep["decode_s"])) * 1e3
    w = router.weights
    slow = SERVE["slow_replica"]
    fast = [m for m in range(SERVE["replicas"]) if m != slow]
    emit(phase=phase, arch=rep["arch"], layers=cfg.num_layers,
         d_model=cfg.d_model, params=cfg.param_count(), argv=argv,
         seconds=secs, microbatches=rep["microbatches"],
         prefills=rep["prefills"], decodes=rep["decodes"],
         maintenance_calls=rep["maintenance_calls"], launches=launches,
         prefill_ms_median=prefill_ms, decode_ms_median=decode_ms,
         decode_tokens_per_s=SERVE["batch"] / decode_ms * 1e3,
         decode_tokens_per_s_all=SERVE["batch"] * rep["decodes"]
         / sum(rep["decode_s"]),
         peak_mem_bytes=peak_above(dev, base), **base,
         qos_success_pct=100.0 * rep["qos_ok"] / rep["microbatches"],
         weights=w.tolist(), qos_estimates=router.qos_estimates.tolist())
    if rep["arch"] != cfg.name:
        raise AssertionError(f"served {rep['arch']}, not {cfg.name}")
    if not rep["logits_finite"]:
        raise AssertionError("non-finite logits in a served request")
    want = SERVE["requests"] * SERVE["frontends"]
    if rep["microbatches"] != want or rep["prefills"] != want:
        raise AssertionError(f"{rep['prefills']} prefills, {want} requests")
    needs = [(fn.__name__, cfg.num_layers * rep["prefills"])
             for fn in per_prefill]
    needs += [(fn.__name__, cfg.num_layers * rep["decodes"])
              for fn in per_decode]
    needs += [("fused_maintenance", rep["maintenance_calls"]),
              ("kde_success_prob", 0)]
    for name, n in needs:
        if launches[name] != n:
            raise AssertionError(f"{name} launched {launches[name]} times, "
                                 f"the path needs {n}")
    if not all(w[k, slow] < w[k, m] for k in range(len(w)) for m in fast):
        raise AssertionError(f"slow replica {slow} not avoided: {w}")
    return dict(launches=launches, layers=cfg.num_layers,
                prefill_ms=prefill_ms, decode_ms=decode_ms)


def phase_decode_graph(dev, arch: str, steps: int = 4) -> None:
    """The SSM decode step replayed as a CUDA graph against the same
    step run eagerly, at the serve cell's batch and prompt: both run the
    same kernels on the same inputs, so logits and caches must agree
    exactly."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(arch)
    model = build_model(cfg, device=dev)
    B, S = SERVE["batch"], SERVE["prompt_len"]
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=dev)
    _, cache = model.prefill({"tokens": tokens})
    caches = {}
    for mode in (False, True):
        model.decode_graphs = mode
        c = {"layers": tuple(t.clone() for t in cache["layers"])}
        out = []
        for i in range(steps):
            tok = tokens[:, i:i + 1].to(torch.int32)
            logits, c = model.decode(c, {"token": tok, "pos": S + i})
            out.append(logits)
        caches[mode] = (torch.stack(out), *c["layers"])
    torch.cuda.synchronize()
    errs = [(a.float() - b.float()).abs().max().item()
            for a, b in zip(caches[False], caches[True])]
    emit(phase="decode_graph", arch=arch, batch=B, prompt=S, steps=steps,
         graphs=len(model._graphs),
         max_abs_err=dict(zip(("logits", "conv_state", "ssm_state"), errs)))
    if not all(e == 0.0 for e in errs):
        raise AssertionError(f"graph decode differs from eager: {errs}")
    del model, cache, caches


def all_kernels() -> tuple:
    """Every kernel wrapper of the port (each carries ``launches``)."""
    from repro_torch.kernels import (decode_attention, flash_attention, kde,
                                     round_fused, ssd)
    return (round_fused.round_step_swrr, kde.fused_maintenance,
            kde.kde_success_prob, flash_attention.flash_attention,
            decode_attention.decode_attention, ssd.ssd)


def phase_times(dev, launches: dict, errs: dict) -> list:
    """Kernel, plain version, library call and bound at the main paths'
    shapes. The bound is the larger of the bytes the call must move
    (each input read once, each output written once) over the memory
    rate and its operations over the bf16 tensor-core rate."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import (decode_attention, flash_attention, kde,
                                     ref, round_fused, ssd)
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

    B, Hq, Hkv, S, D, dtype, _, _ = FLASH_CASES[0]
    fq, fk, fv = attention_inputs(B, Hq, Hkv, S, D, dtype, 30, dev)
    f_bytes = 2 * nbytes(fq) + nbytes(fk, fv)            # out is q's size
    f_flops = 4 * B * Hq * D * S * (S + 1) // 2          # causal pairs
    Sc = DECODE_CASES[0][3]                              # last decode step
    dq, dk, dv, dlen = decode_inputs(B, Hq, Hkv, Sc, D, dtype, [Sc] * B, 31,
                                     dev)
    d_bytes = 2 * nbytes(dq) + nbytes(dk, dv) + nbytes(dlen)
    d_flops = 4 * Hq * D * Sc * B
    live = (torch.arange(Sc, device=dev)[None, :] < dlen[:, None])
    d_mask = live[:, None, None, :]

    B, S, H, P, N, chunk, dtype, model = SSD_CASES[0]
    s_args = ssd_inputs(B, S, H, P, N, dtype, model, 32, dev)
    s_bytes = nbytes(*s_args) + nbytes(s_args[0])        # y is x's size
    tile = ssd.TILE
    # the kernel's chunked algorithm at its tile: per tile and head the
    # scores (2T^2 N), the intra term (2T^2 P), C.h and the state update
    # (2TNP each); the TPU kernel's chunk of 256 needs ~3x as many
    s_flops = B * H * -(-S // tile) * (2 * tile * tile * (N + P)
                                      + 4 * tile * N * P)
    s_flops_256 = B * H * -(-S // chunk) * (2 * chunk * chunk * (N + P)
                                           + 4 * chunk * N * P)
    k_rows, k_R = KDE_SIZES[0]
    k_lat, k_mask, k_bw = kde_inputs(k_rows, k_R, 33, dev)
    k_args = (k_lat, k_mask, 0.08, k_bw)
    k_bytes = nbytes(k_lat, k_mask, k_bw) + k_rows * 4
    rows_out = []
    for (name, src, replaces, kern, plain, library, args, kwargs, by, ops,
         iters) in (
            ("round_step_swrr", "src/repro_torch/kernels/csrc/round_fused.cu",
             "src/repro/kernels/round_fused.py:183",
             round_fused.round_step_swrr, ref.round_step_swrr, None, r_args,
             kw, r_bytes, 0, 20),
            ("fused_maintenance", "src/repro_torch/kernels/csrc/maintenance.cu",
             "src/repro/kernels/kde.py:127", kde.fused_maintenance,
             ref.bandit_maintenance_stats, None, m_args, {}, m_bytes, 0, 200),
            ("flash_attention",
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:97",
             flash_attention.flash_attention, ref.attention,
             lambda: F.scaled_dot_product_attention(
                 fq, fk, fv, is_causal=True, enable_gqa=True),
             (fq, fk, fv), {}, f_bytes, f_flops, 20),
            ("decode_attention",
             "src/repro_torch/kernels/csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention.py:64",
             decode_attention.decode_attention, ref.decode_attention,
             lambda: F.scaled_dot_product_attention(
                 dq[:, :, None], dk, dv, attn_mask=d_mask, enable_gqa=True),
             (dq, dk, dv, dlen), {}, d_bytes, d_flops, 200),
            ("ssd", "src/repro_torch/kernels/csrc/ssd.cu",
             "src/repro/kernels/ssd.py:66",
             functools.partial(ssd.ssd, chunk=chunk), ref.ssd, None, s_args,
             {}, s_bytes, s_flops, 20),
            ("kde_success_prob", "src/repro_torch/kernels/csrc/maintenance.cu",
             "src/repro/kernels/kde.py:50", kde.kde_success_prob,
             ref.kde_success_prob, None, k_args, {}, k_bytes, 0, 200)):
        ms = cuda_ms(lambda: kern(*args, **kwargs), iters)
        plain_ms = cuda_ms(lambda: plain(*args, **kwargs), max(iters // 10, 3))
        library_ms = None if library is None else cuda_ms(library, iters)
        bytes_ms = by / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / BF16_FLOP_PER_S * 1e3
        rows_out.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name], max_abs_err=errs[name], ms=ms,
            plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            library_ms=library_ms))
        extra = {"flops_chunk256": s_flops_256} if name == "ssd" else {}
        emit(phase="times", bytes=by, flops=ops, **extra, **rows_out[-1])
    return rows_out


def profiled(fn, name: str, trace_dir: Path, **fields) -> None:
    """Run ``fn`` once under torch.profiler and emit the device time by
    kernel name and the busy share of the wall time. The busy time sums
    the device-side events only (an op's device time repeats its
    kernels')."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    dev_us = sum(e.self_device_time_total for e in kernels)
    ops = sorted((e for e in events if e.device_type == DeviceType.CPU
                  and e.key.startswith("aten::")), key=lambda e: -e.count)
    emit(phase="profile", path=name, wall_s=wall, device_busy_us=dev_us,
         device_busy_share=dev_us / (wall * 1e6),
         kernel_launches=sum(e.count for e in kernels),
         top_kernels=[dict(name=e.key[:60], us=e.self_device_time_total,
                           calls=e.count) for e in kernels[:8]],
         top_ops=[dict(name=e.key, calls=e.count) for e in ops[:8]],
         **fields)
    trace_dir.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace_dir / f"{name}_trace.json"))


def phase_profile(dev, trace_dir: Path) -> None:
    """Profiler breakdowns: 20 fleet steps; one prefill and one decode
    call of each serving cell's model (qwen3-4b, then mamba2-1.3b; batch
    4, prompt 1000)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.continuum import run_sim_stream
    from repro_torch.models import build_model
    cfg, rtt = fleet_inputs(dev, 2.0)
    run_sim_stream("qedgeproxy", rtt, cfg, 7, device=dev)      # warm
    profiled(lambda: run_sim_stream("qedgeproxy", rtt, cfg, 7, device=dev),
             "fleet", trace_dir, steps=cfg.num_steps)

    B, S, steps = SERVE["batch"], SERVE["prompt_len"], SERVE["decode_steps"]
    for arch, tag in (("qwen3-4b", ""), ("mamba2-1.3b", "ssm_")):
        mcfg = get_config(arch)
        model = build_model(mcfg, device=dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        tokens = torch.randint(0, mcfg.vocab_size, (B, S), generator=gen,
                               device=dev)
        token = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        _, cache = model.prefill({"tokens": tokens}, max_len=S + steps)  # warm
        model.decode(cache, {"token": token, "pos": S})
        profiled(lambda: model.prefill({"tokens": tokens}, max_len=S + steps),
                 f"{tag}prefill", trace_dir, arch=arch, batch=B, prompt=S)
        profiled(lambda: model.decode(cache, {"token": token, "pos": S + 1}),
                 f"{tag}decode", trace_dir, arch=arch, batch=B,
                 cache_slots=S + steps)
        del model, cache


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR", type=Path,
                    help="add torch.profiler breakdowns of fleet steps and of "
                         "a prefill and decode call of each served model, and "
                         "write their Chrome traces to DIR/{fleet,prefill,"
                         "decode,ssm_prefill,ssm_decode}_trace.json")
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
    from repro_torch.kernels import decode_attention, flash_attention, ssd
    errs = phase_kernels(dev)
    phase_testbed(dev)
    launches = phase_fleet(dev)
    served = phase_serve(dev, "serve", "qwen3-4b",
                         (flash_attention.flash_attention,),
                         (decode_attention.decode_attention,))
    phase_decode_graph(dev, "mamba2-1.3b")
    served_ssm = phase_serve(dev, "serve_ssm", "mamba2-1.3b", (ssd.ssd,), ())
    # each kernel's launches on its main path: the simulator kernels in the
    # fleet run, the serving kernels in their serve runs; the KDE kernel,
    # which no path calls, summed over all three runs
    for run in (served, served_ssm):
        launches.update({k: n for k, n in run["launches"].items()
                         if k not in launches})
        launches["kde_success_prob"] += run["launches"]["kde_success_prob"]
    kernels = phase_times(dev, launches, errs)
    times = {row["name"]: row["ms"] for row in kernels}
    # kernel time x launches per call over the serve run's median call
    emit(phase="serve_shares",
         flash_share_of_prefill=served["layers"] * times["flash_attention"]
         / served["prefill_ms"],
         decode_share_of_decode=served["layers"] * times["decode_attention"]
         / served["decode_ms"],
         ssd_share_of_prefill=served_ssm["layers"] * times["ssd"]
         / served_ssm["prefill_ms"],
         maintenance_launches_in_serve=served["launches"]["fused_maintenance"],
         maintenance_launches_in_serve_ssm=served_ssm["launches"][
             "fused_maintenance"])
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
