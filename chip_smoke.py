#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA card and check its kernels.

    python3 chip_smoke.py                       # the check: one card, minutes
    python3 chip_smoke.py --profile build/prof  # also profiler breakdowns

Phases, one JSON line each; any failure exits non-zero:

1. device    -- the card (``nvidia-smi`` name and power limit).
2. build     -- every ``src/repro_torch/kernels/csrc/*.cu`` for sm_90a;
                each kernel's registers, spills and stack frame; a kernel
                of ``NO_SPILL`` that spills fails.
3. kernels   -- each CUDA kernel against its plain PyTorch version on the
                card, at the main paths' shapes and at small ones; the
                round kernel also at K past a wave of resident warps, M
                above 64 and one arm taking every request, each case with
                its inputs unchanged and a second call bit-identical, and
                a fleet-shape call replayed from a CUDA graph; the two
                maintenance kernels also on rows that select at ties and
                signed zeros, with none or one sample, R from 1 to past
                1024.
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
7. decode_graph -- each served model's decode step replayed as a CUDA
                graph (qwen3-4b before ``serve``, mamba2-1.3b before
                ``serve_ssm``) against the same step run eagerly, two
                microbatches in turn: logits and caches exactly equal, the
                kernel launches counted through the replays; and the device
                time of a replayed decode call.
   serve_ssm -- the same cell with mamba2-1.3b at its published width: the
                SSD kernel launches once per layer per prefill, maintenance
                once per router maintenance, the same gates.
8. times     -- each kernel, its plain version, the one PyTorch call that
                computes the same function (where there is one) and its
                bound, at the main paths' shapes, by CUDA events (kernel and
                library calls queued behind a device sleep, so the host's
                enqueue rate does not enter), the maintenance kernels also
                at one row (the launch and one row's chain); then
                serve_shares: each serving kernel's time x launches over
                its serve run's median prefill / decode call, and the
                device time of a replayed dense decode call over it.
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
# (K, M, one_arm) round-step cases beyond those two: K = 5,003 (odd, a
# multiple of no block), M = 130 (above 64: five arms a lane), M = 2,000
# (rows past 48 KB of shared memory: three player warps a CTA), every
# player's weight on one arm at the fleet's shape (a round's arrivals on it
# reach K); then K past two waves of resident warps (None: computed from the
# card's occupancy), so that every warp loops over players
ROUND_CASES = ((5003, 50, False), (64, 130, False), (40, 2000, False),
               (FLEET["K"], FLEET["M"], True), (None, 50, False))

# The serving cell: qwen3-4b at its published width; a prompt of 1000 is
# not a multiple of the prefill kernel's 64-row blocks and the 1016-slot
# cache ends mid-tile in decode.
SERVE = dict(replicas=3, frontends=4, requests=30, batch=4, prompt_len=1000,
             decode_steps=16, tau=1.0, slow_replica=2)
HEADS = dict(Hq=32, Hkv=8, D=128)                  # qwen3-4b attention
# Attention against its plain version: float32 to max |kernel - plain| <=
# 1e-5 at unit-scale inputs (sums reassociated, CUDA's expf); bfloat16
# element by element, |out - plain| <= atol + rtol |plain|: rtol 2**-6 is
# two bfloat16 steps of the output's own magnitude (its own rounding and
# the plain version's may differ by one; flash's P, carried as two bf16
# terms, and the float32 logits add far less), atol 2e-3 is for outputs
# near 0
ATTN_TOL = {"float32": dict(rtol=0.0, atol=1e-5),
            "bfloat16": dict(rtol=2.0 ** -6, atol=2e-3)}
# (B, Hq, Hkv, S, D, dtype, causal, window, q_mul): the serve prefill
# first, then the same with q x 4 (peaked rows: the online softmax rescales
# at large logits); a window of 48 at D=64, non-causal with a group of 4
# at D=32, a window of 8 at D=16, each in both dtypes; D=256 with a ragged S
FLASH_CASES = ((SERVE["batch"], HEADS["Hq"], HEADS["Hkv"], SERVE["prompt_len"],
                HEADS["D"], "bfloat16", True, None, 1.0),
               (SERVE["batch"], HEADS["Hq"], HEADS["Hkv"], SERVE["prompt_len"],
                HEADS["D"], "bfloat16", True, None, 4.0),
               *((*shape, dtype, causal, window, 1.0)
                 for shape, causal, window in (((2, 4, 2, 200, 64), True, 48),
                                               ((2, 4, 1, 130, 32), False, None),
                                               ((1, 4, 4, 40, 16), False, 8))
                 for dtype in ("float32", "bfloat16")),
               (1, 2, 1, 300, 256, "bfloat16", True, None, 1.0))
# (B, Hq, Hkv, S, D, dtype, lengths): the serve decode cache first, at
# lengths 1, one split (64), one past it and the whole cache, then with a
# row of length 0 (exactly zero, where the plain version gives the mean of
# V); then small float32 caches
_C = 64                                            # decode_attention.CHUNK
DECODE_CASES = ((SERVE["batch"], HEADS["Hq"], HEADS["Hkv"],
                 SERVE["prompt_len"] + SERVE["decode_steps"], HEADS["D"],
                 "bfloat16", (1, _C, _C + 1, 1016)),
                (SERVE["batch"], HEADS["Hq"], HEADS["Hkv"],
                 SERVE["prompt_len"] + SERVE["decode_steps"], HEADS["D"],
                 "bfloat16", (0, 512, 513, 1016)),
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
SSD_WORK_TILE = 32   # rows per tile of the SSD work the bound counts
SSM = dict(H=64, P=64, N=128, chunk=256)           # mamba2-1.3b SSD
# (B, S, H, P, N, chunk, dtype, model-made inputs): the serve prefill
# first; then tests/test_kernels.py's mamba2-like case, a ragged S at the
# reduced config's widths and a ragged S with three heads; then the
# bfloat16 passes at hymba's widths (N=16, P=64) over two chunks, the last
# ragged, at the reduced widths (N=8, P=16), and at N=128, P=32 over three
# chunks with 3 heads (a head group of 8 only partly filled)
SSD_CASES = ((SERVE["batch"], SERVE["prompt_len"], SSM["H"], SSM["P"],
              SSM["N"], SSM["chunk"], "bfloat16", True),
             (1, 256, 2, 64, 128, 128, "float32", False),
             (2, 130, 4, 16, 8, 16, "float32", False),
             (1, 77, 3, 32, 16, 64, "float32", True),
             (2, 300, 4, 64, 16, 64, "bfloat16", True),
             (2, 130, 4, 16, 8, 16, "bfloat16", False),
             (1, 520, 3, 32, 128, 256, "bfloat16", False))
# (rows, R): benchmarks/footprint.py's shape, then tests/test_kernels.py's
KDE_SIZES = ((65536, 64), (300, 64))
# R of the adversarial maintenance and KDE rows: one sample (a lane a row),
# a ragged R (scalar loads), the main paths' 64 and the wrapper's largest
# (32 lanes of 8 quads); the KDE kernel also past it (segments of 128)
ADVERSARIAL_R = (1, 33, 64, 1024)
KDE_LONG_R = 1027
# kernels that must build without spilling registers: the kernels redesigned
# for Hopper
SSD_PASSES = ("ssd_cb_kernel", "ssd_state_kernel", "ssd_pass_kernel",
              "ssd_scan_kernel")
NO_SPILL = ("flash_tc_kernel", "decode_split_kernel", "decode_combine_kernel",
            *SSD_PASSES, "round_kernel", "maintenance_kernel", "kde_kernel")
# the port's CUDA kernels by name, as the profiler and ptxas report them
PORT_KERNELS = ("round_kernel", "maintenance_kernel", "kde_kernel",
                "flash_tc_kernel", "flash_f32_kernel", "decode_split_kernel",
                "decode_combine_kernel", "ssd_kernel", *SSD_PASSES)


def ptxas_report(log: str) -> list:
    """Each entry function of the build log with its registers, spill
    stores and stack frame (local memory: spills, or an array indexed by
    a value the compiler cannot fold), named from its mangled name (from
    the port's kernel name on)."""
    out, name, spill, stack = [], None, 0, 0
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            mangled = ln.split("'")[1]
            name = next((mangled[mangled.index(k):][:60] for k in PORT_KERNELS
                         if k in mangled), mangled[:60])
        elif name and "spill stores" in ln:
            spill = int(ln.split(" bytes spill stores")[0].rsplit(" ", 1)[1])
            stack = int(ln.split(" bytes stack frame")[0].split()[-1])
        elif name and "registers" in ln:
            regs = int(ln.split("Used ")[1].split(" registers")[0])
            out.append(dict(kernel=name, registers=regs, spill_stores=spill,
                            stack_frame=stack))
            name, spill, stack = None, 0, 0
    return out


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3, queued: bool = True) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls.

    ``queued``: the card first sleeps (``torch.cuda._sleep``) while the
    host enqueues every call, so a call whose host side outlasts its
    kernels is timed on the card, not on the host; the sleep doubles until
    the host finishes first. Without it (the plain versions, thousands of
    launches a call) the time is whichever of the two is slower."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for attempt in range(4):
        if queued:
            torch.cuda._sleep(1 << (26 + attempt))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        ahead = not start.query()        # the card still asleep: all queued
        end.synchronize()
        if ahead or not queued:
            return start.elapsed_time(end) / iters
    raise AssertionError(f"the host did not get {iters} calls ahead of the "
                         f"card")


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


def adversarial_maintenance_inputs(R: int, seed: int, dev):
    """Rows that select at ties (tests/test_torch_kernels.py's
    ``adversarial_maint_rows``): repeated values; -0.0 against +0.0 (lat
    -0.0 or +0.0 with rtt 0); negative latencies clamped to 0; every
    sample masked; one sample; every processing value 0; then random rows;
    and bandwidths for the KDE kernel."""
    import torch
    rng = np.random.default_rng(seed)
    f32 = np.float32
    rows = 12
    lat = rng.uniform(0.005, 0.15, (rows, R)).astype(f32)
    mask = rng.uniform(size=(rows, R)) < rng.uniform(0.2, 1.0, (rows, 1))
    rtt = rng.uniform(0.002, 0.04, rows).astype(f32)
    lat[0] = rng.choice(np.array([0.01, 0.05, 0.05, 0.07], f32), R)
    mask[0] = True
    for r in (1, 2):
        lat[r] = np.where(rng.uniform(size=R) < 0.5, f32(-0.0), f32(0.0))
        lat[r, rng.uniform(size=R) < 0.05] = f32(0.03)
        rtt[r] = f32(0.0)
    mask[1], mask[2] = True, rng.uniform(size=R) < 0.8
    lat[3, ::2] = -lat[3, ::2]
    lat[4] = f32(0.05)
    mask[5] = False
    mask[6] = False
    mask[6, rng.integers(R)] = True
    mask[7] = True
    rtt[7] = f32(0.2)
    bw = rng.uniform(1e-3, 1e-2, rows).astype(f32)
    return tuple(torch.from_numpy(a).to(dev) for a in (lat, mask, rtt, bw))


def round_inputs(K: int, M: int, C: int, R: int, Rq: int, seed: int, dev,
                 one_arm: bool = False):
    """A mid-run round-step state: some arms cooling down and out of the
    pool, some instances inactive, error counters near the threshold,
    queues deep enough that latencies straddle tau. ``one_arm``: every
    player's weight on arm 1, in its pool, and every player issues C
    requests, so each round's arrivals on that arm reach K (the queue then
    outgrows tau and the players trip to their fallback weights); every
    other row starts with zero credits, so after a trip its credits tie
    across the pool and the pick goes to the lowest arm."""
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
    if one_arm:
        active[1] = in_pool[:, 1] = True
        w = np.zeros((K, M), f32)
        w[:, 1] = 1.0
        nc[:] = C
        cw[::2] = 0.0
    z = np.exp(0.25 * rng.standard_normal((C, K))).astype(f32)
    rtt = rng.uniform(0.002, 0.045, (K, M)).astype(f32)
    s_m = np.full(M, 0.0055, f32)
    served = (f32(0.1) / (f32(C) * s_m)).astype(f32)
    arrays = (w, cw, err, cooldown, in_pool, active, lat_buf, ts_buf, ptr,
              r_buf, rts_buf, rptr, q, nc, z, rtt, s_m, served)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in arrays) + (float(t),)


def attention_inputs(B: int, Hq: int, Hkv: int, S: int, D: int, dtype: str,
                     seed: int, dev, q_mul: float = 1.0):
    """Prefill q (B,Hq,S,D) of scale ``q_mul``, unit-scale k and v
    (B,Hkv,S,D), drawn on the card from a seeded generator."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device=dev)
               for shape in ((B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D)))
    return tuple(t.to(getattr(torch, dtype)) for t in (q * q_mul, k, v))


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
    from repro_torch.kernels import kde, ref
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
    check_adversarial_rows(dev)

    errs["round_step_swrr"] = check_round(dev)
    from repro_torch.kernels import decode_attention, flash_attention
    for seed, case in enumerate(FLASH_CASES, 10):
        B, Hq, Hkv, S, D, dtype, causal, window, q_mul = case
        q, k, v = attention_inputs(B, Hq, Hkv, S, D, dtype, seed, dev, q_mul)
        out = flash_attention.flash_attention(q, k, v, causal=causal,
                                              window=window)
        plain = ref.attention(q, k, v, causal=causal, window=window)
        res = check_close(f"flash_attention {case}", out, plain, dtype)
        errs.setdefault("flash_attention", res["max_abs_err"])
        emit(phase="kernels", kernel="flash_attention", B=B, Hq=Hq, Hkv=Hkv,
             S=S, D=D, dtype=dtype, causal=causal, window=window, q_mul=q_mul,
             **res, **ATTN_TOL[dtype])
    for seed, case in enumerate(DECODE_CASES, 20):
        B, Hq, Hkv, S, D, dtype, lengths = case
        q, k, v, length = decode_inputs(B, Hq, Hkv, S, D, dtype, lengths,
                                        seed, dev)
        out = decode_attention.decode_attention(q, k, v, length)
        plain = ref.decode_attention(q, k, v, length)
        live = length > 0
        res = check_close(f"decode_attention {case}", out[live], plain[live],
                          dtype)
        if not bool((out[~live] == 0).all()):
            raise AssertionError(f"decode_attention {case}: a row of length 0 "
                                 f"is not exactly zero")
        errs.setdefault("decode_attention", res["max_abs_err"])
        emit(phase="kernels", kernel="decode_attention", B=B, Hq=Hq,
             Hkv=Hkv, S=S, D=D, dtype=dtype, lengths=list(lengths),
             zero_rows_exact=int((~live).sum()), **res, **ATTN_TOL[dtype])

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


def check_adversarial_rows(dev) -> None:
    """Both maintenance kernels on rows that select at ties and at signed
    zeros, with one sample, none, and R from 1 to past 1024: q equal to the
    plain version's (-0.0 == 0.0: the plain version's sort leaves the order
    of equal zeros undefined), mu within ``MAINT_TOL``, the KDE kernel
    within ``KDE_TOL``."""
    import torch
    from repro_torch.kernels import kde, ref
    for R in (*ADVERSARIAL_R, KDE_LONG_R):
        lat, mask, rtt, bw = adversarial_maintenance_inputs(R, 60 + R, dev)
        fields = dict(lanes_chunks=list(kde.row_geometry(min(R, 1024))))
        if R <= 1024:
            mu, q = kde.fused_maintenance(lat, mask, rtt, 0.08, 0.9)
            mu_p, q_p = ref.bandit_maintenance_stats(lat, mask, rtt, 0.08, 0.9)
            torch.cuda.synchronize()
            if not torch.equal(q, q_p):
                bad = (q != q_p).nonzero()[:5].flatten().tolist()
                raise AssertionError(f"maintenance q differs at R={R}, rows "
                                     f"{bad}")
            err = (mu - mu_p).abs().max().item()
            if not err <= MAINT_TOL:
                raise AssertionError(f"maintenance mu error {err} > "
                                     f"{MAINT_TOL} at R={R}")
            fields.update(q_exact=True, mu_max_abs_err=err,
                          zero_q_rows=int((q == 0).sum()))
        out = kde.kde_success_prob(lat, mask, 0.08, bw)
        plain = ref.kde_success_prob(lat, mask, 0.08, bw)
        torch.cuda.synchronize()
        kde_err = (out - plain).abs().max().item()
        if not torch.allclose(out, plain, **KDE_TOL):
            raise AssertionError(f"kde_success_prob at R={R}: max abs error "
                                 f"{kde_err}, tol {KDE_TOL}")
        emit(phase="kernels", kernel="maintenance_adversarial", R=R,
             rows=lat.shape[0], kde_max_abs_err=kde_err, **fields)


def same_bits(a, b) -> bool:
    """Bit for bit: same dtype, shape and bytes (so -0.0 != 0.0 and a NaN
    equals itself)."""
    import torch
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).view(torch.uint8),
                            b.reshape(-1).view(torch.uint8)))


def round_registers() -> int | None:
    """``round_kernel``'s registers as ptxas reported them at the build."""
    from repro_torch.kernels import _build
    log = (_build.BUILD_DIR / "build.log").read_text()
    return next((k["registers"] for k in ptxas_report(log)
                 if k["kernel"].startswith("round_kernel")), None)


def round_launch_fields(K: int, M: int, C: int, dev) -> dict:
    """The round kernel's launch for K x M x C, as the kernels and times
    lines report it."""
    from repro_torch.kernels import round_fused
    return dict(**round_fused.geometry(K, M, C, dev),
                registers=round_registers(),
                cuda_launches_per_call=round_fused.LAUNCHES_PER_CALL)


def check_round(dev) -> float:
    """``round_step_swrr`` against its plain version, every output exact
    (``ROUND_RTOL``), at the fleet's and the testbed's shapes and
    ``ROUND_CASES``; for each, the inputs unchanged after the call and a
    second call bit-identical to the first (a missing barrier or fence
    between CTAs shows as outputs that move between calls); then a
    fleet-shape call captured in a CUDA graph, whose replay must equal the
    eager call bit for bit. Returns the largest float error."""
    import torch
    from repro_torch.kernels import ref, round_fused
    names = ref.RoundStepOut._fields
    kw = dict(tau=0.08, err_thresh=5, cooldown=10.0)
    geo = round_fused.geometry(1, 50, 8, dev)
    wave = (geo["resident_ctas_per_sm"] * geo["sms"]
            * geo["player_warps_per_cta"])
    cases = [(K, M, False) for _, K, M in KERNEL_SIZES]
    cases += [(2 * wave + 3 if K is None else K, M, one)
              for K, M, one in ROUND_CASES]
    worst, looped = 0.0, False
    for seed, (K, M, one_arm) in enumerate(cases, 3):
        args = round_inputs(K, M, 8, 64, 512, seed, dev, one_arm)
        before = [x.clone() for x in args[:-1]]
        out = round_fused.round_step_swrr(*args, **kw)
        plain = ref.round_step_swrr(*args, **kw)
        again = round_fused.round_step_swrr(*args, **kw)
        torch.cuda.synchronize()
        case = f"K={K}, M={M}, one_arm={one_arm}"
        err = 0.0
        for name, a, b in zip(names, out, plain):
            if a.dtype.is_floating_point:
                err = max(err, (a - b).abs().max().item())
                ok = torch.allclose(a, b, rtol=ROUND_RTOL, atol=0.0)
            else:
                ok = torch.equal(a, b.to(a.dtype))
            if not ok:
                raise AssertionError(f"round_step_swrr {name} differs ({case})")
        moved = [i for i, (a, b) in enumerate(zip(args, before))
                 if not same_bits(a, b)]
        if moved:
            raise AssertionError(f"round_step_swrr changed its inputs {moved} "
                                 f"({case})")
        unstable = [n for n, a, b in zip(names, out, again)
                    if not same_bits(a, b)]
        if unstable:
            raise AssertionError(f"round_step_swrr: a second call differs in "
                                 f"{unstable} ({case})")
        worst = max(worst, err)
        fields = round_launch_fields(K, M, 8, dev)
        looped |= fields["players_per_warp"] > 1
        emit(phase="kernels", kernel="round_step_swrr", K=K, M=M, C=8, R=64,
             Rq=512, one_arm=one_arm, exact=True, max_abs_err=err,
             inputs_unchanged=True, repeat_identical=True,
             trips=int((args[3] != out.cooldown_until).sum()),
             max_round_arrivals=out.arrivals.max().item(), **fields)
        del args, before, out, plain, again
    if not looped:
        raise AssertionError("no round case had a warp loop over players")

    K, M = FLEET["K"], FLEET["M"]
    args = round_inputs(K, M, 8, 64, 512, 9, dev)
    eager = round_fused.round_step_swrr(*args, **kw)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        round_fused.round_step_swrr(*args, **kw)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        captured = round_fused.round_step_swrr(*args, **kw)
    graph.replay()
    torch.cuda.synchronize()
    differs = [n for n, a, b in zip(names, eager, captured)
               if not same_bits(a, b)]
    emit(phase="kernels", kernel="round_step_swrr", K=K, M=M,
         graph_replay_identical=not differs)
    if differs:
        raise AssertionError(f"round_step_swrr graph replay differs from the "
                             f"eager call in {differs}")
    return worst


def check_close(name: str, out, plain, dtype: str) -> dict:
    """Element by element, |out - plain| <= atol + rtol |plain| with
    ``ATTN_TOL[dtype]``; raises past it (NaN included) or on a shape or
    dtype that differs. Returns the max abs error and the worst element's
    share of its allowance."""
    import torch
    torch.cuda.synchronize()
    if out.shape != plain.shape or out.dtype != plain.dtype:
        raise AssertionError(f"{name}: {out.shape} {out.dtype} != plain "
                             f"{plain.shape} {plain.dtype}")
    tol = ATTN_TOL[dtype]
    diff = (out.float() - plain.float()).abs()
    used = (diff / (tol["atol"] + tol["rtol"] * plain.float().abs())).max()
    res = dict(max_abs_err=diff.max().item(), allowance_used=used.item(),
               out_max_abs=plain.float().abs().max().item())
    if not res["allowance_used"] <= 1.0:
        raise AssertionError(f"{name}: {res} against {tol}")
    return res


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


def phase_decode_graph(dev, arch: str, steps: int = 4) -> float:
    """The decode step replayed as a CUDA graph against the same step run
    eagerly, at the serve cell's batch, prompt and cache slots: two
    microbatches decode in turn (A0 A1 B0 B1 A2 B2 ...), so the graph
    copies a cache in when the other one was its last and replays on the
    one it holds otherwise. Both modes run the same kernels on the same
    inputs, so logits and caches must agree exactly, and the kernel
    wrappers' counts must read one launch per layer per decode call in
    both. Times a replayed call on the card (queued, ``cuda_ms``) and on
    the host's clock (each call synchronised, as the serving engine times
    it). Returns the device time of one replayed decode call (ms)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SSM as SSM_FAMILY
    from repro_torch.kernels import decode_attention
    from repro_torch.models import build_model
    cfg = get_config(arch)
    model = build_model(cfg, device=dev)
    B, S = SERVE["batch"], SERVE["prompt_len"]
    slots = S + SERVE["decode_steps"]
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = [torch.randint(0, cfg.vocab_size, (B, S + steps), generator=gen,
                            device=dev) for _ in range(2)]
    caches = [model.prefill({"tokens": t[:, :S]}, max_len=slots)[1]
              for t in tokens]
    order = [(m, j) for i in range(0, steps, 2) for m in (0, 1)
             for j in (i, i + 1) if j < steps]
    per_call = cfg.num_layers if cfg.family != SSM_FAMILY else 0
    results = {}
    for mode in (False, True):
        model.decode_graphs = mode
        for fn in all_kernels():
            fn.launches = 0
        cs = [{"layers": tuple(t.clone() for t in c["layers"])}
              for c in caches]
        out = [[], []]
        for m, i in order:
            tok = tokens[m][:, S + i:S + i + 1].to(torch.int32)
            logits, cs[m] = model.decode(cs[m], {"token": tok, "pos": S + i})
            out[m].append(logits)
        torch.cuda.synchronize()
        launched = decode_attention.decode_attention.launches
        if launched != per_call * len(order):
            raise AssertionError(f"decode_attention counted {launched} "
                                 f"launches in {len(order)} decode calls "
                                 f"(graphs {mode}), the path needs "
                                 f"{per_call * len(order)}")
        results[mode] = [torch.stack(o) for o in out] + [
            t for c in cs for t in c["layers"]]
    errs = [(a.float() - b.float()).abs().max().item()
            for a, b in zip(results[False], results[True])]
    names = ("logits_a", "logits_b",
             *(f"{t}_{m}" for m in "ab" for t in (
                 ("k_cache", "v_cache") if per_call else
                 ("conv_state", "ssm_state"))))
    token = tokens[0][:, :1].to(torch.int32)
    c = cs[0]
    call = lambda: model.decode(c, {"token": token, "pos": S + steps})
    graph_ms = cuda_ms(call, 10)
    host_ms = []
    for _ in range(10):                  # as the serving engine times a call
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
    emit(phase="decode_graph", arch=arch, batch=B, prompt=S, cache_slots=slots,
         steps=steps, calls=order, graphs=len(model._graphs),
         decode_attention_launches=launched,
         max_abs_err=dict(zip(names, errs)), graph_call_device_ms=graph_ms,
         graph_call_host_ms_median=float(np.median(host_ms)),
         graph_call_device_share=graph_ms / float(np.median(host_ms)))
    if not all(e == 0.0 for e in errs):
        raise AssertionError(f"graph decode differs from eager: "
                             f"{dict(zip(names, errs))}")
    del model, caches, results, cs, c
    return graph_ms


def all_kernels() -> tuple:
    """Every kernel wrapper of the port (each carries ``launches``)."""
    from repro_torch.kernels import ops
    return ops.WRAPPERS


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

    B, Hq, Hkv, S, D, dtype, _, _, _ = FLASH_CASES[0]
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
    # the work, whatever implements it: the chunked algorithm at 32-row
    # tiles, per tile and head the scores (2T^2 N), the intra term
    # (2T^2 P), C.h and the state update (2TNP each); bytes bound it. The
    # TPU kernel's chunk of 256 needs ~3x as many, and the tensor-core
    # passes issue their own count (padding and split terms included)
    s_flops = B * H * -(-S // SSD_WORK_TILE) * (
        2 * SSD_WORK_TILE * SSD_WORK_TILE * (N + P)
        + 4 * SSD_WORK_TILE * N * P)
    s_flops_256 = B * H * -(-S // chunk) * (2 * chunk * chunk * (N + P)
                                           + 4 * chunk * N * P)
    s_mma_flops = ssd._mma_flops(B, S, H, N, P)
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
        plain_ms = cuda_ms(lambda: plain(*args, **kwargs), max(iters // 10, 3),
                           queued=False)
        library_ms = None if library is None else cuda_ms(library, iters)
        bytes_ms = by / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / BF16_FLOP_PER_S * 1e3
        rows_out.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name], max_abs_err=errs[name], ms=ms,
            plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            library_ms=library_ms))
        if name in ("fused_maintenance", "kde_success_prob"):
            # one row: the launch and one row's chain
            one = [a[:1] if isinstance(a, torch.Tensor) else a for a in args]
            extra = dict(ms_1row=cuda_ms(lambda: kern(*one), iters))
        else:
            extra = ({"flops_chunk256": s_flops_256,
                      "flops_tensor_core_passes": s_mma_flops,
                      "cuda_launches_per_call": ssd.LAUNCHES_PER_CALL[
                          s_args[0].dtype]} if name == "ssd" else
                     round_launch_fields(K, M, C, dev)
                     if name == "round_step_swrr" else {})
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
         port_kernels=[dict(name=e.key[:60], us=e.self_device_time_total,
                            calls=e.count) for e in kernels
                       if any(k in e.key for k in PORT_KERNELS)],
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
    ptxas = ptxas_report((_build.BUILD_DIR / "build.log").read_text())
    emit(phase="build", seconds=build_s,
         sources=[str(s.relative_to(ROOT)) for s in _build.sources()],
         ptxas=ptxas)
    spilled = [k for k in ptxas if k["spill_stores"]
               and k["kernel"].startswith(NO_SPILL)]
    if spilled:
        raise AssertionError(f"kernels that spill registers: {spilled}")
    from repro_torch.kernels import decode_attention, flash_attention, ssd
    errs = phase_kernels(dev)
    phase_testbed(dev)
    launches = phase_fleet(dev)
    dense_graph_ms = phase_decode_graph(dev, "qwen3-4b")
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
         decode_device_share=dense_graph_ms / served["decode_ms"],
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
