#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA card and check its kernels.

    python3 chip_smoke.py                       # the check: one card, minutes
    python3 chip_smoke.py --profile build/prof  # also profiler breakdowns
    python3 chip_smoke.py --fleet-only 3 [--profile DIR]  # the fleet alone
    python3 chip_smoke.py --plant-faults         # kernels, then what
                                                 # mesh_serve's bound catches
    python3 chip_smoke.py --ssd-witness          # mamba2-1.3b's gradients
                                                 # against the plain scan's
    python3 chip_smoke.py --save-only 2          # mesh_train's save alone

Phases, one JSON line each; any failure exits non-zero:

1. device    -- the card (``nvidia-smi`` name and power limit).
2. build     -- every ``src/repro_torch/kernels/csrc/*.cu`` for sm_90a;
                each kernel's registers, spills and stack frame; a kernel
                of ``NO_SPILL`` that spills fails.
3. kernels   -- each CUDA kernel against its plain PyTorch version on the
                card, at the main paths' shapes (the decoder families'
                attention and SSD too; Whisper's encoder attention, non
                causal over 1,500 frames, its decoder's causal
                self-attention over prompts of 4 and 446, its 1,500-slot
                cross cache and 448-slot self ring, InternVL2's prefill
                over 256 patches and 1,000 tokens and its 1,272-slot
                cache, a group of 7; mesh_train's float32 attention at
                D 128 on each mesh's local heads; mesh_serve's bf16
                prefill on a rank's rows and local heads, and its decode
                on a rank's slice of the slots with the lengths clipped
                to it, 0 and a partial slice included) and at small ones;
                ``decode_attention`` also with its log-sum-exp output
                (``with_lse``) within ``LSE_TOL`` of its plain
                version's, -inf at length 0, its output bit-identical to
                the call without it (timed beside it in ``times``); the
                round kernel
                also at K past a wave of resident warps, M above 64 and
                one arm taking every request, each case with
                its inputs unchanged and a second call bit-identical, and
                a fleet-shape call replayed from a CUDA graph, and with
                a lane axis (S lanes of players, (S, M) queues: S = 3 and
                4 at the testbed's shape with a lane short of instances,
                S = 4 at the fleet's), one launch for every lane; the two
                maintenance kernels also on rows that select at ties and
                signed zeros, with none or one sample, R from 1 to past
                1024, the maintenance kernel's mu and q bit for bit
                (``MAINT_TOL``) at R 64, at every such R and at
                ``MU_ORDER_R`` (the KDE sum's orders at R 11..32, the row sums'
                windows past 32); the flash
                backward (``flash_attention_bwd``, a kernel of the port
                alone) against ``ref.attention_grads`` at ``BWD_CASES``
                (the training shape with a strided dO, gemma3's local
                window at D 256, hymba's 25/5 heads of 64 with its window
                over an S that is no multiple of the tile, two small
                float32 cases, one non causal, mesh_train's float32
                shapes at D 128, ``MESH_FLASH``, and --train-100m's
                heads of 80 in bf16 and a float32 case at D 80,
                ``TRAIN_100M_FLASH``, and hymba-1.5b's as train_ssm runs
                it, ``TRAIN_HYMBA_FLASH``, whose forwards the flash cases
                hold too), dQ, dK and dV within ``BWD_TOL`` and a second
                call bit-identical; the SSD forward also at train_ssm's
                scans (``TRAIN_SSM_SSD``); the SSD backward (``ssd_bwd``,
                a kernel of the port alone) against ``ref.ssd_grads`` at
                ``SSD_BWD_CASES`` (mamba2-1.3b's and hymba-1.5b's
                training shapes, hymba's 25 heads over an S of 300 with
                a strided dy, a small float32 case), dx, ddt, dA, dB and
                dC within ``SSD_BWD_TOL`` and a second call
                bit-identical, and ``ops.ssd`` under grad mode
                (``SSDScan``) giving the kernels' own bits at the
                training shapes and the small case;
                ``ops.decode_attention``, which has
                no backward, refusing an input that requires grad.
4. testbed   -- ``run_sim_stream("qedgeproxy")`` at the paper's 30x10
                testbed for 180 s; at least 90% of clients must reach rho.
5. fleet     -- the K=1000 x M=50 anchor cell for 300 steps; both
                simulator kernels must launch once per step.
   lifecycle_fleet -- the same fleet for 150 steps, the last 10 of its
                50 instances the controller's standby pool: (a) under
                the control plane (autoscaler and admission), on the
                fused round (round kernel and maintenance once a step)
                and on the round scan, every accumulator field, series
                value and control counter equal; (b) also on the
                bounded request lifecycle (timeout 55 ms, <= 2 retries,
                breakers; maintenance once a step, the round kernel
                never); (c) run (b) in 50-step chunks, stopped at step
                100 into a checkpoint and resumed, equal to (b). Steps/s
                beside the neutral fleet's, peak device memory.
   recorder  -- the flight recorder and the obs layer: (a) the anchor
                fleet, 300 steps, with ``RecorderConfig(capacity=1024)``
                against the same run without it, in interleaved pairs
                (off, on, off, on): every accumulator field and series
                value equal, the round kernel and maintenance once a
                step, the events appended and dropped, peak memory and
                steps/s, the median on/off ratio (printed, not gated);
                (b) one ``record_step`` at the fleet's shapes (breakers,
                retry drops, sheds, control deltas) under
                ``torch.cuda.set_sync_debug_mode("error")``: no host
                sync, and the ring equal to the same call on the CPU;
                (c) ``python -m repro_torch.obs smoke --horizon 30`` on
                the card (the request lifecycle at 30x10: maintenance
                once a step, the round kernel never): the kinds
                recorded, the run directory's validation, the mark and
                trace replays; (d) two library scenarios as the lanes of
                one 100-step ``run_sim_grid`` at 30x10 with the recorder
                on: each lane's ring equal to its run alone bit for bit.
                The phase's seconds (budget 90 s).
6. baselines -- the 30x10 testbed for 50 steps from key 7, fused round
                against the round scan: ``qedgeproxy`` (the round kernel
                against the torch scan; maintenance once per step in
                both, the round kernel 50 times and 0 times) and
                ``proxy_mity`` at alpha 0.9 (``ops.round_step_gumbel``
                against the scan); every accumulator field and series
                value exactly equal.
7. suite     -- ``repro_torch.bench.figures.get_suite``: the paper's four
                strategies on the 30x10 testbed, seeds 1-2 as the lanes
                of one run per strategy, 30 s with a 10 s warm-up; each
                strategy's seconds, grid steps/s and launches, the Fig 3,
                4, 5 and 8 headline numbers; every lane conserves
                requests, qedgeproxy reaches 90% clients >= rho in each
                seed and beats every baseline's mean (strictly both
                proxy-mity means), the simulator kernels launch once per
                step for its lanes and never for the baselines'.
   lanes     -- ``run_sim_grid("qedgeproxy")``: four library scenarios
                (a cascade of failures with a restore, a surge, a
                partition, an RTT drift), each with its own topology and
                key, as the four lanes of one 300-step run at 30x10;
                every lane equals its run alone bit for bit, and the
                round kernel and maintenance launch once per step for
                all lanes.
   scenarios -- ``repro_torch.bench.scenarios``: the whole scenario
                library as the lanes of one run per strategy
                (``qedgeproxy``, ``proxy_mity_1.0``), 30 s; each
                scenario's row (clients >= rho, Jain, events, worst dip,
                slowest recovery) and each strategy's grid steps/s.
   events    -- Figs 10-11 (``repro_torch.bench.figures``): the client
                surge and the instance removal as the two lanes of one
                run per strategy, all four, 30 s; ``qedgeproxy``'s
                post-event steady QoS >= 0.95 in both.
   degradation -- ``bench.scenarios``' graceful-degradation lane: the
                smoke probe (``retry_storm``) under the five request-
                lifecycle policies at tau = 150 ms, 30 s; ``bounded``'s
                worst dip >= ``neutral``'s, ``naive``'s retry rate >=
                ``bounded``'s, every readout finite and every cell's keys
                the reference payload's.
   closed_loop -- the closed-loop lane: the smoke probes on the 30 x
                (10 + 4) fleet under the eight control policies, 10 s;
                ``prewarmed`` drops <= 1 % and >= 90 % clients reach rho
                in each probe, ``static`` drops more; readouts finite,
                keys the reference payload's (but ``max_recovery_s``,
                which depends on a recovery inside the horizon).
   multi_tenant -- the suite's multi-tenant lane (4 tenants sharing the
                30x10 fleet, taus 80/110/110/150 ms, interference 0.3):
                (a) the tenant library's four scenarios as the four lanes
                of one 24 s run per policy (``qedgeproxy``,
                ``proxy_mity_1.0``): ``tenant_requests`` of
                ``mt_baseline`` and ``mt_tenant_surge`` equal the
                reference's, ``qedgeproxy`` >= 90 % clients >= rho in
                every ``mt_baseline`` tenant and above ``proxy_mity``'s,
                ``jain_load`` 1.0 in ``mt_baseline``, maintenance 4 times
                a step for all lanes and the round kernel never; (b)
                ``mt_tenant_surge`` alone for 60 steps equal to its lane
                of the 4-lane run at that horizon, and both smoke
                scenarios under ``qedgeproxy`` alone for 3 s on the card
                equal to the same runs on the CPU (final queues, every
                tenant's accumulator, series, ``tenant_cell``), where
                the CPU port equals the JAX package; (c) that run in
                25-step chunks, and stopped at step 50 into a checkpoint
                and resumed, equal to it. Each policy's grid steps/s,
                peak memory; the phase's seconds (budget 120 s). Also
                reported, not gated (``multi_tenant_lanes_card_vs_cpu``):
                (a)'s ``qedgeproxy`` run on the card against the same
                24 s run on the CPU (computed meanwhile by a process of
                its own), lane by lane and field by field as in (b) (the
                oracle's fields within ``oracle_bound``), with the first
                field that parts, if one does.
   players   -- player sharding and the sharded grid, two ranks of a gloo
                process group on the one card (``launch.mesh.spawn``):
                (a) the K=1000 x M=50 anchor fleet under ``qedgeproxy``
                for 100 steps on a 2-rank players mesh
                (``run_sim_players``) against the same run unsharded on
                the card: every count and per-player field exactly
                equal, the regret series within 1e-4; maintenance once a
                step on each rank, the round kernel never (a sharded
                step runs the round scan); steps/s and each rank's peak
                memory above its baseline; (b) the lanes phase's four
                library scenarios at 30x10 for 100 steps on a 2 data x 1
                players mesh (``run_sim_grid(mesh=)``, two lanes a rank,
                each simulator kernel once a step on each rank): every
                lane equal to the same lane unsharded bit for bit. Each
                rank runs both for 5 steps first (the same shapes), and
                counts its all-reduces in the timed runs; then one
                round's (1, M) all-reduce alone, 200 times, gives the
                collective's ms a call and its share of the sharded
                run. The phase's seconds (budget 60 s).
8. serve     -- ``repro_torch.launch.serve`` with qwen3-4b at its
                published width behind the QEdgeProxy router (3 replicas,
                one slow); every request answers with finite logits, the
                attention kernels launch once per layer per prefill /
                decode call, maintenance once per router maintenance, and
                every front-end weighs the slow replica below each fast one.
9. decode_graph -- each served model's decode step replayed as a CUDA
                graph (qwen3-4b before ``serve``, mamba2-1.3b before
                ``serve_ssm``) against the same step run eagerly, two
                microbatches in turn: logits and caches exactly equal, the
                kernel launches counted through the replays; and the device
                time of a replayed decode call (null where the host cannot
                enqueue ahead of the card).
   serve_ssm -- the same cell with mamba2-1.3b at its published width: the
                SSD kernel launches once per layer per prefill, maintenance
                once per router maintenance, the same gates.
   families  -- the hybrid, gemma3 local/global and MoE decoders at their
                published widths (hymba-1.5b, gemma3-1b, qwen3-moe-30b-a3b;
                random weights from seed 0), one at a time: (a) served as
                in ``serve`` but 5 rounds (``families_serve``): finite
                logits, every request counted, ``flash_attention`` and
                ``decode_attention`` once per layer per prefill and decode
                call, ``ssd`` once per layer per prefill (hymba),
                maintenance once per router maintenance; (b)
                ``decode_graph`` past the window (hymba at a prompt of
                1,100 > its 1,024-slot ring, gemma3 at 1,000 > its 512);
                (c) a MoE decode call, eager and replayed, under
                ``torch.cuda.set_sync_debug_mode("error")``. Then
                qwen3-moe-235b-a22b reduced (its bf16 experts, ~454 GB,
                fit on no one card): ``decode_graph``'s two microbatches
                of four decode calls each, equal to eager. The phase's
                seconds.
   audio_vlm -- whisper-tiny and internvl2-1b at their published widths
                (random weights from seed 0), one at a time, freed
                between: (a) served as in ``families`` (``audio_vlm_serve``;
                the launcher sends Whisper 1,500 encoder frames beside a
                4-token decoder prompt, InternVL2 256 patch embeddings
                before a 1,000-token prompt): finite logits, every request
                counted, maintenance once per router maintenance,
                ``flash_attention`` once per encoder layer and decoder
                self-attention per Whisper prefill (8; its cross-attention
                of 4 queries over 1,500 frames is plain PyTorch) and once
                per layer per InternVL2 prefill (24), ``decode_attention``
                twice per Whisper decoder layer per decode call (self ring
                and cross cache: 8) and once per InternVL2 layer (24); (b)
                ``decode_graph`` against eager, exactly: Whisper at prompts
                of 4 and 446 (decode crosses the 448-position cap: the self
                ring wraps, the positional row clamps; the cross cache is
                read, never copied back), InternVL2 at 1,000. Prefill and
                decode ms, decode tokens/s, peak memory, the phase's
                seconds.
   train     -- ``repro_torch.launch.train`` with qwen3-4b at its published
                width (36 layers, d_model 2,560, 32/8 heads of 128, vocab
                151,936, bf16; random weights from seed 0) on the card:
                ``synthetic_batch`` at seq 256, batch 8, AdamW on a cosine
                schedule (3e-4, 20 warm-up steps), remat, 20 steps. Each
                loss, tokens/s, the median step, peak memory, the model
                FLOP/s (6 x parameters x tokens) as a share of 989 TFLOP/s;
                flash forward 72 and backward 36 launches a step (36
                layers: the step's forward and remat's recomputation, one
                backward), no other kernel. Gates: every loss finite, the
                last five's mean below the first, peak under the card's
                memory (budget 90 s, the model's build included).
   train_ssm -- the SSM and hybrid families and --train-100m trained on
                the card through ``launch.train`` as ``train`` runs
                qwen3-4b (``TRAIN_SSM``, ``TRAIN_100M``; random weights
                from seed 0, AdamW on the cosine schedule, remat), one at
                a time: (a) mamba2-1.3b at its published width and depth
                (48 layers, d_model 2,048, 64 SSD heads of 64, N 128,
                bf16), ``ssd`` 96 and ``ssd_bwd`` 48 launches a step and
                no other kernel; (b) hymba-1.5b at its published width and
                depth (32 layers), ``ssd`` and flash 64 a step, their
                backwards 32; (c) --train-100m (8 layers of 8/4 heads of
                80) at seq 512 x batch 8, flash 16 and its backward 8 a
                step at D 80. Each run's gates and readings as ``train``'s
                (every loss finite, the mean of the last five below the
                first); the phase's seconds (budget 60 s).
   mesh_train -- sharded training on ranks of the one card (gloo,
                ``launch.mesh.spawn``): qwen3-4b at its published width
                cut to 2 layers, float32 (TF32 off), seq 256 x batch 8,
                ``adamw(1e-3, clip_norm=1.0)``, remat. (a) 3 steps on a
                (data 2, model 2) mesh of 4 ranks (``Model.shard``: the
                batch and the FSDP rows over data, heads, FFN columns and
                the vocabulary over model) against the same 3 steps on
                one rank: losses within ``MESH_TRAIN``'s rtol and atol,
                flash forward 2 and backward 1 launches a layer a step on
                every rank. (b) Rank 0 saves after step 3 (the state
                gathered whole); the last data row is lost, the two
                survivors form a process group of their own, restore onto
                the (1, 2) mesh (``restore(..., shardings=)``) and take 2
                steps, finite and equal to one rank resumed from the same
                checkpoint; ``QEdgeRouter.mesh_resized(1)`` masks replica
                1 of 2. Steps/s of each run, each rank's collectives a
                step and their share of the step (host time inside them,
                the device synchronised first), peak memory, the
                phase's seconds (budget 60 s).
   mesh_serve -- sharded serving, in the same 4 ranks after mesh_train
                frees its state (a fresh group of 4): qwen3-4b at its
                published width and depth (36 layers, bf16, seed 0).
                (a) On the (data 2, model 2) mesh under the reference
                dry run's decode rules (``hybrid``: the caches' rows over
                model, their slots over data), a microbatch of 4
                requests of 1,000 prompt tokens, then 16 decode steps;
                (b) context-parallel decode: batch 1, an 8,192-token
                prompt, the caches' slots over all 4 ranks (the
                long-context rules), 8 steps. Each against one rank on
                the card (the same weights, the same fed tokens): every
                call's logits within ``MESH_SERVE``'s bound of one
                rank's and their greedy tokens agreeing at its share;
                flash once a layer a prefill and decode once a layer a
                step on every rank, no other kernel. (c) One dry-run
                cell (``launch.dryrun.run_cell``, qwen3-4b x decode_32k
                x pod16x16 on a fake process group) and its roofline
                terms. Each call's seconds, each rank's collectives a
                step with their share, peak memory a rank, the phase's
                seconds (budget 60 s).
10. times    -- each kernel, its plain version, the one PyTorch call that
                computes the same function (where there is one) and its
                bound, at the main paths' shapes (``times``; the flash
                backward at the training shape beside SDPA's backward
                through ``torch.autograd.grad``, its bound 2.5 x the
                forward's operations; ``ssd_bwd`` at mamba2-1.3b's
                training shape, no library call) and at the
                families', Whisper's and InternVL2's (``times_families``),
                and at train_ssm's other shapes (``times_train``:
                ``ssd_bwd`` at hymba's heads, flash and its backward at D
                80 beside SDPA and SDPA's backward),
                by CUDA events (kernel and
                library calls queued behind a device sleep, so the host's
                enqueue rate does not enter), the maintenance kernels also
                at one row (the launch and one row's chain); then
                serve_shares: each serving kernel's time x launches over
                its serve run's median prefill / decode call, and the
                device time of a replayed dense decode call over it.
11. profile  -- with ``--profile``: torch.profiler over 20 fleet steps
                (neutral, under control, under control and the
                lifecycle), 20 steps of each suite strategy, 20 steps of
                the lanes phase's four lanes, 20 steps of the
                multi-tenant lane's four lanes a policy, one prefill
                and one decode call of each served model, whisper-tiny
                and internvl2-1b included, and one ``train`` step's
                gradients and AdamW update (``--profile-only``: these
                alone, no checks).

The last lines are the ``nvidia-smi`` line, the ``{"kernels": [...]}``
line and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import io
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# the roofs and the kernels' work formulas the dry run counts with too
from repro_torch.roofline import hw as _hw  # noqa: E402
from repro_torch.roofline.analysis import (attention_work,  # noqa: E402
                                           decode_work, kernel_bound_s,
                                           nbytes, ssd_bwd_work, ssd_work)

BF16_FLOP_PER_S = _hw.PEAK_FLOPS_BF16   # H100 SXM dense bf16 (data sheet)

# mu against its plain version: bit equality, as ROUND_RTOL holds the round
# kernel. The kernel computes mu op for op as ref.bandit_maintenance_stats
# does (the row sums in XLA:CPU's order, glibc's n ** -0.2 by table, fmath's
# erf, a correctly rounded root, IEEE divisions), so any difference is a
# fault; a mu an ULP away moves a weight, and long card runs then part from
# the CPU's (the multi-tenant lane's, at 24 s)
MAINT_TOL = 0.0
ROUND_RTOL = 0.0    # the round kernel rounds every float as its plain version
# the tenant step on the card against the CPU: the oracle's true mu (a
# normal CDF of a logarithm; a few float32 ULPs apart between the two
# devices) decides no pick, so it and the sums over it (regret, variation
# budget) may part; every other field must not
ORACLE_FIELDS = ("prev_mu", "regret_k", "vb_k", "regret")
ORACLE_MU_TOL = 1e-6
# KDE alone: tests/test_kernels.py's bound (64-term sums reassociated, erff)
KDE_TOL = dict(rtol=2e-5, atol=2e-6)

TESTBED_HORIZON = 180.0                     # s: the paper's run
FLEET = dict(K=1000, M=50, horizon=30.0)    # the anchor cell, 300 steps
BASELINES = dict(horizon=5.0, key=7, warm=10)   # fused vs scan, 50 steps
SUITE = dict(seeds=(1, 2), horizon=30.0)    # the paper suite, 300 steps
# four library scenarios as the lanes of one run, 300 steps at 30x10;
# lane i: the scenario compiled at key 500 + i, topology seed i + 1, run
# key 101 + i
LANES = dict(scenarios=("cascade_failure", "surge", "partition_heal",
                        "rtt_drift"), horizon=30.0, warm=100)
SCENARIO_HORIZON = 30.0                     # the library as lanes, 300 steps
EVENTS = dict(horizon=30.0, min_post_steady=0.95)   # Figs 10-11, 300 steps
# the anchor fleet under the request lifecycle and the control plane:
# 150 steps, the last 10 of the 50 instances the controller's standby
LIFECYCLE = dict(horizon=15.0, managed=10, chunk_steps=50, stop_at=100)
LIFECYCLE_CONTROL = dict(managed=10, warmup=1.0, up_queue=2.0, down_queue=0.5,
                         hold=0.4, action_cooldown=2.0, batch=2, admit=True,
                         target_queue=1.5)
DEGRADE_HORIZON = 30.0       # the graceful-degradation lane, 300 steps
# the closed-loop lane, 100 steps: cut from 30 s for the script's time
# limit (its gates hold at 10 s; the degradation lane's retry gate does
# not hold at 15 s, so that lane keeps 30 s)
CONTROL_HORIZON = 10.0
# the multi-tenant lane: the tenant library as 4 lanes of one 24 s run per
# policy, then mt_tenant_surge alone, chunked and resumed, at 60 steps
MULTI_TENANT = dict(horizon=24.0, alone_horizon=6.0, alone="mt_tenant_surge",
                    chunk_steps=25, stop_at=50, budget_s=120.0,
                    cpu_horizon=3.0)
# the reference lane's tenant_requests on the CPU (24 s smoke run), both
# policies: counts that the drivers alone decide
# The players phase: the anchor fleet sharded over 2 ranks for 100 steps,
# and the lanes phase's scenarios as a 2-rank grid for 100 steps, each
# after a 5-step warm-up at the same shapes.
PLAYERS = dict(ranks=2, horizon=10.0, lanes_horizon=10.0, warm_horizon=0.5,
               regret_rtol=1e-4, budget_s=60.0)
MT_REQUESTS = {"mt_baseline": [4800.0] * 4,
               "mt_tenant_surge": [8472.0, 4800.0, 4800.0, 4800.0]}
PAYLOAD = "results/benchmarks/scenario_suite.json"   # the reference's lanes
# the recorder phase: the fleet's ring, the obs smoke's horizon, two library
# scenarios as lanes (lane i compiled at key 500 + i, topology i + 1, run
# key 101 + i) for 100 steps, and the phase's budget in seconds
RECORDER = dict(capacity=1024, pairs=2, smoke_horizon=30.0,
                lanes=("cascade_failure", "surge"), lanes_horizon=10.0,
                budget_s=90.0)
# (S, K, M, lane-major fleet): the round kernel with a lane axis, the
# testbed's shape at S = 3 and 4 and the fleet's at S = 4
ROUND_LANE_CASES = ((3, 30, 10), (4, 30, 10), (4, 1000, 50))
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
# the decoder families' serve runs: the serve cell with fewer rounds (the
# script's clock)
FAMILY_REQUESTS = 2
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
# The decoder families' attention at published width, (Hq, Hkv), S, D,
# window: hymba-1.5b (a group of 5, a window of 1,024 at the decode graph's
# prompt of 1,100: the prefill masks), gemma3-1b's local and global layers
# (a group of 4 at D = 256), qwen3-moe-30b-a3b (a group of 8)
FAMILY_FLASH = (((25, 5), 1100, 64, 1024), ((4, 1), 1000, 256, 512),
                ((4, 1), 1000, 256, None), ((32, 4), 1000, 128, None))
# Whisper-tiny and InternVL2-1B at published width (the audio_vlm phase),
# each at its serve prompt and the decode graph's prompts: Whisper's decoder
# prompt is the 4 special tokens its decoding starts from; from 446 its
# decode crosses the 448-position cap (the self ring wraps, the positional
# row clamps); InternVL2's 1,000 tokens follow its 256 patches
AUDIO_VLM = {"whisper-tiny": dict(prompt_len=4, graph_prompts=(4, 446)),
             "internvl2-1b": dict(prompt_len=1000, graph_prompts=(1000,))}
# their attention, (Hq, Hkv), S, D, causal: Whisper's encoder over 1,500
# frames (MHA, bidirectional), its decoder's causal self-attention over the
# served 4-token prompt (shorter than one 64-row tile: a CTA's second
# consumer warpgroup has no rows) and the decode graph's 446, InternVL2's
# prefill over 256 patches and 1,000 tokens (a group of 7)
AV_FLASH = (((6, 6), 1500, 64, False), ((6, 6), 4, 64, True),
            ((6, 6), 446, 64, True), ((14, 2), 1256, 64, True))
# The mesh_train cell's attention (``MESH_TRAIN``: qwen3-4b's heads, seq
# 256, batch 8, float32), (B, Hq, Hkv, S, D) as a rank gets it: on the
# (data 2, model 2) mesh half the batch and half the heads, on the shrunk
# (1, 2) mesh the whole batch and half the heads, on one rank all of both
MESH_FLASH = tuple((8 // data, HEADS["Hq"] // model, HEADS["Hkv"] // model,
                    256, HEADS["D"])
                   for data, model in ((2, 2), (1, 2), (1, 1)))
# The mesh_serve cell's attention as a rank of its (data 2, model 2) mesh
# runs it (``MESH_SERVE``, bf16), (B, Hq, Hkv, S, D): the prefill on the
# rank's rows and half the heads, run (a) 2 of the 4 rows over 1,000
# tokens, run (b) its one row over 8,192
MESH_SERVE_FLASH = ((4 // 2, HEADS["Hq"] // 2, HEADS["Hkv"] // 2, 1000,
                     HEADS["D"]),
                    (1, HEADS["Hq"] // 2, HEADS["Hkv"] // 2, 8192, HEADS["D"]))
# --train-100m's attention (8/4 heads of 80) at examples/train_100m.py's
# seq 512 x batch 8, causal, bf16: head dim 80 takes flash_tc_kernel with
# five 32-byte boxes a row, and the CUDA-core backward; then a small float32
# case at D 80 (flash_f32_kernel, the CUDA-core backward). (B, Hq, Hkv, S,
# D, dtype, causal, window)
TRAIN_100M_FLASH = ((8, 8, 4, 512, 80, "bfloat16", True, None),
                    (2, 4, 2, 130, 80, "float32", True, None))
# hymba-1.5b's attention as train_ssm runs it: 25/5 heads of 64 at seq 256
# x batch 8, causal, its window of 1,024 (wider than the sequence), bf16.
# (B, Hq, Hkv, S, D, dtype, causal, window)
TRAIN_HYMBA_FLASH = (8, 25, 5, 256, 64, "bfloat16", True, 1024)
# (B, Hq, Hkv, S, D, dtype, causal, window, q_mul): the serve prefill
# first, then the same with q x 4 (peaked rows: the online softmax rescales
# at large logits); a window of 48 at D=64, non-causal with a group of 4
# at D=32, a window of 8 at D=16, each in both dtypes; D=256 with a ragged S;
# then ``FAMILY_FLASH`` and ``AV_FLASH`` at the serve cell's batch, and
# ``MESH_FLASH`` in float32 (``flash_f32_kernel`` at D 128), then
# ``MESH_SERVE_FLASH``, then ``TRAIN_100M_FLASH`` and ``TRAIN_HYMBA_FLASH``
FLASH_CASES = ((SERVE["batch"], HEADS["Hq"], HEADS["Hkv"], SERVE["prompt_len"],
                HEADS["D"], "bfloat16", True, None, 1.0),
               (SERVE["batch"], HEADS["Hq"], HEADS["Hkv"], SERVE["prompt_len"],
                HEADS["D"], "bfloat16", True, None, 4.0),
               *((*shape, dtype, causal, window, 1.0)
                 for shape, causal, window in (((2, 4, 2, 200, 64), True, 48),
                                               ((2, 4, 1, 130, 32), False, None),
                                               ((1, 4, 4, 40, 16), False, 8))
                 for dtype in ("float32", "bfloat16")),
               (1, 2, 1, 300, 256, "bfloat16", True, None, 1.0),
               *((SERVE["batch"], *heads, S, D, "bfloat16", True, window, 1.0)
                 for heads, S, D, window in FAMILY_FLASH),
               *((SERVE["batch"], *heads, S, D, "bfloat16", causal, None, 1.0)
                 for heads, S, D, causal in AV_FLASH),
               *((*shape, "float32", True, None, 1.0)
                 for shape in MESH_FLASH),
               *((*shape, "bfloat16", True, None, 1.0)
                 for shape in MESH_SERVE_FLASH),
               *((*case, 1.0) for case in (*TRAIN_100M_FLASH,
                                           TRAIN_HYMBA_FLASH)))
# decode_attention's log-sum-exp (float32 from float32 logits in both; the
# kernel sums its splits in another order and takes CUDA's expf and logf)
LSE_TOL = dict(rtol=1e-5, atol=1e-5)
_C = 64                                            # decode_attention.CHUNK
# The decoder families' decode caches, (Hq, Hkv), slots, D, lengths:
# hymba-1.5b's 1,024-slot ring (G 5, D 64), gemma3-1b's 512-slot ring and
# its full 1,016-slot cache (G 4, D 256), qwen3-moe-30b-a3b's full cache
# (G 8, D 128)
FAMILY_DECODE = (((25, 5), 1024, 64, (1, _C, _C + 1, 1024)),
                 ((4, 1), 512, 256, (0, 1, 512, 512)),
                 ((4, 1), 1016, 256, (0, 1, 512, 1016)),
                 ((HEADS["Hq"], 4), SERVE["prompt_len"] + SERVE["decode_steps"],
                  HEADS["D"], (0, 1, _C + 1, 1016)))
# Whisper's and InternVL2's decode caches, (Hq, Hkv), slots, D, lengths:
# Whisper's cross cache (the encoder's 1,500 frames, every slot live in the
# model) and its 448-slot self ring, InternVL2's full cache after 256
# patches, 1,000 tokens and 16 decode steps (a group of 7)
AV_DECODE = (((6, 6), 1500, 64, (0, 1, _C + 1, 1500)),
             ((6, 6), 448, 64, (0, 1, _C + 1, 448)),
             ((14, 2), 1272, 64, (0, 1, _C + 1, 1272)))
# mesh_serve's decode as a rank runs it (bf16, the query re-laid into the
# cache's layout: every query head), (B, Hq, Hkv, slots, D, lengths), on the
# rank's slice of the slots with the lengths clipped to it: run (a)'s
# caches, their 4 rows over model (2 a rank) and 1,016 slots over data (508
# a rank): a slice none of whose slots is live yet (0) beside the second
# slice at the first step (1,001 - 508 = 493), and two full slices; run
# (b)'s 8,200 slots over all 4 ranks (2,050 a rank): the last slice at the
# first step (8,193 - 6,150 = 2,043), and a full one
MESH_SERVE_DECODE = ((2, HEADS["Hq"], HEADS["Hkv"], 508, HEADS["D"], (0, 493)),
                     (2, HEADS["Hq"], HEADS["Hkv"], 508, HEADS["D"],
                      (508, 508)),
                     (1, HEADS["Hq"], HEADS["Hkv"], 2050, HEADS["D"], (2043,)),
                     (1, HEADS["Hq"], HEADS["Hkv"], 2050, HEADS["D"], (2050,)))
# (B, Hq, Hkv, S, D, dtype, lengths): the serve decode cache first, at
# lengths 1, one split (64), one past it and the whole cache, then with a
# row of length 0 (exactly zero, where the plain version gives the mean of
# V); then small float32 caches; then ``FAMILY_DECODE`` and ``AV_DECODE``
# at the serve cell's batch, then ``MESH_SERVE_DECODE``
DECODE_CASES = ((SERVE["batch"], HEADS["Hq"], HEADS["Hkv"],
                 SERVE["prompt_len"] + SERVE["decode_steps"], HEADS["D"],
                 "bfloat16", (1, _C, _C + 1, 1016)),
                (SERVE["batch"], HEADS["Hq"], HEADS["Hkv"],
                 SERVE["prompt_len"] + SERVE["decode_steps"], HEADS["D"],
                 "bfloat16", (0, 512, 513, 1016)),
                (2, 8, 2, 100, 64, "float32", (1, 64)),
                (2, 4, 1, 40, 16, "float32", (40, 17)),
                *((SERVE["batch"], *heads, S, D, "bfloat16", lengths)
                  for heads, S, D, lengths in (*FAMILY_DECODE, *AV_DECODE)),
                *((*case[:5], "bfloat16", case[5])
                  for case in MESH_SERVE_DECODE))
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
# the SSD scans train_ssm runs, (B, S, H, P, N, chunk) at seq 256 x batch
# 8: mamba2-1.3b's (one 256-row chunk), hymba-1.5b's (25 heads of 64, N
# 16, two 128-row chunks)
TRAIN_SSM_SSD = ((8, 256, SSM["H"], SSM["P"], SSM["N"], SSM["chunk"]),
                 (8, 256, 25, 64, 16, 128))
# (B, S, H, P, N, chunk, dtype, model-made inputs): the serve prefill
# first; then tests/test_kernels.py's mamba2-like case, a ragged S at the
# reduced config's widths and a ragged S with three heads; then the
# bfloat16 passes at hymba's widths (N=16, P=64) over two chunks, the last
# ragged, at the reduced widths (N=8, P=16), and at N=128, P=32 over three
# chunks with 3 heads (a head group of 8 only partly filled); then hymba's
# prefill and ``TRAIN_SSM_SSD``
SSD_CASES = ((SERVE["batch"], SERVE["prompt_len"], SSM["H"], SSM["P"],
              SSM["N"], SSM["chunk"], "bfloat16", True),
             (1, 256, 2, 64, 128, 128, "float32", False),
             (2, 130, 4, 16, 8, 16, "float32", False),
             (1, 77, 3, 32, 16, 64, "float32", True),
             (2, 300, 4, 64, 16, 64, "bfloat16", True),
             (2, 130, 4, 16, 8, 16, "bfloat16", False),
             (1, 520, 3, 32, 128, 256, "bfloat16", False),
             # hymba-1.5b's SSD heads at the decode graph's prompt: H = 25
             # leaves the last group of 8 heads one
             (SERVE["batch"], 1100, 25, 64, 16, 128, "bfloat16", True),
             *((*case, "bfloat16", True) for case in TRAIN_SSM_SSD))
# The SSD backward against ref.ssd_grads (float32 autograd through the
# sequential scan), element by element, |grad - plain| <= scale max|plain| +
# rtol |plain| by the gradient's dtype: every float32 gradient (ddt, dB, dC,
# and dx of float32 x) to 2e-5 of its scale plus 1e-4 of itself (sums of up
# to S terms in another order, CUDA's expf; the kernel's schedule modelled
# in float32 on the CPU, tests/test_torch_ssd_bwd.py, stays within 2.1e-6
# of the scale); a bfloat16 dx also within one bfloat16 step of itself
# (rtol 2**-7: its float32 value rounds once). dA sums B S terms dt_i
# ddA_i, each ddA_i itself a reverse sum of r over the sequence, so its
# error grows with the terms, not with the result: within ``terms`` (1e-3)
# of the sum of the terms' magnitudes, sum |dt_i ddt_i - x_i . dx_i| / |A|
# from the plain version's gradients (the model: <= 5e-5 at S 256)
SSD_BWD_TOL = {"float32": dict(scale=2e-5, rtol=1e-4),
               "bfloat16": dict(scale=2e-5, rtol=2.0 ** -7), "terms": 1e-3}
# (B, S, H, P, N, chunk, dtype, strided dy): ``TRAIN_SSM_SSD``, mamba2-1.3b's
# and hymba-1.5b's training shapes; hymba's SSD heads over an S of 300, no
# multiple of a chunk or of the backward's 32-row tile, with dy strided; a
# small float32 case
SSD_BWD_CASES = (*((*case, "bfloat16", False) for case in TRAIN_SSM_SSD),
                 (8, 300, 25, 64, 16, 128, "bfloat16", True),
                 (2, 70, 4, 16, 8, 16, "float32", False))
# (rows, R): benchmarks/footprint.py's shape, then tests/test_kernels.py's
KDE_SIZES = ((65536, 64), (300, 64))
# R of the adversarial maintenance and KDE rows: one sample (a lane a row),
# a ragged R (scalar loads), the main paths' 64 and the wrapper's largest
# (32 lanes of 8 quads); the KDE kernel also past it (segments of 128)
ADVERSARIAL_R = (1, 33, 64, 1024)
KDE_LONG_R = 1027
# R where the maintenance KDE sum takes its other two orders (ref.
# _xla_kde_sum: 11..16 padded to two eights, 17..32 whole eights and a
# tail): mu bit for bit there too
MU_ORDER_R = (13, 20, 21, 24, 40)
# The flash backward against ref.attention_grads (float32 autograd through the
# plain attention), element by element, |grad - plain| <= atol + rtol |plain|:
# bfloat16, rtol 2**-7 is one bfloat16 step of the gradient's own magnitude
# (the kernel's float32 result rounds once to bfloat16, at most half a step;
# the rest is float32 sums in another order, ~1e-6 of the gradient's scale),
# atol 1e-3 for gradients near 0; float32 within 1e-5 + 1e-5 |plain| (sums
# over up to S rows in another order, CUDA's expf)
BWD_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
           "bfloat16": dict(rtol=2.0 ** -7, atol=1e-3)}
# The training cell: qwen3-4b at its published width, the reference CLI's
# sequence and batch (synthetic_batch), AdamW on a cosine schedule with 20
# warm-up steps, remat; budget 90 s with the model's build. 20 steps, cut
# from 30 to keep the script inside its time limit on slower hosts, the
# fewest that keep the whole warm-up
TRAIN = dict(arch="qwen3-4b", steps=20, seq_len=256, batch=8, lr=3e-4,
             budget_s=90.0)
# The SSM and hybrid training cells (train_ssm): mamba2-1.3b and hymba-1.5b
# at their published widths and depths, TRAIN's sequence, batch, optimizer
# and remat, 20 steps each (the whole warm-up, as TRAIN; at 10 on an H100,
# mamba2's loss fell only 11.37 -> 11.30); the phase's budget with the models'
# builds. Then --train-100m at examples/train_100m.py's seq 512 x batch 8,
# 20 steps
TRAIN_SSM = dict(steps=20, seq_len=TRAIN["seq_len"], batch=TRAIN["batch"],
                 lr=TRAIN["lr"], last=5, budget_s=60.0)
TRAIN_100M = dict(steps=20, seq_len=512, batch=8, lr=TRAIN["lr"], last=5)
# ``--ssd-witness``: train_ssm's mamba2-1.3b (published width, seed 0, its
# first batch), the SSD kernels against the plain scan (``ref.ssd`` and its
# float32 autograd). At 48 layers the two losses part by 0.28 % and leaves'
# gradients are near orthogonal (NVIDIA H100 80GB HBM3, 700 W), so the
# witness tells a kernel fault from the model's own sensitivity to rounding. Gated: the kernels at the inputs the
# model gives its first and last layer (``SSD_TOL``, ``SSD_BWD_TOL``); the
# backward kernel against the plain backward under the same forward at 48
# layers; and the kernels against the plain scan at ``shallow`` layers,
# where little amplifies: the loss within ``loss_rtol``, every leaf's
# gradient norm within ``norm_rtol`` and its cosine at least ``min_cos``
# (bf16 activations and gradients, y rounded to bf16 either way). Reported:
# the kernels against the plain scan at 48 layers, and how far each layer's
# y parts from the plain run's when the kernels run every layer and when
# only the first layer's y is perturbed by as much as the kernel parts
# from the plain scan there (``noise_seed``); and how far the gradients part
# when only the last layer's dx is perturbed by as much as the kernel's dx
# parts from the plain backward's there.
WITNESS = dict(arch="mamba2-1.3b", shallow=2, loss_rtol=1e-3, norm_rtol=0.02,
               min_cos=0.99, noise_seed=1)
# (B, Hq, Hkv, S, D, dtype, causal, window): the training shape (qwen3-4b's
# heads, batch 8, seq 256; its dO strided, as the model's transpose gives it),
# gemma3-1b's local layers (4/1 heads of 256, window 512, S 1,000, the serve
# cell's batch), hymba-1.5b's heads (25/5 of 64: a group of 5, its window of
# 1,024, S 1,100 past the window and no multiple of the 64-row tile), a
# small float32 case with a window, and Whisper's bidirectional encoder mask
# in float32, then ``MESH_FLASH`` (float32 at D 128, as mesh_train's ranks
# run it), then ``TRAIN_100M_FLASH`` and ``TRAIN_HYMBA_FLASH``. bfloat16 at
# D 64 and 128 takes the tensor-core kernels, D 80 and 256 and float32 the
# CUDA-core ones (``flash_attention.bwd_tensor_cores``)
BWD_CASES = ((TRAIN["batch"], HEADS["Hq"], HEADS["Hkv"], TRAIN["seq_len"],
              HEADS["D"], "bfloat16", True, None),
             (SERVE["batch"], 4, 1, 1000, 256, "bfloat16", True, 512),
             (2, 25, 5, 1100, 64, "bfloat16", True, 1024),
             (2, 4, 2, 130, 64, "float32", True, 48),
             (2, 4, 1, 70, 32, "float32", False, None),
             *((*shape, "float32", True, None) for shape in MESH_FLASH),
             *TRAIN_100M_FLASH, TRAIN_HYMBA_FLASH)
# The sharded-training cell: qwen3-4b at its published widths cut to
# MESH_TRAIN["layers"] layers (two data replicas of the weights and AdamW
# moments in float32 share the one card), the reference SPMD test's
# optimizer, 3 steps and tolerance; then 2 steps resumed on the shrunk mesh
MESH_TRAIN = dict(arch="qwen3-4b", layers=2, seq_len=256, batch=8, lr=1e-3,
                  clip_norm=1.0, steps=3, resumed=2, mesh=(2, 2),
                  rtol=1e-4, atol=1e-5, budget_s=60.0)
# The sharded-serving cell (mesh_serve): bf16 partial sums over the model
# axis and the slots' merge round in another order than one rank's, and 36
# layers carry the rounding on. Every call's max |sharded - one rank| must
# stay within ``max_abs_over_scale`` of one rank's max |logit|, and the
# greedy tokens agree at ``token_agree`` of the picks (random weights leave
# near-tied top logits: 0.868 in (a) on the card). The bound lies between
# the card's sound runs (every call's gap 2.13-2.93 %, the same on every
# run) and the faults ``--plant-faults`` plants: one slot slice dropped
# from the merge (32.7 % in (a), 8.1 % in (b)) and the slices merged
# unweighted (4.66 %, 4.08 %) fail it; the new K/V written on every rank
# (3.62 %, 3.31 %: one live slot a rank a step) passes, and the CPU test
# at float32 catches it.
MESH_SERVE = dict(arch="qwen3-4b", batch=4, prompt_len=1000, steps=16,
                  long_prompt=8192, long_steps=8, mesh=(2, 2),
                  max_abs_over_scale=0.04, token_agree=0.75,
                  dry=("qwen3-4b", "decode_32k"), budget_s=60.0)
# Faults planted in mesh_serve's decode (``--plant-faults``) to read what
# its bound tells apart: (name, a line of ``models.attention.decode_attend``,
# the line that replaces it in a copy made in memory). One rank's slice of
# the slots left out of the merge, the slices merged without their
# exp(lse - max) weights, and the new token's K/V written on every rank (a
# rank that does not hold slot pos writes its nearest slot)
MERGE_FAULTS = (
    ("slice_dropped",
     '    top = all_reduce(lse, mesh.axis(slots).group, "max")\n',
     '    if mesh.axis(slots).index == 1:\n'
     '        lse = torch.full_like(lse, -float("inf"))\n'
     '    top = all_reduce(lse, mesh.axis(slots).group, "max")\n'),
    ("unweighted_merge",
     "    w = torch.exp(lse - top)[..., None]\n",
     "    w = torch.ones_like(lse)[..., None]\n"),
    ("kv_written_on_every_rank",
     "        mine = (slot >= 0) & (slot < Sl)\n",
     "        mine = torch.ones_like(slot, dtype=torch.bool)\n"),
)
# kernels that must build without spilling registers: the kernels redesigned
# for Hopper
SSD_PASSES = ("ssd_cb_kernel", "ssd_state_kernel", "ssd_pass_kernel",
              "ssd_scan_kernel")
FLASH_BWD_TC = ("flash_bwd_dq_tc_kernel", "flash_bwd_dkdv_tc_kernel")
NO_SPILL = ("flash_tc_kernel", *FLASH_BWD_TC, "decode_split_kernel",
            "decode_combine_kernel", *SSD_PASSES, "round_kernel",
            "maintenance_kernel", "kde_kernel")
# the port's CUDA kernels by name, as the profiler and ptxas report them
PORT_KERNELS = ("round_kernel", "maintenance_kernel", "kde_kernel",
                "flash_tc_kernel", "flash_f32_kernel", *FLASH_BWD_TC,
                "flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel",
                "decode_split_kernel", "decode_combine_kernel", "ssd_kernel",
                *SSD_PASSES, "ssd_bwd_state_kernel", "ssd_bwd_chunk_kernel",
                "ssd_bwd_dt_kernel", "ssd_bwd_reduce_kernel")


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


def share(part: float | None, whole: float) -> float | None:
    """``part / whole``; None where ``part`` was not measured."""
    return None if part is None else part / whole


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


def lane_round_inputs(S: int, K: int, M: int, C: int, R: int, Rq: int,
                      seed: int, dev):
    """S lanes of ``round_inputs``, each from its own seed: the players of
    every lane as rows, the queue, liveness, service and drain rows as
    (S, M). Lane s's service time is 5.5 ms x (1 + s / 4), and lane 1
    has three instances down."""
    import torch
    lanes = [round_inputs(K, M, C, R, Rq, seed + s, dev) for s in range(S)]
    cat = [torch.cat([lane[i] for lane in lanes]) for i in range(18)]
    stack = {i: torch.stack([lane[i] for lane in lanes])
             for i in (5, 12, 16, 17)}
    cat[14] = torch.cat([lane[14] for lane in lanes], dim=1)      # z: (C, S*K)
    for i, x in stack.items():
        cat[i] = x
    cat[16] = cat[16] * (1.0 + torch.arange(S, device=dev)[:, None] / 4.0)
    cat[17] = (0.1 / (C * cat[16])).to(torch.float32)
    if S > 1:
        cat[5][1, 1:4] = False
    return tuple(x.contiguous() for x in cat) + (lanes[0][-1],)


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
        err = check_mu_bits(mu, mu_p, "R=64")
        errs.setdefault("fused_maintenance", err)
        emit(phase="kernels", kernel="fused_maintenance", rows=rows, R=64,
             q_exact=True, mu_bit_exact=True, mu_max_abs_err=err,
             tol=MAINT_TOL)
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
        lse_err = check_lse(case, q, k, v, length, out)
        errs.setdefault("decode_attention", res["max_abs_err"])
        emit(phase="kernels", kernel="decode_attention", B=B, Hq=Hq,
             Hkv=Hkv, S=S, D=D, dtype=dtype, lengths=list(lengths),
             zero_rows_exact=int((~live).sum()), lse_max_abs_err=lse_err,
             lse_tol=LSE_TOL, **res, **ATTN_TOL[dtype])

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
    errs["flash_attention_bwd"] = check_flash_bwd(dev)
    errs["ssd_bwd"] = check_ssd_bwd(dev)
    check_grad_refusal(dev)
    return errs


def check_lse(case, q, k, v, length, out) -> float:
    """``decode_attention``'s log-sum-exp output (``with_lse``) against
    its plain version's: within ``LSE_TOL`` where a row has slots, -inf
    where it has none; the output beside it bit-identical to the call
    without it. Returns the largest error."""
    import torch
    from repro_torch.kernels import decode_attention, ref
    out2, lse = decode_attention.decode_attention(q, k, v, length,
                                                  with_lse=True)
    _, plain = ref.decode_attention(q, k, v, length, with_lse=True)
    torch.cuda.synchronize()
    live = length > 0
    err = (lse[live] - plain[live]).abs().max().item() if live.any() else 0.0
    tol = LSE_TOL["atol"] + LSE_TOL["rtol"] * plain[live].abs()
    if not (torch.equal(out2, out) and lse.dtype == torch.float32
            and bool(((lse[live] - plain[live]).abs() <= tol).all())
            and bool(torch.isneginf(lse[~live]).all())):
        raise AssertionError(f"decode_attention {case}: log-sum-exp error "
                             f"{err} (tol {LSE_TOL}), or its output moved")
    return err


def check_mu_bits(mu, mu_p, where: str) -> float:
    """mu bit for bit against the plain version's (``MAINT_TOL``);
    returns the largest difference (0.0)."""
    import torch
    if not same_bits(mu, mu_p):
        bad = (mu.view(torch.int32) != mu_p.view(torch.int32)).nonzero()
        raise AssertionError(f"maintenance mu not bit-exact at {where}, rows "
                             f"{bad[:5].flatten().tolist()} of {len(bad)}: "
                             f"{mu[bad[:3, 0]].tolist()} against "
                             f"{mu_p[bad[:3, 0]].tolist()}")
    return (mu - mu_p).abs().max().item()


def check_flash_bwd(dev) -> float:
    """``flash_attention_bwd`` against ``ref.attention_grads`` at
    ``BWD_CASES`` (dQ, dK, dV element by element within ``BWD_TOL``), a
    second call bit-identical (no atomics), on unit-scale q, k, v and dO
    drawn on the card. Returns the training shape's largest error."""
    import torch
    from repro_torch.kernels import flash_attention, ref
    first = None
    for seed, case in enumerate(BWD_CASES, 90):
        B, Hq, Hkv, S, D, dtype, causal, window = case
        q, k, v = attention_inputs(B, Hq, Hkv, S, D, dtype, seed, dev)
        gen = torch.Generator(device=dev).manual_seed(seed + 100)
        # dO as the model's backward hands it: (B, S, Hq, D) seen as
        # (B, Hq, S, D), strided
        do = torch.randn((B, S, Hq, D), generator=gen, device=dev).to(
            q.dtype).transpose(1, 2)
        grads = flash_attention.flash_attention_bwd(q, k, v, do, causal=causal,
                                                    window=window)
        again = flash_attention.flash_attention_bwd(q, k, v, do,
                                                    causal=causal,
                                                    window=window)
        plain = ref.attention_grads(q, k, v, do, causal=causal, window=window)
        torch.cuda.synchronize()
        tol, res = BWD_TOL[dtype], {}
        for name, g, gp, g2 in zip(("dq", "dk", "dv"), grads, plain, again):
            if g.shape != gp.shape or g.dtype != q.dtype:
                raise AssertionError(f"flash_attention_bwd {case} {name}: "
                                     f"{g.shape} {g.dtype}")
            diff = (g.float() - gp).abs()
            used = (diff / (tol["atol"] + tol["rtol"] * gp.abs())).max().item()
            res[name] = dict(max_abs_err=diff.max().item(),
                             allowance_used=used,
                             grad_max_abs=gp.abs().max().item())
            if not used <= 1.0:
                raise AssertionError(f"flash_attention_bwd {case} {name}: "
                                     f"{res[name]} against {tol}")
            if not same_bits(g, g2):
                raise AssertionError(f"flash_attention_bwd {case}: a second "
                                     f"call differs in {name}")
        first = first if first is not None else max(
            r["max_abs_err"] for r in res.values())
        emit(phase="kernels", kernel="flash_attention_bwd", B=B, Hq=Hq,
             Hkv=Hkv, S=S, D=D, dtype=dtype, causal=causal, window=window,
             tensor_cores=flash_attention.bwd_tensor_cores(q.dtype, D),
             dout_strided=not do.is_contiguous(), repeat_identical=True,
             **res, **tol)
        del q, k, v, do, grads, again, plain
    return first


def ssd_bwd_used(g, plain, tol: dict, terms=None) -> dict:
    """One SSD gradient against its plain version (``SSD_BWD_TOL``): the
    worst element's share of its allowance, ``scale max|plain| + rtol
    |plain|``, or of ``terms`` (dA's)."""
    diff = (g.double() - plain.double()).abs()
    allow = (tol["scale"] * plain.double().abs().max()
             + tol["rtol"] * plain.double().abs()) if terms is None else terms
    return dict(max_abs_err=diff.max().item(),
                allowance_used=(diff / allow).max().item(),
                grad_max_abs=plain.abs().max().item())


def check_ssd_bwd(dev) -> float:
    """``ssd_bwd`` against ``ref.ssd_grads`` at ``SSD_BWD_CASES``: dx,
    ddt, dA, dB and dC within ``SSD_BWD_TOL`` (dA against the sum of its
    terms' magnitudes), a second call bit-identical (no atomics), on
    inputs made as the model makes them and a unit-scale dy drawn on the
    card; ``ops.ssd`` under grad mode giving the same forward bits as
    under ``no_grad`` and these gradients through ``SSDScan``, at
    ``TRAIN_SSM_SSD`` and the small float32 case. Returns
    the training shape's largest error."""
    import torch
    from repro_torch.kernels import ops, ref, ssd
    first = None
    for seed, case in enumerate(SSD_BWD_CASES, 96):
        B, S, H, P, N, chunk, dtype, strided = case
        args = ssd_inputs(B, S, H, P, N, dtype, True, seed, dev)
        gen = torch.Generator(device=dev).manual_seed(seed + 100)
        shape = (B, S, P, H) if strided else (B, S, H, P)
        dy = torch.randn(shape, generator=gen, device=dev).to(args[0].dtype)
        if strided:
            dy = dy.transpose(2, 3)
        grads = ssd.ssd_bwd(*args, dy)
        again = ssd.ssd_bwd(*args, dy)
        plain = ref.ssd_grads(*args, dy)
        torch.cuda.synchronize()
        x, dt, A = args[:3]
        terms = ((dt.double() * plain[1].double()
                  - (x.double() * plain[0].double()).sum(-1))
                 / A.double()).abs().sum((0, 1))
        res = {}
        for name, g, gp, g2, arg in zip(("dx", "ddt", "dA", "dB", "dC"),
                                        grads, plain, again, args):
            if g.shape != arg.shape or g.dtype != arg.dtype:
                raise AssertionError(f"ssd_bwd {case} {name}: {g.shape} "
                                     f"{g.dtype}")
            res[name] = ssd_bwd_used(
                g, gp, SSD_BWD_TOL[str(g.dtype).split(".")[1]],
                SSD_BWD_TOL["terms"] * terms if name == "dA" else None)
            if not res[name]["allowance_used"] <= 1.0:
                raise AssertionError(f"ssd_bwd {case} {name}: {res[name]} "
                                     f"against {SSD_BWD_TOL}")
            if not same_bits(g, g2):
                raise AssertionError(f"ssd_bwd {case}: a second call "
                                     f"differs in {name}")
        first = first if first is not None else max(
            r["max_abs_err"] for r in res.values())
        emit(phase="kernels", kernel="ssd_bwd", B=B, S=S, H=H, P=P, N=N,
             chunk=chunk, dtype=dtype, dy_strided=not dy.is_contiguous(),
             repeat_identical=True, **res, tol=SSD_BWD_TOL)
        del args, dy, grads, again, plain
    # through ops.ssd, at train_ssm's shapes and the small float32 case:
    # the autograd Function records the forward kernel's bits and hands
    # ssd_bwd's gradients back in the inputs' order
    for seed, case in enumerate((*((*c, "bfloat16") for c in TRAIN_SSM_SSD),
                                 SSD_BWD_CASES[-1][:7]), 120):
        B, S, H, P, N, chunk, dtype = case
        args = ssd_inputs(B, S, H, P, N, dtype, True, seed, dev)
        dy = torch.randn_like(args[0])
        leaves = [t.clone().requires_grad_() for t in args]
        out = ops.ssd(*leaves, chunk=chunk)
        got = torch.autograd.grad(out, leaves, dy)
        with torch.no_grad():
            plain_out = ops.ssd(*args, chunk=chunk)
        want = ssd.ssd_bwd(*args, dy)
        torch.cuda.synchronize()
        if not (same_bits(out.detach(), plain_out)
                and all(same_bits(g, w) for g, w in zip(got, want))):
            raise AssertionError(f"ops.ssd {case} under grad mode: the "
                                 f"forward or the gradients differ from the "
                                 f"kernels called alone")
        emit(phase="kernels", kernel="ssd_bwd", through_ops_ssd=True, B=B,
             S=S, H=H, P=P, N=N, chunk=chunk, dtype=dtype,
             forward_bits_equal=True, grads_bits_equal=True)
        del args, dy, leaves, out, got, plain_out, want
    return first


def check_grad_refusal(dev) -> None:
    """A kernel without a backward refuses an input that requires grad
    (``ops.decode_attention`` on the card), and gives its answer under
    ``no_grad``."""
    import torch
    from repro_torch.kernels import ops
    q, k, v, length = decode_inputs(1, 4, 1, 64, 64, "float32", (64,), 95,
                                    dev)
    q = q.clone().requires_grad_()
    try:
        ops.decode_attention(q, k, v, length)
    except RuntimeError as e:
        if "no backward" not in str(e):
            raise
        refused = str(e)
    else:
        raise AssertionError("ops.decode_attention took an input that "
                             "requires grad")
    with torch.no_grad():
        out = ops.decode_attention(q, k, v, length)
    torch.cuda.synchronize()
    emit(phase="kernels", kernel="decode_attention", grad_refused=True,
         message=refused, no_grad_finite=bool(torch.isfinite(out).all()))


def check_adversarial_rows(dev) -> None:
    """Both maintenance kernels on rows that select at ties and at signed
    zeros, with one sample, none, and R from 1 to past 1024: q equal to the
    plain version's (-0.0 == 0.0: the plain version's sort leaves the order
    of equal zeros undefined), mu bit for bit (``MAINT_TOL``), the KDE
    kernel within ``KDE_TOL``; then the maintenance kernel alone at
    ``MU_ORDER_R``, the KDE sum's other orders."""
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
            err = check_mu_bits(mu, mu_p, f"R={R}")
            fields.update(q_exact=True, mu_bit_exact=True, mu_max_abs_err=err,
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
    for R in MU_ORDER_R:
        lat, mask, rtt, _ = adversarial_maintenance_inputs(R, 60 + R, dev)
        mu, q = kde.fused_maintenance(lat, mask, rtt, 0.08, 0.9)
        mu_p, q_p = ref.bandit_maintenance_stats(lat, mask, rtt, 0.08, 0.9)
        torch.cuda.synchronize()
        if not torch.equal(q, q_p):
            raise AssertionError(f"maintenance q differs at R={R}")
        emit(phase="kernels", kernel="maintenance_mu_order", R=R,
             rows=lat.shape[0], q_exact=True, mu_bit_exact=True,
             mu_max_abs_err=check_mu_bits(mu, mu_p, f"R={R}"))


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


def round_launch_fields(K: int, M: int, C: int, dev, S: int = 1) -> dict:
    """The round kernel's launch for K players (of S lanes) x M x C, as
    the kernels and times lines report it."""
    from repro_torch.kernels import round_fused
    return dict(**round_fused.geometry(K, M, C, dev, S),
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
    for seed, (S, K, M) in enumerate(ROUND_LANE_CASES, 60):
        worst = max(worst, check_round_lanes(S, K, M, seed, dev))

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


def check_round_lanes(S: int, K: int, M: int, seed: int, dev) -> float:
    """``round_step_swrr`` with S lanes in one launch against its plain
    version, every output exact, the inputs unchanged, a second call
    bit-identical, and lane 0 equal to the same lane called alone."""
    import torch
    from repro_torch.kernels import ref, round_fused
    names = ref.RoundStepOut._fields
    kw = dict(tau=0.08, err_thresh=5, cooldown=10.0)
    args = lane_round_inputs(S, K, M, 8, 64, 512, seed, dev)
    before = [x.clone() for x in args[:-1]]
    n0 = round_fused.round_step_swrr.launches
    out = round_fused.round_step_swrr(*args, **kw)
    if round_fused.round_step_swrr.launches != n0 + 1:
        raise AssertionError("a lane batch took more than one launch")
    plain = ref.round_step_swrr(*args, **kw)
    again = round_fused.round_step_swrr(*args, **kw)
    # lane 0 alone, in the one-lane (M,) layout
    one = list(args)
    for i in range(18):
        one[i] = (args[i][0] if i in (5, 12, 16, 17) else
                  args[i][:, :K] if i == 14 else args[i][:K])
    alone = round_fused.round_step_swrr(*(x.contiguous() if i < 18 else x
                                          for i, x in enumerate(one)), **kw)
    torch.cuda.synchronize()
    case = f"S={S}, K={K}, M={M}"
    err = 0.0
    for name, a, b in zip(names, out, plain):
        if a.dtype.is_floating_point:
            err = max(err, (a - b).abs().max().item())
            ok = torch.allclose(a, b, rtol=ROUND_RTOL, atol=0.0)
        else:
            ok = torch.equal(a, b.to(a.dtype))
        if not ok:
            raise AssertionError(f"round_step_swrr {name} differs ({case})")
    if [i for i, (a, b) in enumerate(zip(args, before)) if not same_bits(a, b)]:
        raise AssertionError(f"round_step_swrr changed its inputs ({case})")
    unstable = [n for n, a, b in zip(names, out, again) if not same_bits(a, b)]
    if unstable:
        raise AssertionError(f"round_step_swrr: a second call differs in "
                             f"{unstable} ({case})")
    for name, a, b in zip(names, out, alone):
        lane0 = a[0] if name in ("q", "arrivals") else a[:K]
        if not same_bits(lane0, b):
            raise AssertionError(f"round_step_swrr lane 0 differs from the "
                                 f"lane alone in {name} ({case})")
    emit(phase="kernels", kernel="round_step_swrr", lanes=S, K=K, M=M, C=8,
         R=64, Rq=512, exact=True, max_abs_err=err, inputs_unchanged=True,
         repeat_identical=True, lane0_equals_alone=True,
         inactive_per_lane=(~args[5]).sum(-1).tolist(),
         trips=int((args[3] != out.cooldown_until).sum()),
         arrivals_per_lane=out.arrivals.sum(-1).tolist(),
         **round_launch_fields(S * K, M, 8, dev, S))
    return err


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
    return launches, steps / secs


def sim_launches() -> dict:
    from repro_torch.kernels import kde, round_fused
    return {"round_step_swrr": round_fused.round_step_swrr.launches,
            "fused_maintenance": kde.fused_maintenance.launches}


def check_identical(a, b, what: str) -> None:
    """Every accumulator field (each tenant's, in a tenant run), series
    value and control counter of two streaming runs exactly equal."""
    import torch
    from repro_torch.continuum.metrics import is_tenant_run
    if (a.ctrl is None) != (b.ctrl is None):
        raise AssertionError(f"{what}: one run has control counters")
    tenants = is_tenant_run(a.acc)
    if tenants and len(a.acc) != len(b.acc):
        raise AssertionError(f"{what}: {len(a.acc)} and {len(b.acc)} tenants")
    pairs = [(f"acc[{s}]", x, y) for s, (x, y) in enumerate(zip(a.acc, b.acc))
             ] if tenants else [("acc", a.acc, b.acc)]
    pairs += [(part, getattr(a, part), getattr(b, part))
              for part in ("series", "ctrl")]
    for part, x, y in pairs:
        for f in (x._fields if x is not None else ()):
            if not torch.equal(getattr(x, f), getattr(y, f)):
                raise AssertionError(f"{what}: {part}.{f} differs")


def check_lifecycle_conservation(acc, shed) -> None:
    """Every attempt lands once on an instance; every served request
    (issued but not shed) once in the routing and latency counts."""
    attempts, served = float(acc.att_k.sum()), float(acc.n_kc.sum()) - shed
    for name, want in (("arrivals_m", attempts), ("choice_counts", served),
                       ("proc_hist", served)):
        got = float(getattr(acc, name).sum())
        if got != want:
            raise AssertionError(f"{name} counts {got}, the run needs {want}")
    for f in acc._fields:
        if not bool(getattr(acc, f).isfinite().all()):
            raise AssertionError(f"non-finite {f}")


def phase_lifecycle_fleet(dev, neutral_steps_per_s: float) -> None:
    """The anchor fleet under the control plane (a), then also the
    bounded request lifecycle (b), then (b) chunked, stopped at step 100
    into a checkpoint and resumed (c): (a) fused round against the round
    scan, and (c) against (b), bit for bit."""
    import dataclasses
    import tempfile
    import torch
    from repro_torch.bench.scenarios import CONTROL_RES
    from repro_torch.continuum import ControlConfig, run_sim_stream
    cfg, rtt = fleet_inputs(dev, LIFECYCLE["horizon"])
    steps = cfg.num_steps
    ctl_cfg = dataclasses.replace(cfg, control=ControlConfig(
        **LIFECYCLE_CONTROL))
    res_cfg = dataclasses.replace(ctl_cfg, **CONTROL_RES)

    def run(label, cfg, needs, ran=steps, **kw):
        base = memory_baseline(dev)
        for fn in all_kernels():
            fn.launches = 0
        t0 = time.perf_counter()
        out = run_sim_stream("qedgeproxy", rtt, cfg, 7, device=dev, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = sim_launches()
        shed = float(out.ctrl.shed_k.sum())
        emit(phase="lifecycle_fleet", run=label, K=FLEET["K"], M=FLEET["M"],
             managed=LIFECYCLE["managed"], steps=ran, seconds=secs,
             steps_per_s=ran / secs,
             neutral_fleet_steps_per_s=neutral_steps_per_s,
             peak_mem_bytes=peak_above(dev, base), **base, launches=launches,
             scale_up=float(out.ctrl.scale_up),
             scale_down=float(out.ctrl.scale_down), shed=shed,
             attempts=float(out.acc.att_k.sum()),
             timeouts=float(out.acc.timeout_k.sum()),
             drops=float(out.acc.drop_k.sum()),
             breaker_open_steps=float(out.acc.open_km.sum()),
             requests=float(out.acc.n_kc.sum()))
        if needs is not None and launches != needs:
            raise AssertionError(f"lifecycle_fleet {label}: launches "
                                 f"{launches}, the path needs {needs}")
        check_lifecycle_conservation(out.acc, shed)
        return out

    each = dict(round_step_swrr=steps, fused_maintenance=steps)
    scan = dict(round_step_swrr=0, fused_maintenance=steps)
    fused = run("a_control_fused", ctl_cfg, each)
    scanned = run("a_control_scan", dataclasses.replace(ctl_cfg,
                                                        fused_round=False),
                  scan)
    check_identical(fused, scanned, "lifecycle_fleet (a) fused vs scan")
    if not float(fused.ctrl.scale_up) > 0 or not float(
            fused.ctrl.shed_k.sum()) > 0:
        raise AssertionError("lifecycle_fleet (a): the controller never "
                             "scaled up or shed")
    whole = run("b_control_lifecycle", res_cfg, scan)
    if not float(whole.acc.timeout_k.sum()) > 0:
        raise AssertionError("lifecycle_fleet (b): no attempt timed out")
    with tempfile.TemporaryDirectory() as d:
        kw = dict(chunk_steps=LIFECYCLE["chunk_steps"], checkpoint_dir=d)
        stop = LIFECYCLE["stop_at"]
        part = run("c_stopped", res_cfg, None, ran=stop, stop_at_step=stop,
                   **kw)
        if part.series.succ.shape[0] != stop:
            raise AssertionError(f"stopped run: {part.series.succ.shape[0]} "
                                 f"steps, {stop} wanted")
        resumed = run("c_resumed", res_cfg, None, ran=steps - stop,
                      resume=True, **kw)
    check_identical(whole, resumed, "lifecycle_fleet (c) resumed vs (b)")
    emit(phase="lifecycle_fleet", fused_equals_scan=True,
         resumed_equals_uninterrupted=True)


def check_same_ring(a, b, what: str) -> None:
    """Two recorder states equal field by field, bit for bit."""
    import torch
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if x.shape != y.shape or not torch.equal(x.cpu(), y.cpu()):
            raise AssertionError(f"{what}: rec.{f} differs")


def recorder_sync_check(dev) -> dict:
    """One ``record_step`` at the fleet's shapes with every lane of
    candidates on, under the sync debug mode's "error": any host sync
    raises. The ring must equal the same call on the CPU."""
    import torch
    from repro_torch.continuum.scenarios import MAX_MARKS
    from repro_torch.obs import recorder as obr
    K, M = FLEET["K"], FLEET["M"]
    rcfg = obr.RecorderConfig(capacity=RECORDER["capacity"])
    rng = np.random.default_rng(0)
    iss = rng.integers(0, 9, (1, K)).astype(np.float32)
    host = dict(
        marks=np.full((1, MAX_MARKS), -1, np.int32),
        miss_k=np.minimum(iss, rng.integers(0, 9, (1, K))).astype(np.float32),
        iss_k=iss,
        retry_drop_k=(rng.integers(0, 3, (1, K))
                      * (rng.uniform(size=(1, K)) < 0.1)).astype(np.float32),
        shed_k=(rng.integers(0, 3, (1, K))
                * (rng.uniform(size=(1, K)) < 0.1)).astype(np.float32),
        open_now=rng.uniform(size=(1, K, M)) < 0.05)
    host["marks"][0, :2] = (7, 9)
    prev_open = rng.uniform(size=(1, K, M)) < 0.05
    rings = {}
    for where in ("cpu", dev):
        kw = {k: torch.from_numpy(v).to(where) for k, v in host.items()}
        kw["ctl_deltas"] = tuple(torch.tensor([v], dtype=torch.float32,
                                              device=where)
                                 for v in (1.0, 0.0, 2.0))
        pids = torch.arange(K, dtype=torch.int32, device=where)
        rec = obr.recorder_init(rcfg, K, M, True, lanes=1, device=where)
        rec = rec._replace(prev_open=torch.from_numpy(prev_open).to(where))
        if where == dev:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            rec = obr.record_step(rcfg, rec, t_idx=7, pids=pids, **kw)
        finally:
            if where == dev:
                torch.cuda.set_sync_debug_mode(0)
        rings[str(where)] = rec
    check_same_ring(rings["cpu"], rings[str(dev)], "record_step card vs cpu")
    rec = rings[str(dev)]
    return dict(no_host_sync=True, equals_cpu=True,
                events_appended=obr.events_appended(rec),
                events_dropped=obr.events_dropped(rec))


def phase_recorder(dev, neutral_steps_per_s: float) -> None:
    """The flight recorder in the fleet's step, free of host syncs, the
    obs smoke on the card, and lane-batched rings (module docstring)."""
    import dataclasses
    import statistics
    import tempfile
    import torch
    from repro_torch.continuum import (SimConfig, compile_scenario,
                                       get_library, lane, make_topology,
                                       run_sim_grid, run_sim_stream,
                                       stack_drivers)
    from repro_torch.core import prand
    from repro_torch.obs import recorder as obr
    from repro_torch.obs import runlog
    from repro_torch.obs.__main__ import main as obs_main
    t_phase = time.perf_counter()

    # (a) the anchor fleet, recorder off and on in interleaved pairs
    cfg_off, rtt = fleet_inputs(dev, FLEET["horizon"])
    cfg_on = dataclasses.replace(cfg_off, recorder=obr.RecorderConfig(
        capacity=RECORDER["capacity"]))
    steps = cfg_off.num_steps
    each = dict(round_step_swrr=steps, fused_maintenance=steps)
    runs, ratios = [], []
    for pair in range(RECORDER["pairs"]):
        for label, cfg in (("off", cfg_off), ("on", cfg_on)):
            base = memory_baseline(dev)
            for fn in all_kernels():
                fn.launches = 0
            t0 = time.perf_counter()
            out = run_sim_stream("qedgeproxy", rtt, cfg, 7, device=dev)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = sim_launches()
            if launches != each:
                raise AssertionError(f"recorder (a) {label}: launches "
                                     f"{launches}, the path needs {each}")
            runs.append(dict(pair=pair, recorder=label, steps_per_s=steps
                             / secs, seconds=secs,
                             peak_mem_bytes=peak_above(dev, base), **base))
            if label == "off":
                off = out
            else:
                check_identical(off, out, f"recorder (a) pair {pair} on "
                                          f"vs off")
                on = out
                ratios.append(runs[-2]["steps_per_s"]
                              / runs[-1]["steps_per_s"])
    emit(phase="recorder", part="a_fleet", K=FLEET["K"], M=FLEET["M"],
         steps=steps, capacity=RECORDER["capacity"], runs=runs,
         time_ratio_on_over_off=ratios,
         median_ratio=statistics.median(ratios),
         neutral_fleet_steps_per_s=neutral_steps_per_s,
         peak_mem_above_off_bytes=runs[-1]["peak_mem_bytes"]
         - runs[-2]["peak_mem_bytes"],
         events_appended=obr.events_appended(on.rec),
         events_dropped=obr.events_dropped(on.rec),
         events_per_step=obr.events_appended(on.rec) / steps,
         launches=each, identical_to_off=True)

    # (b) one record_step at the fleet's shapes, no host sync
    emit(phase="recorder", part="b_no_host_sync", **recorder_sync_check(dev))

    # (c) the obs smoke on the card
    for fn in all_kernels():
        fn.launches = 0
    horizon = RECORDER["smoke_horizon"]
    with tempfile.TemporaryDirectory() as d:
        text = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            rc = obs_main(["smoke", "--horizon", str(horizon), "--device",
                           str(dev), "--out", d])
        secs = time.perf_counter() - t0
        lines = text.getvalue().splitlines()
        validation = runlog.validate_run(d)
        events = runlog.load_run(d)["events"]
    launches = sim_launches()
    smoke_steps = int(round(horizon / SimConfig().dt))
    need = dict(round_step_swrr=0, fused_maintenance=2 * smoke_steps)
    kinds: dict = {}
    for e in events["events"]:
        kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
    emit(phase="recorder", part="c_obs_smoke", horizon_s=horizon, rc=rc,
         seconds=secs, output=lines, kinds=kinds,
         appended=events["appended"], dropped=events["dropped"],
         validation=validation, launches=launches)
    if rc != 0 or "obs smoke OK" not in lines:
        raise AssertionError(f"obs smoke failed: {lines}")
    if any(validation.values()) or launches != need:
        raise AssertionError(f"obs smoke: validation {validation}, launches "
                             f"{launches} (the path needs {need})")

    # (d) two library scenarios as lanes, each ring its run alone's
    cfg = SimConfig(horizon=RECORDER["lanes_horizon"],
                    recorder=obr.RecorderConfig(capacity=RECORDER["capacity"]))
    names = RECORDER["lanes"]
    lib = get_library(cfg.horizon, 30, 10)
    drivers = [compile_scenario(lib[n], cfg, 500 + i, device=dev)
               for i, n in enumerate(names)]
    rtts = torch.stack([make_topology(i + 1, 30, 10, device=dev)
                        .lb_instance_rtt() for i in range(len(names))])
    keys = torch.stack([prand.prng_key(101 + i, dev)
                        for i in range(len(names))])
    T = cfg.num_steps
    for fn in all_kernels():
        fn.launches = 0
    out = run_sim_grid("qedgeproxy", rtts, cfg, keys,
                       drivers=stack_drivers(drivers), device=dev)
    launches = sim_launches()
    if launches != dict(round_step_swrr=T, fused_maintenance=T):
        raise AssertionError(f"recorder (d): launches {launches} for {T} "
                             f"steps of {len(names)} lanes")
    appended = []
    for s in range(len(names)):
        one = run_sim_stream("qedgeproxy", rtts[s], cfg, keys[s],
                             drivers=drivers[s], device=dev)
        ln = lane(out, s)
        check_identical(ln, one, f"recorder (d) lane {s}")
        check_same_ring(ln.rec, one.rec, f"recorder (d) lane {s} ring")
        appended.append(obr.events_appended(one.rec))
    secs = time.perf_counter() - t_phase
    emit(phase="recorder", part="d_lanes", lanes=list(names), steps=T,
         launches=launches, events_appended=appended,
         every_ring_identical=True, phase_seconds=secs,
         within_budget=secs <= RECORDER["budget_s"])


def payload_cells(lane: str) -> dict:
    """The reference payload's cells of ``lane``: {scenario: {policy:
    cell}}."""
    return json.loads((ROOT / PAYLOAD).read_text())[lane]


def check_cells(lane: str, rows: dict, optional: set) -> None:
    """Every readout finite; each cell's keys those of the reference
    payload's cell, but ``optional`` (keys present only where an event
    recovered inside the horizon)."""
    ref = payload_cells(lane)
    for name, row in rows.items():
        for label, cell in row.items():
            bad = [k for k, v in cell.items()
                   if isinstance(v, float) and not np.isfinite(v)]
            if bad:
                raise AssertionError(f"{lane} {name} {label}: non-finite "
                                     f"{bad}")
            want = set(ref[name][label]) - optional
            if set(cell) - optional != want:
                raise AssertionError(f"{lane} {name} {label}: keys "
                                     f"{sorted(cell)}, the reference's "
                                     f"{sorted(ref[name][label])}")


def lane_phase_launches(phase: str, suite: dict, resilient) -> None:
    """Each policy's launches: maintenance once a step, the round kernel
    once a step only without the request lifecycle."""
    T = suite["config"].cfg.num_steps
    for label, timing in suite["timings"].items():
        sim = {k: timing["launches"][k] for k in sim_launches()}
        n = 0 if resilient(label) else T
        emit(phase=f"{phase}_policy", policy=label, lanes=timing["lanes"],
             steps=T, seconds=timing["seconds"],
             grid_steps_per_s=timing["grid_steps_per_s"], launches=sim)
        if sim != dict(round_step_swrr=n, fused_maintenance=T):
            raise AssertionError(f"{phase} {label}: launches {sim}, the path "
                                 f"needs {n} and {T}")


def phase_degradation(dev) -> None:
    """The graceful-degradation lane on the card: the smoke probe under
    the five request-lifecycle policies."""
    import torch
    from repro_torch.bench import scenarios as bs
    t0 = time.perf_counter()
    suite = bs.get_degradation_suite(dev, smoke=True,
                                     horizon=DEGRADE_HORIZON)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    rows = bs.graceful_degradation(suite)
    lane_phase_launches("degradation", suite, lambda label: label != "neutral")
    for (name, label), run in suite["runs"].items():
        check_lifecycle_conservation(run.acc, 0.0)
    for name in suite["names"]:
        emit(phase="degradation_row", scenario=name, **rows[name])
    check_cells("graceful_degradation", rows, set())
    emit(phase="degradation", scenarios=suite["names"],
         steps=suite["config"].cfg.num_steps, seconds=secs,
         device=suite["device"])
    row = rows["retry_storm"]
    if not row["bounded"]["worst_dip"] >= row["neutral"]["worst_dip"]:
        raise AssertionError(f"bounded worst dip {row['bounded']} below "
                             f"neutral's {row['neutral']}")
    if not row["naive"]["retry_rate"] >= row["bounded"]["retry_rate"]:
        raise AssertionError(f"naive retry rate {row['naive']['retry_rate']} "
                             f"below bounded's {row['bounded']['retry_rate']}")


def phase_closed_loop(dev) -> None:
    """The closed-loop lane on the card: the smoke probes on the fleet
    with its standby pool, under the eight control policies."""
    import torch
    from repro_torch.bench import scenarios as bs
    t0 = time.perf_counter()
    suite = bs.get_control_suite(dev, smoke=True, horizon=CONTROL_HORIZON)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    rows = bs.closed_loop(suite)
    lane_phase_launches("closed_loop", suite, lambda label: True)
    for (name, label), run in suite["runs"].items():
        check_lifecycle_conservation(
            run.acc, 0.0 if run.ctrl is None else float(run.ctrl.shed_k.sum()))
    for name in suite["names"]:
        emit(phase="closed_loop_row", scenario=name, **rows[name])
    check_cells("closed_loop", rows, {"max_recovery_s"})
    emit(phase="closed_loop", scenarios=suite["names"],
         steps=suite["config"].cfg.num_steps, seconds=secs,
         device=suite["device"])
    for name, row in rows.items():
        pre, static = row["prewarmed"], row["static"]
        if not (pre["drop_rate"] <= 0.01 and pre["qos_sat_pct"] >= 90.0):
            raise AssertionError(f"{name}: prewarmed {pre}")
        if not static["drop_rate"] > pre["drop_rate"]:
            raise AssertionError(f"{name}: static drop rate "
                                 f"{static['drop_rate']} not above "
                                 f"prewarmed's {pre['drop_rate']}")


def phase_multi_tenant(dev) -> None:
    """The multi-tenant lane on the card: (a) the tenant library as the
    lanes of one run per policy with the lane's gates, and its
    ``qedgeproxy`` run against the same run on the CPU, which a process
    of its own computes meanwhile (``tenant_lanes_cpu``); (b) one lane
    alone against its lane, and the smoke lanes alone on the card
    against the CPU, (c) that run chunked and resumed."""
    import tempfile
    import torch
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cpu_path = str(Path(tmp) / "cpu_lanes.pt")
        cpu_proc = torch.multiprocessing.get_context("spawn").Process(
            target=tenant_lanes_cpu, args=(MULTI_TENANT["horizon"],
                                           cpu_path))
        cpu_proc.start()
        try:
            multi_tenant_card_runs(dev, t0, cpu_proc, cpu_path)
        finally:
            if cpu_proc.is_alive():
                cpu_proc.kill()
            cpu_proc.join()


def multi_tenant_card_runs(dev, t0: float, cpu_proc, cpu_path: str) -> None:
    """``phase_multi_tenant``'s card runs and checks, while ``cpu_proc``
    writes the CPU's run to ``cpu_path``."""
    import tempfile
    import torch
    from repro_torch.bench import scenarios as bs
    from repro_torch.continuum import (lane, run_sim_grid, run_sim_stream,
                                       stack_drivers)
    from repro_torch.obs import registry
    NT = bs.MT_TENANTS
    # (a) the four tenant scenarios as the lanes of one run per policy
    base = memory_baseline(dev)
    for fn in all_kernels():
        fn.launches = 0
    suite = bs.get_multi_tenant_suite(dev, horizon=MULTI_TENANT["horizon"])
    torch.cuda.synchronize()
    peak = peak_above(dev, base)
    payload = bs.multi_tenant(suite)
    T = suite["config"].cfg.num_steps
    for label, timing in suite["timings"].items():
        sim = {k: timing["launches"][k] for k in sim_launches()}
        emit(phase="multi_tenant_policy", policy=label, lanes=timing["lanes"],
             tenants=NT, steps=T, seconds=timing["seconds"],
             grid_steps_per_s=timing["grid_steps_per_s"],
             reference_smoke_floor=bs.MT_SMOKE_FLOOR, launches=sim)
        n = NT * T if label == "qedgeproxy" else 0
        if sim != dict(round_step_swrr=0, fused_maintenance=n):
            raise AssertionError(f"multi_tenant {label}: launches {sim}, the "
                                 f"path needs maintenance {n} times "
                                 f"({NT} a step) and the round kernel never")
    for (name, label), run in suite["runs"].items():
        for acc in run.acc:
            check_conservation(acc)
    for name in suite["names"]:
        emit(phase="multi_tenant_row", scenario=name, **payload[name])
    for name, want in MT_REQUESTS.items():
        for label, _ in bs.MT_POLICIES:
            got = payload[name][label]["tenant_requests"]
            if got != want:
                raise AssertionError(f"multi_tenant {name} {label}: "
                                     f"tenant_requests {got}, the "
                                     f"reference's {want}")
    row = payload["mt_baseline"]
    qep, pm = row["qedgeproxy"], row["proxy_mity_1.0"]
    for s in range(NT):
        q, p = qep["tenant_qos_sat_pct"][s], pm["tenant_qos_sat_pct"][s]
        if not (q >= 90.0 and q > p):
            raise AssertionError(f"mt_baseline tenant {s}: qedgeproxy {q}% "
                                 f"clients >= rho, proxy_mity {p}%")
    for label, cell in row.items():
        if cell["jain_load"] != 1.0:
            raise AssertionError(f"mt_baseline {label}: jain_load "
                                 f"{cell['jain_load']}")
    a_s = time.perf_counter() - t0

    # (b) one lane alone against its lane, at a shorter horizon
    conf, cfg, names, rtts, keys, drivers = bs.mt_inputs(
        dev, horizon=MULTI_TENANT["alone_horizon"])
    i = names.index(MULTI_TENANT["alone"])
    grid = run_sim_grid("qedgeproxy", rtts, cfg, keys,
                        drivers=stack_drivers(drivers),
                        warmup_steps=conf.warm, device=dev)
    kw = dict(drivers=drivers[i], warmup_steps=conf.warm, device=dev)
    alone = run_sim_stream("qedgeproxy", rtts[i], cfg, keys[i], **kw)
    check_identical(lane(grid, i), alone,
                           f"{names[i]} alone vs its lane")
    # (c) the same run in chunks, and stopped into a checkpoint and resumed
    chunked = run_sim_stream("qedgeproxy", rtts[i], cfg, keys[i],
                             chunk_steps=MULTI_TENANT["chunk_steps"], **kw)
    check_identical(chunked, alone, "chunked vs whole")
    with tempfile.TemporaryDirectory() as d:
        ck = dict(chunk_steps=MULTI_TENANT["chunk_steps"], checkpoint_dir=d)
        part = run_sim_stream("qedgeproxy", rtts[i], cfg, keys[i],
                              stop_at_step=MULTI_TENANT["stop_at"], **ck,
                              **kw)
        if part.series.succ.shape[0] != MULTI_TENANT["stop_at"]:
            raise AssertionError(f"stopped run: {part.series.succ.shape[0]} "
                                 f"steps")
        resumed = run_sim_stream("qedgeproxy", rtts[i], cfg, keys[i],
                                 resume=True, **ck, **kw)
    check_identical(resumed, alone, "resumed vs whole")
    # (a) also: the 24 s card run against the same run on the CPU
    t_wait = time.perf_counter()
    cpu_proc.join()
    if cpu_proc.exitcode != 0:
        raise RuntimeError(f"the CPU's multi-tenant run exited with "
                           f"{cpu_proc.exitcode}")
    cpu = torch.load(cpu_path, weights_only=False)
    lanes_vs_cpu = tenant_lanes_card_vs_cpu(suite, cpu)
    emit(phase="multi_tenant_lanes_card_vs_cpu",
         horizon=MULTI_TENANT["horizon"], steps=T,
         equal=all(r["equal"] for r in lanes_vs_cpu.values()),
         cpu_seconds=cpu["seconds"],
         waited_s=time.perf_counter() - t_wait,
         oracle_mu_tol=ORACLE_MU_TOL, runs=lanes_vs_cpu)
    # (b) also: the card's tenant step against the CPU's
    vs_cpu = tenant_card_vs_cpu(dev)
    emit(phase="multi_tenant_card_vs_cpu", horizon=MULTI_TENANT["cpu_horizon"],
         oracle_mu_tol=ORACLE_MU_TOL, runs=vs_cpu)
    for run, r in vs_cpu.items():
        over = {f: e for f, e in r["oracle"].items() if not e[0] <= e[1]}
        if r["differ"] or over:
            raise AssertionError(f"{run}: the tenant step on the card differs "
                                 f"from the CPU's in {r['differ']}, the "
                                 f"oracle past its bound in {over}")
    secs = time.perf_counter() - t0
    emit(phase="multi_tenant", scenarios=suite["names"], tenants=NT,
         steps=T, lane_seconds=a_s, alone_steps=cfg.num_steps,
         alone_equals_lane=True, chunked_equals_whole=True,
         resumed_equals_whole=True, peak_mem_bytes=peak, **base,
         seconds=secs, budget_s=MULTI_TENANT["budget_s"],
         card=nvidia_smi(), device=suite["device"])
    cell = registry.tenant_cell(alone, rho=cfg.rho)
    emit(phase="multi_tenant_alone", scenario=names[i], **cell)


def players_rank(fleet: tuple, grid: tuple, warm_fleet: tuple,
                 warm_grid: tuple) -> dict:
    """One rank of the players phase: (a) the fleet on a players mesh of
    every rank, (b) the lanes on a data mesh of every rank; each first
    run short (``warm_*``: the same shapes, a few steps) to load the
    kernels and warm the allocator, then timed with this rank's kernel
    launches, all-reduces, seconds and peak memory above what the rank
    held before it. Then one round's (1, M) arrivals all-reduced alone
    over the players axis, 200 times: the collective's milliseconds a
    call."""
    import torch
    import torch.distributed as dist
    from repro_torch.continuum import run_sim_grid, run_sim_players
    from repro_torch.launch.mesh import make_continuum_mesh, make_grid_mesh
    from repro_torch.sharding.collectives import all_reduce
    dev = torch.device("cuda", torch.cuda.current_device())
    fmesh, gmesh = make_continuum_mesh(), make_grid_mesh()

    def run(part, args):
        if part == "fleet":
            return run_sim_players(*args, mesh=fmesh, device=dev)
        return run_sim_grid(*args[:4], drivers=args[4], warmup_steps=args[5],
                            mesh=gmesh, device=dev)

    calls = [0]
    reduce = dist.all_reduce

    def counted(*a, **k):
        calls[0] += 1
        return reduce(*a, **k)

    out = {}
    for part, args, short in (("fleet", fleet, warm_fleet),
                              ("grid", grid, warm_grid)):
        run(part, short)
        base = memory_baseline(dev)
        for k in all_kernels():
            k.launches = 0
        calls[0] = 0
        dist.all_reduce = counted
        try:
            t0 = time.perf_counter()
            res = run(part, args)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            dist.all_reduce = reduce
        out[part] = dict(result=res, seconds=secs, launches=sim_launches(),
                         all_reduces=calls[0],
                         peak_mem_bytes=peak_above(dev, base))
    group = fmesh.axis("players").group
    x = torch.ones(1, fleet[1].shape[1], device=dev)
    for _ in range(10):
        all_reduce(x, group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        all_reduce(x, group)
    torch.cuda.synchronize()
    out["all_reduce_ms"] = (time.perf_counter() - t0) / 200 * 1e3
    return out


def phase_players(dev) -> None:
    """Player sharding and the sharded grid on two gloo ranks of the one
    card, each against the same run unsharded on the card."""
    import dataclasses
    import torch
    from repro_torch.continuum import (lane, run_sim_grid, run_sim_stream,
                                       slice_drivers, stack_drivers)
    from repro_torch.launch.mesh import spawn, to_host
    t0 = time.perf_counter()
    D = PLAYERS["ranks"]
    cfg, rtt = fleet_inputs(dev, PLAYERS["horizon"])
    T = cfg.num_steps
    # the lanes phase's scenarios, their first lanes_horizon seconds
    lcfg, rtts, keys, drivers = lanes_inputs(dev)
    lcfg = type(lcfg)(horizon=PLAYERS["lanes_horizon"])
    stacked = stack_drivers([slice_drivers(d, 0, lcfg.num_steps)
                             for d in drivers])
    # the warm-up: both runs cut to warm_horizon, the same shapes
    wcfg = dataclasses.replace(cfg, horizon=PLAYERS["warm_horizon"])
    wlcfg = type(lcfg)(horizon=PLAYERS["warm_horizon"])
    wstacked = stack_drivers([slice_drivers(d, 0, wlcfg.num_steps)
                              for d in drivers])
    ranks = spawn(players_rank, D,
                  ("qedgeproxy", rtt.cpu(), cfg, 7),
                  ("qedgeproxy", rtts.cpu(), lcfg, keys.cpu(),
                   to_host(stacked), LANES["warm"]),
                  ("qedgeproxy", rtt.cpu(), wcfg, 7),
                  ("qedgeproxy", rtts.cpu(), wlcfg, keys.cpu(),
                   to_host(wstacked), 0),
                  every_rank=True, timeout=PLAYERS["budget_s"] * 4)
    spawn_s = time.perf_counter() - t0
    # (a) against the fleet unsharded, on the fused round
    t1 = time.perf_counter()
    plain = run_sim_stream("qedgeproxy", rtt, cfg, 7, device=dev)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t1
    got = ranks[0]["fleet"]["result"]
    for r, rk in enumerate(ranks):
        need = dict(round_step_swrr=0, fused_maintenance=T)
        if rk["fleet"]["launches"] != need:
            raise AssertionError(f"players (a) rank {r}: launches "
                                 f"{rk['fleet']['launches']}, the sharded "
                                 f"path needs {need}")
        n = lcfg.num_steps
        if rk["grid"]["launches"] != dict(round_step_swrr=n,
                                          fused_maintenance=n):
            raise AssertionError(f"players (b) rank {r}: launches "
                                 f"{rk['grid']['launches']} in {n} steps")
    for f in plain.acc._fields:
        if not torch.equal(getattr(got.acc, f), getattr(plain.acc, f).cpu()):
            raise AssertionError(f"players (a): acc.{f} differs from the "
                                 f"unsharded run")
    for f in ("succ", "issued", "attempts"):
        if not torch.equal(getattr(got.series, f), getattr(plain.series, f)):
            raise AssertionError(f"players (a): series.{f} differs")
    a, b = got.series.regret.double(), plain.series.regret.double()
    regret_err = float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
    if not bool(((a - b).abs() <= PLAYERS["regret_rtol"] * b.abs()).all()):
        raise AssertionError(f"players (a): regret series apart by "
                             f"{regret_err} (rtol {PLAYERS['regret_rtol']})")
    check_conservation(got.acc)
    # (b) each lane against the same lane unsharded
    grid_plain = run_sim_grid("qedgeproxy", rtts, lcfg, keys,
                              drivers=stacked, warmup_steps=LANES["warm"],
                              device=dev)
    grid = ranks[0]["grid"]["result"]
    for s in range(len(drivers)):
        check_identical(lane(grid, s), to_host(lane(grid_plain, s)),
                        f"players (b) lane {s} vs the lane unsharded")
    secs = time.perf_counter() - t0
    step_ms = ranks[0]["fleet"]["seconds"] / T * 1e3
    reduces = ranks[0]["fleet"]["all_reduces"]
    emit(phase="players", ranks=D, K=FLEET["K"], M=FLEET["M"], steps=T,
         sharded_seconds=ranks[0]["fleet"]["seconds"],
         sharded_steps_per_s=T / ranks[0]["fleet"]["seconds"],
         unsharded_steps_per_s=T / plain_s,
         rank_all_reduces=[rk["fleet"]["all_reduces"] for rk in ranks],
         all_reduce_ms=[rk["all_reduce_ms"] for rk in ranks],
         all_reduce_share_of_run=reduces * ranks[0]["all_reduce_ms"]
         / T / step_ms,
         rank_peak_mem_bytes=[rk["fleet"]["peak_mem_bytes"] for rk in ranks],
         rank_launches=[rk["fleet"]["launches"] for rk in ranks],
         regret_series_max_rel_err=regret_err, counts_exact=True,
         grid_lanes=len(drivers), grid_steps=lcfg.num_steps,
         grid_mesh=dict(data=D, players=1),
         grid_seconds=ranks[0]["grid"]["seconds"],
         grid_steps_per_s=len(drivers) * lcfg.num_steps
         / ranks[0]["grid"]["seconds"],
         grid_rank_launches=[rk["grid"]["launches"] for rk in ranks],
         grid_rank_peak_mem_bytes=[rk["grid"]["peak_mem_bytes"]
                                   for rk in ranks],
         every_lane_identical=True, spawn_seconds=spawn_s, seconds=secs,
         budget_s=PLAYERS["budget_s"], within_budget=secs <= PLAYERS[
             "budget_s"], card=nvidia_smi())


def tenant_alone(dev, horizon: float, name: str, label: str, kw: dict):
    """The multi-tenant lane's scenario ``name`` alone under policy
    ``label`` for ``horizon`` seconds on ``dev``: ``(queue, outputs,
    cell)``, the queue the final carry's (NT, M) backlog, the cell its
    ``obs.registry.tenant_cell``."""
    from repro_torch.bench import figures as bf
    from repro_torch.bench import scenarios as bs
    from repro_torch.continuum import StreamOutputs, build_sim_chunks
    from repro_torch.obs import registry
    conf, cfg, names, rtts, keys, drivers = bs.mt_inputs(dev, smoke=True,
                                                         horizon=horizon)
    i = names.index(name)
    init_fn, chunk_fn = build_sim_chunks(
        bf.strategy_name(label), cfg, *rtts.shape[1:],
        warmup_steps=conf.warm, **kw)
    carry, ks = init_fn(rtts[i], drivers[i].active[0], keys[i])
    carry, series = chunk_fn(rtts[i], carry, range(cfg.num_steps),
                             drivers[i], ks)
    outs = StreamOutputs(acc=carry[3], series=series)
    return carry[1], outs, registry.tenant_cell(outs, rho=cfg.rho)


def tenant_card_vs_cpu(dev) -> dict:
    """The tenant step on the card against the same step on the CPU
    (where the port equals the JAX package cell for cell at this
    horizon): each smoke scenario alone under ``qedgeproxy`` (the
    policy that also runs maintenance; the interference, drain and
    oracle are the same under every policy) for
    ``MULTI_TENANT["cpu_horizon"]`` seconds. The final queues, every
    count and latency field of every tenant's accumulator, the series
    but regret, and ``tenant_cell`` exactly equal; the oracle's fields
    (``ORACLE_FIELDS``) within ``oracle_bound``. ``{"<name>/<label>":
    {"differ": exact parts that differ, "oracle": {field: [max abs
    error, least bound] over the tenants}}}``, so that a fault says
    where it is."""
    import torch
    from repro_torch.bench import scenarios as bs
    h = MULTI_TENANT["cpu_horizon"]
    cpu, report = torch.device("cpu"), {}
    label, kw = bs.MT_POLICIES[0]
    for name in bs.SMOKE_MT_SCENARIOS:
        q_d, d, cell_d = tenant_alone(dev, h, name, label, kw)
        q_c, c, cell_c = tenant_alone(cpu, h, name, label, kw)
        report[f"{name}/{label}"] = compare_tenant_runs(
            d, c, cell_d, cell_c, [("queue", "queue", q_d, q_c)])
    return report


def compare_tenant_runs(d, c, cell_d: dict, cell_c: dict,
                        parts: list | None = None) -> dict:
    """A tenant run on the card (``d``, its ``tenant_cell`` ``cell_d``)
    against the same run on the CPU, part by part in order (``parts``
    first, then every tenant's accumulator fields, the series, the
    cell): ``{"differ": the parts not exactly equal, "oracle": {field:
    [max abs error, least bound]}}``, the oracle's fields
    (``ORACLE_FIELDS``) held to ``oracle_bound`` instead of equality."""
    import torch
    T, K = c.series.succ.shape[0], c.acc[0].regret_k.shape[0]
    parts = list(parts or [])
    parts += [(f"acc[{t}].{f}", f, getattr(x, f), getattr(y, f))
              for t, (x, y) in enumerate(zip(d.acc, c.acc))
              for f in x._fields]
    parts += [(f"series.{f}", f, getattr(d.series, f),
               getattr(c.series, f)) for f in d.series._fields]
    differ, oracle = [], {}
    for part, f, x, y in parts:
        x = x.cpu()
        if f in ORACLE_FIELDS:
            err, bound = oracle.get(f, (0.0, float("inf")))
            oracle[f] = [max(err, float((x - y).abs().max())),
                         min(bound, oracle_bound(f, y, T, K))]
        elif not torch.equal(x, y):
            differ.append(part)
    differ += [f"tenant_cell.{k}" for k in cell_d
               if cell_d[k] != cell_c.get(k)]
    return dict(differ=differ, oracle=oracle)


def tenant_lanes_cpu(horizon: float, path: str) -> None:
    """The multi-tenant lane's ``qedgeproxy`` run (its four scenarios as
    lanes) on the CPU for ``horizon`` seconds, each lane's outputs saved
    to ``path`` with the run's seconds. ``phase_multi_tenant`` runs this
    in a process of its own beside its card runs, so the CPU's run costs
    the script no time of its own."""
    import dataclasses
    import torch
    from repro_torch.bench import figures as bf
    from repro_torch.bench import scenarios as bs
    from repro_torch.continuum import lane, stack_drivers
    torch.set_num_threads(2)
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    conf, cfg, names, rtts, keys, drivers = bs.mt_inputs(cpu,
                                                         horizon=horizon)
    label, kw = bs.MT_POLICIES[0]
    out, _ = bf.run_lanes(label, kw, rtts, keys, stack_drivers(drivers),
                          dataclasses.replace(conf, cfg=cfg), cpu)
    torch.save(dict(names=names, label=label, rho=cfg.rho,
                    runs=[lane(out, i) for i in range(len(names))],
                    seconds=time.perf_counter() - t0), path)


def tenant_lanes_card_vs_cpu(suite: dict, cpu: dict) -> dict:
    """The multi-tenant lane's ``qedgeproxy`` run on the card (in
    ``suite``) against the same run on the CPU (``tenant_lanes_cpu``'s
    ``cpu``), lane by lane (``compare_tenant_runs``): the policy that
    runs the maintenance kernel, whose ``mu`` is bit-exact to its plain
    version; proxy-mity launches no kernel of the simulator.
    ``{"<name>/qedgeproxy": {"equal", "first_differing", "differ",
    "oracle"}}``, reported, not gated."""
    from repro_torch.obs import registry
    report, label, rho = {}, cpu["label"], cpu["rho"]
    for name, c in zip(cpu["names"], cpu["runs"]):
        d = suite["runs"][(name, label)]
        r = compare_tenant_runs(d, c, registry.tenant_cell(d, rho=rho),
                                registry.tenant_cell(c, rho=rho))
        over = [f for f, (err, bound) in r["oracle"].items()
                if not err <= bound]
        parted = r["differ"] + [f"oracle.{f}" for f in over]
        report[f"{name}/{label}"] = dict(equal=not parted,
                                         first_differing=(parted or [None])[0],
                                         **r)
    return report


def oracle_bound(field: str, cpu_value, T: int, K: int) -> float:
    """How far the card's oracle field may lie from the CPU's: its n
    terms (``prev_mu`` one, a player's regret and variation budget one
    a step, a step's regret one a player) each within 2 ``ORACLE_MU_TOL``
    and one float32 spacing of the field's largest value."""
    n = dict(prev_mu=1, regret_k=T, vb_k=T, regret=K)[field]
    top = np.float32(float(cpu_value.abs().max()))
    return n * (2 * ORACLE_MU_TOL + float(np.spacing(top)))


def phase_baselines(dev) -> None:
    """Fused round against the round scan on the card, both strategies
    that have a fused round."""
    import torch
    from repro_torch.continuum import SimConfig, make_topology, run_sim_stream
    rtt = make_topology(1, 30, 10, device=dev).lb_instance_rtt()
    steps = SimConfig(horizon=BASELINES["horizon"]).num_steps
    for name, kw, fused_needs, scan_needs in (
            ("qedgeproxy", {}, dict(round_step_swrr=steps,
                                    fused_maintenance=steps),
             dict(round_step_swrr=0, fused_maintenance=steps)),
            ("proxy_mity", dict(alpha=0.9), dict(round_step_swrr=0,
                                                 fused_maintenance=0),
             dict(round_step_swrr=0, fused_maintenance=0))):
        outs = {}
        for fused, needs in ((True, fused_needs), (False, scan_needs)):
            cfg = SimConfig(horizon=BASELINES["horizon"], fused_round=fused)
            for fn in all_kernels():
                fn.launches = 0
            t0 = time.perf_counter()
            outs[fused] = run_sim_stream(name, rtt, cfg, BASELINES["key"],
                                         warmup_steps=BASELINES["warm"],
                                         device=dev, **kw)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = sim_launches()
            emit(phase="baselines", strategy=name, fused_round=fused,
                 steps=steps, seconds=secs, steps_per_s=steps / secs,
                 launches=launches, **kw)
            check_conservation(outs[fused].acc)
            if launches != needs:
                raise AssertionError(f"{name} fused_round={fused}: launches "
                                     f"{launches}, the path needs {needs}")
        check_identical(outs[True], outs[False], f"{name} fused vs scan")


def phase_suite(dev) -> None:
    """The paper's evaluation suite through the port's own harness."""
    import torch
    from repro_torch.bench import figures as bf
    for fn in all_kernels():
        fn.launches = 0
    t0 = time.perf_counter()
    suite = bf.get_suite(dev, seeds=SUITE["seeds"], horizon=SUITE["horizon"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    totals = sim_launches()
    T = suite.config.cfg.num_steps
    for (seed, label), run in suite.runs.items():
        check_conservation(run.acc)
    for label, timing in suite.timings.items():
        sim = {k: timing["launches"][k] for k in totals}
        emit(phase="suite_strategy", strategy=label, lanes=timing["lanes"],
             steps=T, seconds=timing["seconds"],
             grid_steps_per_s=timing["grid_steps_per_s"], launches=sim)
        n = T if label == "qedgeproxy" else 0
        if sim != dict(round_step_swrr=n, fused_maintenance=n):
            raise AssertionError(f"suite {label}: launches {sim}, the path "
                                 f"needs {n} of each for all its lanes")
    if totals != dict(round_step_swrr=T, fused_maintenance=T):
        raise AssertionError(f"suite launches {totals}")
    fig3, fig4 = bf.fig3_qos_success(suite), bf.fig4_fairness(suite)
    fig5, fig8 = bf.fig5_per_client(suite), bf.fig8_p90_latency(suite)
    headline = {label: dict(
        clients_ge_rho_pct=fig3[label]["per_scenario"],
        clients_ge_rho_mean=fig3[label]["mean"],
        jain=fig4[label]["per_scenario"],
        clients_below_target=fig5[label]["clients_below_target"],
        n_clients=fig5[label]["n_clients"],
        max_p90_ms=fig8[label]["max_ms"]) for label, _ in bf.STRATEGIES}
    emit(phase="suite", seeds=list(suite.config.seeds), steps=T,
         warmup_steps=suite.config.warm, seconds=secs, launches=totals,
         device=suite.device, figures=headline)
    qep = fig3["qedgeproxy"]
    if not min(qep["per_scenario"]) >= 90.0:
        raise AssertionError(f"qedgeproxy clients >= rho {qep}")
    for label in ("proxy_mity_1.0", "proxy_mity_0.9", "dec_sarsa"):
        strict = label.startswith("proxy_mity")
        if not (qep["mean"] > fig3[label]["mean"] if strict
                else qep["mean"] >= fig3[label]["mean"]):
            raise AssertionError(f"qedgeproxy {qep['mean']}% against "
                                 f"{label} {fig3[label]['mean']}%")


def lanes_inputs(dev):
    """The lanes phase's four scenarios: (cfg, rtts, keys, drivers)."""
    import torch
    from repro_torch.continuum import (SimConfig, compile_scenario,
                                       get_library, make_topology)
    from repro_torch.core import prand
    cfg = SimConfig(horizon=LANES["horizon"])
    lib = get_library(cfg.horizon, 30, 10)
    drivers = [compile_scenario(lib[n], cfg, 500 + i, device=dev)
               for i, n in enumerate(LANES["scenarios"])]
    rtts = torch.stack([make_topology(i + 1, 30, 10, device=dev)
                        .lb_instance_rtt() for i in range(len(drivers))])
    keys = torch.stack([prand.prng_key(101 + i, dev)
                        for i in range(len(drivers))])
    return cfg, rtts, keys, drivers


def phase_lanes(dev) -> None:
    """Four library scenarios as the lanes of one fused ``qedgeproxy``
    run: each lane equal to its run alone, one launch of each simulator
    kernel a step for all of them."""
    import torch
    from repro_torch.continuum import (client_qos_satisfaction_stream, lane,
                                       run_sim_grid, run_sim_stream,
                                       stack_drivers)
    cfg, rtts, keys, drivers = lanes_inputs(dev)
    S, T = len(drivers), cfg.num_steps
    for fn in all_kernels():
        fn.launches = 0
    t0 = time.perf_counter()
    out = run_sim_grid("qedgeproxy", rtts, cfg, keys,
                       drivers=stack_drivers(drivers),
                       warmup_steps=LANES["warm"], device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = sim_launches()
    if launches != dict(round_step_swrr=T, fused_maintenance=T):
        raise AssertionError(f"lanes: launches {launches} for {T} steps of "
                             f"{S} lanes, the path needs {T} of each")
    alone_s = []
    for s in range(S):
        t1 = time.perf_counter()
        one = run_sim_stream("qedgeproxy", rtts[s], cfg, keys[s],
                             drivers=drivers[s], warmup_steps=LANES["warm"],
                             device=dev)
        torch.cuda.synchronize()
        alone_s.append(time.perf_counter() - t1)
        ln = lane(out, s)
        check_conservation(ln.acc)
        check_identical(ln, one, f"lane {s} ({LANES['scenarios'][s]}) vs "
                                 f"its run alone")
        emit(phase="lanes_lane", lane=s, scenario=LANES["scenarios"][s],
             clients_ge_rho_pct=client_qos_satisfaction_stream(ln.acc,
                                                               cfg.rho),
             identical_to_alone=True, alone_seconds=alone_s[-1],
             alone_steps_per_s=T / alone_s[-1])
    emit(phase="lanes", lanes=S, K=30, M=10, steps=T, seconds=secs,
         grid_steps_per_s=S * T / secs, alone_seconds=sum(alone_s),
         alone_grid_steps_per_s=S * T / sum(alone_s), launches=launches,
         every_lane_identical=True)


def phase_scenarios(dev) -> None:
    """The scenario library as lanes under the contrast pair."""
    import torch
    from repro_torch.bench import scenarios as bs
    for fn in all_kernels():
        fn.launches = 0
    t0 = time.perf_counter()
    suite = bs.get_scenario_suite(dev, horizon=SCENARIO_HORIZON)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    rows = bs.scenario_rows(suite)
    T = suite["config"].cfg.num_steps
    for name in suite["names"]:
        for label, _ in bs.SUITE_STRATEGIES:
            check_conservation(suite["runs"][(name, label)].acc)
        emit(phase="scenario_row", scenario=name, **rows[name])
    for label, timing in suite["timings"].items():
        sim = {k: timing["launches"][k] for k in sim_launches()}
        n = T if label == "qedgeproxy" else 0
        emit(phase="scenario_strategy", strategy=label,
             lanes=timing["lanes"], steps=T, seconds=timing["seconds"],
             grid_steps_per_s=timing["grid_steps_per_s"], launches=sim)
        if sim != dict(round_step_swrr=n, fused_maintenance=n):
            raise AssertionError(f"scenarios {label}: launches {sim}, the "
                                 f"path needs {n} of each for all its lanes")
    emit(phase="scenarios", scenarios=len(suite["names"]), steps=T,
         seconds=secs, device=suite["device"])
    base = rows["baseline"]["qedgeproxy"]["qos_sat_pct"]
    if not base >= 90.0:
        raise AssertionError(f"qedgeproxy baseline clients >= rho {base}%")


def phase_events(dev) -> None:
    """Figs 10-11 on the card, every strategy, both events as lanes."""
    import torch
    from repro_torch.bench import figures as bf
    conf = bf._config(EVENTS["horizon"], SUITE["seeds"], False)
    T = conf.cfg.num_steps
    for fn in all_kernels():
        fn.launches = 0
    t0 = time.perf_counter()
    runs, timings = bf.get_events(conf, dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    for run in runs.values():
        check_conservation(run.acc)
    for label, timing in timings.items():
        sim = {k: timing["launches"][k] for k in sim_launches()}
        n = T if label == "qedgeproxy" else 0
        emit(phase="events_strategy", strategy=label, lanes=timing["lanes"],
             steps=T, seconds=timing["seconds"],
             grid_steps_per_s=timing["grid_steps_per_s"], launches=sim)
        if sim != dict(round_step_swrr=n, fused_maintenance=n):
            raise AssertionError(f"events {label}: launches {sim}, the path "
                                 f"needs {n} of each for both lanes")
    figs = {event: bf.event_payload(runs, event, conf)
            for event in bf.EVENTS}
    emit(phase="events", steps=T, warmup_steps=conf.warm, seconds=secs,
         fig10_client_surge=figs["surge"],
         fig11_instance_removal=figs["removal"])
    for event, fig in figs.items():
        post = fig["qedgeproxy"]["post_steady"]
        if not post >= EVENTS["min_post_steady"]:
            raise AssertionError(f"qedgeproxy post-event steady QoS {post} "
                                 f"< {EVENTS['min_post_steady']} ({event})")


def path_launches(cfg) -> tuple:
    """The launches of each serving kernel (by name) a prefill makes, and
    those a decode call makes: an attention layer launches
    ``flash_attention`` once a prefill and ``decode_attention`` once a
    decode call, an SSM layer ``ssd`` once a prefill. Whisper: each
    encoder layer and each decoder self-attention ``flash_attention`` (a
    served prompt is shorter than the encoder's frames, so the
    cross-attention is plain PyTorch), the decoder's self and cross
    attention ``decode_attention`` each."""
    from repro_torch.configs.base import AUDIO, HYBRID, SSM as SSM_FAMILY
    n = cfg.num_layers
    if cfg.family == AUDIO:
        return ({"flash_attention": cfg.encoder_layers + n},
                {"decode_attention": 2 * n})
    if cfg.family == SSM_FAMILY:
        return {"ssd": n}, {}
    prefill = {"flash_attention": n}
    if cfg.family == HYBRID:
        prefill["ssd"] = n
    return prefill, {"decode_attention": n}


def phase_serve(dev, phase: str, arch: str, requests: int = SERVE["requests"],
                slow_gate: bool = True,
                prompt_len: int = SERVE["prompt_len"]) -> dict:
    """The serving cell through the launcher a user runs, with ``arch``
    at its published width, ``requests`` rounds and prompts of
    ``prompt_len`` tokens; the launches prove the path: each serving
    kernel as often as ``path_launches`` says a prefill and a decode call
    launch it, maintenance once per router maintenance; ``slow_gate``:
    every front-end weighs the slow replica below each fast one. Returns
    the launch counts and the per-call medians."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    argv = ["--arch", arch, "--device", "cuda"]
    for key, val in {**SERVE, "requests": requests,
                     "prompt_len": prompt_len}.items():
        argv += [f"--{key.replace('_', '-')}", str(val)]
    cfg = get_config(arch)
    per_prefill, per_decode = path_launches(cfg)
    base = memory_baseline(dev)
    for fn in all_kernels():
        fn.launches = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        router = serve.main(argv)
    secs = time.perf_counter() - t0
    names = {*per_prefill, *per_decode, "fused_maintenance",
             "kde_success_prob"}
    launches = {fn.__name__: fn.launches for fn in all_kernels()
                if fn.__name__ in names}
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
         launches_per_prefill=per_prefill, launches_per_decode=per_decode,
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
    want = requests * SERVE["frontends"]
    if rep["microbatches"] != want or rep["prefills"] != want:
        raise AssertionError(f"{rep['prefills']} prefills, {want} requests")
    needs = [(name, n * rep["prefills"]) for name, n in per_prefill.items()]
    needs += [(name, n * rep["decodes"]) for name, n in per_decode.items()]
    needs += [("fused_maintenance", rep["maintenance_calls"]),
              ("kde_success_prob", 0)]
    for name, n in needs:
        if launches[name] != n:
            raise AssertionError(f"{name} launched {launches[name]} times, "
                                 f"the path needs {n}")
    if slow_gate and not all(w[k, slow] < w[k, m] for k in range(len(w))
                             for m in fast):
        raise AssertionError(f"slow replica {slow} not avoided: {w}")
    return dict(launches=launches, layers=cfg.num_layers,
                prefill_ms=prefill_ms, decode_ms=decode_ms)


def phase_decode_graph(dev, arch: str, steps: int = 4,
                       prompt: int = SERVE["prompt_len"], reduced: bool = False,
                       sync_check: bool = False) -> float | None:
    """The decode step replayed as a CUDA graph against the same step run
    eagerly, at the serve cell's batch and cache slots after a prompt of
    ``prompt`` tokens (after the VLM's patches, beside Whisper's frames,
    built as the launcher builds them: ``serve.request_batch``; past a
    window, the prefill masks and the ring wraps; past Whisper's
    ``max_decode_len``, its self ring wraps and the position clamps): two
    microbatches decode in turn (A0 A1 B0 B1 A2 B2 ...), so the graph
    copies a cache in when the other one was its last and replays on the
    one it holds otherwise. Both modes
    run the same kernels on the same inputs, so logits and every cache
    tensor must agree exactly, and the kernel wrappers' counts must read
    ``path_launches``' decode attention launches per decode call in both.
    Times a replayed call on the card (queued, ``cuda_ms``), on the host's
    clock (each call synchronised, as the serving engine times it), and
    the host's enqueue alone. When the host takes half a call's synchronised
    time or more to enqueue it (``host_bound``), the card cannot be got
    ahead of: the calls back to back are timed unqueued
    (``graph_call_wall_ms``, the slower of host and card) and the device
    fields are null.
    ``sync_check``: then one eager and one replayed decode call under
    ``torch.cuda.set_sync_debug_mode("error")`` (any host sync raises).
    ``reduced``: the config's ``reduced()`` variant. Returns the device
    time of one replayed decode call (ms), None when host-bound."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention
    from repro_torch.launch.serve import decode_start, request_batch
    from repro_torch.models import build_model
    cfg = get_config(arch, reduced=reduced)
    model = build_model(cfg, device=dev)
    B, S = SERVE["batch"], prompt
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = [torch.randint(0, cfg.vocab_size, (B, S + steps), generator=gen,
                            device=dev) for _ in range(2)]
    first = decode_start(cfg, S)
    slots = first + SERVE["decode_steps"]
    caches = [model.prefill(request_batch(cfg, t[:, :S], gen),
                            max_len=slots)[1] for t in tokens]
    order = [(m, j) for i in range(0, steps, 2) for m in range(2)
             for j in (i, i + 1) if j < steps]
    per_call = path_launches(cfg)[1].get("decode_attention", 0)
    layout = model.layout
    results = {}
    for mode in (False, True):
        model.decode_graphs = mode
        for fn in all_kernels():
            fn.launches = 0
        cs = [{key: tuple(t.clone() for t in c[key]) for key in layout}
              for c in caches]
        out = [[] for _ in tokens]
        for m, i in order:
            tok = tokens[m][:, S + i:S + i + 1].to(torch.int32)
            logits, cs[m] = model.decode(cs[m], {"token": tok,
                                                 "pos": first + i})
            out[m].append(logits)
        torch.cuda.synchronize()
        launched = decode_attention.decode_attention.launches
        if launched != per_call * len(order):
            raise AssertionError(f"decode_attention counted {launched} "
                                 f"launches in {len(order)} decode calls "
                                 f"(graphs {mode}), the path needs "
                                 f"{per_call * len(order)}")
        results[mode] = [torch.stack(o) for o in out] + [
            t for c in cs for key in layout for t in c[key]]
    errs = [(a.float() - b.float()).abs().max().item()
            for a, b in zip(results[False], results[True])]
    names = (*(f"logits_{m}" for m in "ab"),
             *(f"{key}.{i}_{m}" for m in "ab"
               for key in layout for i in range(len(layout[key]))))
    token = tokens[0][:, :1].to(torch.int32)
    c = cs[0]
    synced = {}
    if sync_check:
        for mode in (False, True):
            model.decode_graphs = mode
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                model.decode(c, {"token": token, "pos": first + steps})
            finally:
                torch.cuda.set_sync_debug_mode(0)
            synced["graph" if mode else "eager"] = "no host sync"
    call = lambda: model.decode(c, {"token": token,
                                    "pos": first + steps + 1})
    host_ms = []
    for _ in range(10):                  # as the serving engine times a call
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()             # the host's side alone: 10 calls
    for _ in range(10):
        call()
    enqueue_ms = (time.perf_counter() - t0) * 1e2
    torch.cuda.synchronize()
    # queued behind a sleep when the host enqueues a call in under half its
    # synchronised time; else the host holds the card back, and the time of
    # 10 calls back to back is the host's
    host_bound = enqueue_ms >= 0.5 * float(np.median(host_ms))
    # 3 calls of 20 ms or more: ten of qwen3-moe-30b-a3b's (~4,500
    # kernels each) queued behind the sleep block the host, which then
    # never gets ahead of the card
    iters = 10 if float(np.median(host_ms)) < 20.0 else 3
    timed_ms = cuda_ms(call, iters, queued=not host_bound)
    graph_ms = None if host_bound else timed_ms
    emit(phase="decode_graph", arch=cfg.name, family=cfg.family,
         layers=cfg.num_layers, params=cfg.param_count(), batch=B, prompt=S,
         first_position=first, cache_slots=slots,
         cache_shapes={key: [list(t.shape) for t in c[key]] for key in layout},
         steps=steps, calls=order, graphs=len(model._graphs),
         decode_attention_launches=launched,
         max_abs_err=dict(zip(names, errs)), graph_call_device_ms=graph_ms,
         graph_call_wall_ms=timed_ms if host_bound else None,
         graph_call_enqueue_ms=enqueue_ms, host_bound=host_bound,
         timed_calls=iters,
         graph_call_host_ms_median=float(np.median(host_ms)),
         graph_call_device_share=share(graph_ms, float(np.median(host_ms))),
         **({"sync_debug_error": synced} if sync_check else {}))
    if not all(e == 0.0 for e in errs):
        raise AssertionError(f"graph decode differs from eager: "
                             f"{dict(zip(names, errs))}")
    del model, caches, results, cs, c
    return graph_ms


def phase_families(dev) -> dict:
    """The hybrid, gemma3 local/global and MoE decoders at published
    width (random weights from seed 0), each in turn and freed before the
    next: (a) served through the launcher (``phase_serve`` at the serve
    cell, ``FAMILY_REQUESTS`` rounds; the slow-replica gate stays on
    qwen3-4b's ``serve``): ``flash_attention`` and ``decode_attention``
    once per attention layer per prefill and decode call, ``ssd`` once
    per layer per prefill for hymba; (b) the decode graph against eager
    past the window (``phase_decode_graph``); (c) for the MoE, a decode
    call under the sync debug mode's "error". Then qwen3-moe-235b-a22b,
    whose experts fit on no one card (94 x 128 x 3 x 4096 x 1536 bf16
    weights, ~454 GB), reduced, through the same decode-graph check.
    Returns each family's serve results."""
    import torch
    t0 = time.perf_counter()
    served = {}
    for arch, prompt, moe in (
            ("hymba-1.5b", 1100, False), ("gemma3-1b", 1000, False),
            ("qwen3-moe-30b-a3b", SERVE["prompt_len"], True)):
        served[arch] = phase_serve(dev, "families_serve", arch,
                                   requests=FAMILY_REQUESTS, slow_gate=False)
        gc.collect()
        torch.cuda.empty_cache()
        served[arch]["decode_graph_ms"] = phase_decode_graph(
            dev, arch, prompt=prompt, sync_check=moe)
        gc.collect()
        torch.cuda.empty_cache()
    phase_decode_graph(dev, "qwen3-moe-235b-a22b", reduced=True)
    emit(phase="families", seconds=time.perf_counter() - t0,
         requests=FAMILY_REQUESTS, archs=list(served))
    return served


def phase_audio_vlm(dev) -> dict:
    """Whisper-tiny and InternVL2-1B at published width (random weights
    from seed 0), each in turn and freed before the next: (a) served
    through the launcher (``phase_serve`` at the serve cell,
    ``FAMILY_REQUESTS`` rounds, the prompt of ``AUDIO_VLM``; no
    slow-replica gate), each kernel as often as ``path_launches`` says;
    (b) the decode graph against eager (``phase_decode_graph``) at each
    of ``AUDIO_VLM``'s graph prompts. Returns each model's serve results
    with its decode graphs' device ms by prompt."""
    import torch
    t0 = time.perf_counter()
    served = {}
    for arch, conf in AUDIO_VLM.items():
        served[arch] = phase_serve(dev, "audio_vlm_serve", arch,
                                   requests=FAMILY_REQUESTS, slow_gate=False,
                                   prompt_len=conf["prompt_len"])
        gc.collect()
        torch.cuda.empty_cache()
        served[arch]["decode_graph_ms"] = {
            prompt: phase_decode_graph(dev, arch, prompt=prompt)
            for prompt in conf["graph_prompts"]}
        gc.collect()
        torch.cuda.empty_cache()
    emit(phase="audio_vlm", seconds=time.perf_counter() - t0,
         requests=FAMILY_REQUESTS, **{
             arch: dict(prefill_ms=run["prefill_ms"],
                        decode_ms=run["decode_ms"],
                        decode_graph_ms=run["decode_graph_ms"],
                        decode_device_share=share(
                            run["decode_graph_ms"][AUDIO_VLM[arch][
                                "prompt_len"]], run["decode_ms"]))
             for arch, run in served.items()})
    return served


def train_run(dev, phase: str, cfg, argv: list, steps: int, want: dict,
              budget_s: float, last: int = 5) -> tuple:
    """``repro_torch.launch.train.main(argv)`` on the card (random
    weights from seed 0, the numpy-seeded LCG stream, remat), ``cfg``
    its model: every loss finite, the mean of the last ``last`` below the
    first, peak memory under the card's, each kernel launched as ``want``
    says (every other kernel not at all). Prints tokens/s, the median
    step, peak memory, each loss and the model FLOP/s (6 x parameters x
    tokens a step) as a share of the bf16 peak. Returns the launches of
    each kernel in the run and its seconds."""
    import torch
    from repro_torch.launch import train
    gc.collect()
    torch.cuda.empty_cache()
    base = memory_baseline(dev)
    for fn in all_kernels():
        fn.launches = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        losses = train.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    launches = {fn.__name__: fn.launches for fn in all_kernels()}
    *text, line = out.getvalue().strip().splitlines()
    print("\n".join(text), file=sys.stderr)
    rep = json.loads(line)
    step_s = rep["step_s"][1:]                 # the first step warms up
    median = float(np.median(step_s))
    tokens = rep["tokens_per_step"]
    model_flops = 6 * cfg.param_count() * tokens
    card_bytes = torch.cuda.get_device_properties(dev).total_memory
    emit(phase=phase, arch=cfg.name, layers=cfg.num_layers,
         d_model=cfg.d_model,
         heads=[cfg.num_heads, cfg.num_kv_heads, cfg.head_dim],
         ssm=[cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state],
         vocab=cfg.vocab_size, params=cfg.param_count(), argv=argv,
         steps=steps, tokens_per_step=tokens, losses=losses,
         step_s=rep["step_s"], first_step_s=rep["step_s"][0],
         step_ms_median=median * 1e3, tokens_per_s=tokens / median,
         model_flops_per_step=model_flops,
         model_flops_share_of_bf16_peak=model_flops / median
         / BF16_FLOP_PER_S,
         launches_per_step={k: n / steps for k, n in launches.items() if n},
         launches=launches, peak_mem_bytes=peak, card_mem_bytes=card_bytes,
         **base, seconds=secs, budget_s=budget_s, card=nvidia_smi())
    if not (len(losses) == steps and np.isfinite(losses).all()):
        raise AssertionError(f"{phase} {cfg.name}: losses {losses}")
    if not np.mean(losses[-last:]) < losses[0]:
        raise AssertionError(f"{phase} {cfg.name}: the last {last} losses "
                             f"average {np.mean(losses[-last:])}, not below "
                             f"the first {losses[0]}")
    if not peak < card_bytes:
        raise AssertionError(f"{phase} {cfg.name}: peak {peak} B of "
                             f"{card_bytes} B")
    need = {fn.__name__: 0 for fn in all_kernels()}
    need.update({k: n * steps for k, n in want.items()})
    if launches != need:
        raise AssertionError(f"{phase} {cfg.name}: launches {launches}, the "
                             f"path needs {need}")
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return launches, secs


def train_argv(arch: str, run: dict, *extra) -> list:
    return ["--arch", arch, "--device", "cuda", "--steps", str(run["steps"]),
            "--seq-len", str(run["seq_len"]), "--batch", str(run["batch"]),
            "--lr", str(run["lr"]), "--log-every", "1", *extra]


def phase_train(dev) -> dict:
    """``TRAIN``'s model at its published width (``train_run``): the flash
    kernel twice a layer a step (the step's forward and remat's
    recomputation) and its backward once, no other kernel. Returns the
    launches of each kernel in the run."""
    from repro_torch.configs import get_config
    cfg = get_config(TRAIN["arch"])
    n = cfg.num_layers
    launches, _ = train_run(
        dev, "train", cfg, train_argv(TRAIN["arch"], TRAIN), TRAIN["steps"],
        dict(flash_attention=2 * n, flash_attention_bwd=n),
        TRAIN["budget_s"])
    return launches


def phase_train_ssm(dev) -> dict:
    """``TRAIN_SSM``'s three runs through ``train_run``, one at a time: (a)
    mamba2-1.3b at its published width and depth: ``ssd`` twice a layer a
    step (forward and remat) and ``ssd_bwd`` once, no other kernel; (b)
    hymba-1.5b at its published width and depth: ``ssd`` and flash twice
    a layer a step, ``ssd_bwd`` and flash's backward once; (c)
    ``--train-100m`` (8 layers of 8/4 heads of 80) at its example's seq
    512 x batch 8: flash twice a layer a step and its backward once, at
    D 80. Returns the launches summed over the three runs; prints the
    phase's seconds beside its budget."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    t0 = time.perf_counter()
    total = {}
    runs = []
    for arch in ("mamba2-1.3b", "hymba-1.5b"):
        cfg = get_config(arch)
        n = cfg.num_layers
        want = dict(ssd=2 * n, ssd_bwd=n)
        if cfg.num_heads:
            want.update(flash_attention=2 * n, flash_attention_bwd=n)
        runs.append((cfg, train_argv(arch, TRAIN_SSM), TRAIN_SSM, want))
    cfg = train.train_100m_config()
    runs.append((cfg, train_argv("qwen3-4b", TRAIN_100M, "--train-100m"),
                 TRAIN_100M, dict(flash_attention=2 * cfg.num_layers,
                                  flash_attention_bwd=cfg.num_layers)))
    seconds = {}
    for cfg, argv, run, want in runs:
        launches, secs = train_run(dev, "train_ssm", cfg, argv, run["steps"],
                                   want, TRAIN_SSM["budget_s"], run["last"])
        seconds[cfg.name] = secs
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
    emit(phase="train_ssm", seconds=time.perf_counter() - t0,
         run_seconds=seconds, budget_s=TRAIN_SSM["budget_s"])
    return total


def leaf_gaps(got: dict, want: dict) -> dict:
    """Each kind of leaf (its name's last part): the worst gradient norm
    gap (relative to ``want``'s) and the worst cosine between the two,
    and the leaf where the cosine is worst."""
    kinds: dict = {}
    for name, g in got.items():
        g, w = g.double(), want[name].double()
        ng, nw = g.norm().item(), w.norm().item()
        gap = abs(ng - nw) / nw if nw else abs(ng - nw)
        cos = (g * w).sum().item() / (ng * nw) if ng * nw else float(ng == nw)
        k = kinds.setdefault(name.rsplit(".", 1)[-1], dict(
            leaves=0, worst_norm_gap=0.0, worst_cos=1.0, where=None))
        k["leaves"] += 1
        k["worst_norm_gap"] = max(k["worst_norm_gap"], gap)
        if cos < k["worst_cos"]:
            k["worst_cos"], k["where"] = cos, name
    return kinds


def rel_rms(a, b) -> float:
    """rms(a - b) / rms(b), in float64."""
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm()).item()


def phase_ssd_witness(dev) -> None:
    """``WITNESS`` (its comment says what it compares and gates): every
    reading is printed, then the gates that failed are raised together."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd as ssd_mod
    from repro_torch.models import build_model
    from repro_torch.training import synthetic_batch
    full = get_config(WITNESS["arch"])
    shape = ShapeConfig("witness", "train", TRAIN_SSM["seq_len"],
                        TRAIN_SSM["batch"])
    batch = synthetic_batch(full, shape, 0, dev)
    kernel_fwd, kernel_bwd = ops.ssd, ssd_mod.ssd_bwd
    failed = []

    def plain(x, dt, A, Bm, Cm, chunk):
        return ref.ssd(x, dt, A, Bm, Cm)

    def plain_bwd(*args):
        return ref.ssd_grads(*args)

    def first_perturbed(fn, rel: float, index: int = 0):
        """``fn`` with its first call's output ``index`` (a tensor, or one
        of a tuple) plus Gaussian noise of ``rel`` times its rms."""
        calls = []

        def call(*args, **kw):
            out = fn(*args, **kw)
            calls.append(None)
            if len(calls) > 1:
                return out
            outs = list(out) if isinstance(out, tuple) else [out]
            t = outs[index]
            gen = torch.Generator(device=dev).manual_seed(
                WITNESS["noise_seed"])
            noise = torch.randn(t.shape, generator=gen, device=dev)
            outs[index] = (t.float() + noise * rel * t.float().square()
                           .mean().sqrt()).to(t.dtype)
            return tuple(outs) if isinstance(out, tuple) else outs[0]
        return call

    @contextlib.contextmanager
    def scan(fwd, bwd=kernel_bwd):
        ops.ssd, ssd_mod.ssd_bwd = fwd, bwd
        try:
            yield
        finally:
            ops.ssd, ssd_mod.ssd_bwd = kernel_fwd, kernel_bwd

    def grads(model, fwd, bwd=kernel_bwd):
        params = dict(model.named_parameters())
        with scan(fwd, bwd):
            loss = model.loss(batch, remat=True)
            g = torch.autograd.grad(loss, list(params.values()))
        return float(loss.detach()), dict(zip(params, g))

    def outputs(model, fwd, keep_inputs=False):
        """y of every layer's scan, forward only (and the inputs of the
        first and last layer's)."""
        ys, inputs = [], []

        def rec(*args, chunk):
            y = fwd(*args, chunk=chunk)
            ys.append(y)
            if keep_inputs:
                inputs.append((args, chunk))
            return y
        with torch.no_grad(), scan(rec):
            model.loss(batch, remat=False)
        return ys, [inputs[0], inputs[-1]] if keep_inputs else None

    def compared(what, layers, got, want, gated) -> None:
        kinds = leaf_gaps(got[1], want[1])
        res = dict(what=what, layers=layers, loss=got[0], loss_plain=want[0],
                   loss_rel_gap=abs(got[0] - want[0]) / abs(want[0]),
                   worst_norm_gap=max(k["worst_norm_gap"]
                                      for k in kinds.values()),
                   worst_cos=min(k["worst_cos"] for k in kinds.values()),
                   kinds=kinds, gated=gated)
        emit(phase="ssd_witness", **res, bounds=WITNESS)
        if gated and not (res["loss_rel_gap"] <= WITNESS["loss_rtol"]
                          and res["worst_norm_gap"] <= WITNESS["norm_rtol"]
                          and res["worst_cos"] >= WITNESS["min_cos"]):
            failed.append(f"{what} at {layers} layers: loss gap "
                          f"{res['loss_rel_gap']}, norm gap "
                          f"{res['worst_norm_gap']}, cosine "
                          f"{res['worst_cos']}")

    # (1) the shallow model: little amplifies, so the two scans agree
    model = build_model(dataclasses.replace(
        full, num_layers=WITNESS["shallow"]), device=dev, seed=0).trainable()
    compared("kernels against the plain scan", WITNESS["shallow"],
             grads(model, kernel_fwd), grads(model, plain), True)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # (2) 48 layers: the kernels at the model's own inputs, the first and
    # the last layer's
    model = build_model(full, device=dev, seed=0).trainable()
    ys_k, edges = outputs(model, kernel_fwd, keep_inputs=True)
    dx_gap = 0.0
    for where, (args, chunk) in zip(("first", "last"), edges):
        out, want = ssd_mod.ssd(*args, chunk=chunk), ref.ssd(*args)
        tol = SSD_TOL["bfloat16"]
        used = ((out.float() - want.float()).abs()
                / (tol["atol"] + tol["rtol"] * want.float().abs())).max().item()
        gen = torch.Generator(device=dev).manual_seed(7)
        dy = torch.randn(args[0].shape, generator=gen, device=dev).to(
            args[0].dtype)
        got_g, want_g = ssd_mod.ssd_bwd(*args, dy), ref.ssd_grads(*args, dy)
        x, dt, A = args[:3]
        terms = ((dt.double() * want_g[1].double()
                  - (x.double() * want_g[0].double()).sum(-1))
                 / A.double()).abs().sum((0, 1))
        bwd = {name: ssd_bwd_used(g, w, SSD_BWD_TOL[str(g.dtype).split(".")[1]],
                                  SSD_BWD_TOL["terms"] * terms
                                  if name == "dA" else None)
               for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got_g,
                                     want_g)}
        dx_gap = rel_rms(got_g[0], want_g[0].to(got_g[0].dtype))
        emit(phase="ssd_witness", what="kernels at the model's inputs",
             layer=where, x_max_abs=x.float().abs().max().item(),
             dt_max=dt.max().item(), forward_allowance_used=used,
             forward_max_abs_err=(out.float() - want.float()).abs().max()
             .item(), y_rel_rms_gap=rel_rms(out, want), dx_rel_rms_gap=dx_gap,
             **bwd)
        if not (used <= 1.0 and all(r["allowance_used"] <= 1.0
                                    for r in bwd.values())):
            failed.append(f"the kernels at the {where} layer's inputs: "
                          f"forward {used}, {bwd}")
        del out, want, got_g, want_g, dy
    del edges

    # (3) how far each layer's y parts from the plain run's: the kernels
    # in every layer, and the plain scan with only the first layer's y
    # perturbed by as much as the kernel parts from it there
    ys_p, _ = outputs(model, plain)
    kernel_curve = [rel_rms(a, b) for a, b in zip(ys_k, ys_p)]
    del ys_k
    ys_n, _ = outputs(model, first_perturbed(plain, kernel_curve[0]))
    noise_curve = [rel_rms(a, b) for a, b in zip(ys_n, ys_p)]
    del ys_p, ys_n
    emit(phase="ssd_witness", what="each layer's y against the plain run's",
         layers=full.num_layers, kernels_every_layer=kernel_curve,
         plain_first_layer_perturbed=noise_curve)

    # (4) the gradients at 48 layers: the backward kernel against the plain
    # backward under the same forward (gated); the plain backward with only
    # the last layer's dx perturbed by as much as the kernel's dx parts from
    # it at that layer's inputs (the same growth, from one layer); the
    # kernels against the plain scan
    t = time.perf_counter()
    k = grads(model, kernel_fwd)
    kernel_s = time.perf_counter() - t
    f = grads(model, kernel_fwd, plain_bwd)
    compared("ssd_bwd against the plain backward, the same forward",
             full.num_layers, k, f, True)
    compared("the plain backward, the last layer's dx perturbed, against "
             "the plain backward", full.num_layers,
             grads(model, kernel_fwd, first_perturbed(plain_bwd, dx_gap)), f,
             False)
    del f
    t = time.perf_counter()
    p = grads(model, plain)
    plain_s = time.perf_counter() - t
    compared("kernels against the plain scan", full.num_layers, k, p, False)
    emit(phase="ssd_witness", kernel_s=kernel_s, plain_s=plain_s,
         card=nvidia_smi())
    del k, p, model
    gc.collect()
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"ssd_witness against {WITNESS}: "
                             + "; ".join(failed))


def save_rank(ckdir: str, runs: int) -> list:
    """One of ``--save-only``'s 4 ranks: mesh_train's model and fresh
    AdamW moments on the (2, 2) mesh, saved ``runs`` times (no step, no
    kernel); each save's seconds, each checkpoint removed after it."""
    import shutil
    import torch.distributed as dist
    from repro_torch.fault import build_mesh
    mesh = build_mesh(4, model_axis=MESH_TRAIN["mesh"][1])
    out = []
    for i in range(runs):
        path = os.path.join(ckdir, str(i))
        out.append(mesh_train_run(0, mesh, path)["save_s"])
        gc.collect()
        dist.barrier()
        if dist.get_rank() == 0:
            shutil.rmtree(path, ignore_errors=True)
    return out


def phase_save_only(runs: int) -> None:
    """mesh_train's checkpoint save alone (``save_rank`` on 4 ranks of the
    card): each rank's seconds of each save, rank 0's the writer's. Copied
    into the root of another tree, this script times that tree's
    ``Checkpointer``."""
    import shutil
    import tempfile
    from repro_torch.launch.mesh import spawn
    ckdir = tempfile.mkdtemp(prefix="save_only_")
    try:
        got = spawn(save_rank, 4, ckdir, runs, every_rank=True,
                    timeout=4 * MESH_TRAIN["budget_s"])
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    emit(phase="save_only", tree=str(ROOT), save_s_rank0=got[0],
         save_s=got, card=nvidia_smi())


def mesh_train_config():
    """``MESH_TRAIN``'s model: the published config, its depth cut,
    float32."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(MESH_TRAIN["arch"]),
                               num_layers=MESH_TRAIN["layers"],
                               dtype="float32")


@contextlib.contextmanager
def counted_collectives():
    """Count the calls of the three collectives the port makes and the
    host seconds inside them (the device synchronised first, so the
    time is the collective's and not the kernels' that made its input):
    yields ``{name: [calls, seconds]}``."""
    import torch
    import torch.distributed as dist
    from repro_torch.sharding.collectives import REDUCE_SCATTER
    names = ("all_reduce", "all_gather_into_tensor", REDUCE_SCATTER,
             "all_to_all_single")
    orig = {n: getattr(dist, n) for n in names}
    got = {n: [0, 0.0] for n in names}

    def wrap(name):
        def call(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = orig[name](*a, **k)
            got[name][0] += 1
            got[name][1] += time.perf_counter() - t
            return out
        return call

    for n in names:
        setattr(dist, n, wrap(n))
    try:
        yield got
    finally:
        for n in names:
            setattr(dist, n, orig[n])


def mesh_train_run(steps: int, mesh=None, ckdir: str | None = None,
                   resume: bool = False) -> dict:
    """One run of the mesh_train cell on this process's card: the model
    from seed 0, on ``mesh`` (this rank's blocks) or on one rank;
    ``resume`` restores ``ckdir``'s latest step first (with the mesh's
    shardings), else ``ckdir`` takes the state after the last step.
    Returns the losses, each step's seconds, the kernel launches and
    collectives of the steps alone, and the peak memory."""
    import torch
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import build_model
    from repro_torch.sharding import Sharding, tree_shardings
    from repro_torch.training import adamw, make_train_step, synthetic_batch
    from repro_torch.training.optimizer import AdamWState
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = mesh_train_config()
    shape = ShapeConfig("mesh_train", "train", MESH_TRAIN["seq_len"],
                        MESH_TRAIN["batch"])
    torch.cuda.reset_peak_memory_stats(dev)
    model = build_model(cfg, device=dev, seed=0).trainable()
    opt = adamw(MESH_TRAIN["lr"], clip_norm=MESH_TRAIN["clip_norm"])
    step_fn = make_train_step(model, opt)
    out = {}
    with mesh or contextlib.nullcontext():
        if mesh is not None:
            model.shard(mesh)
        params = dict(model.named_parameters())
        state = opt.init(params)
        first = 0
        if resume:
            sh = None
            if mesh is not None:
                ps = tree_shardings(model.param_axes(), mesh)
                sh = (ps, AdamWState(step=Sharding(mesh, ()), m=ps, v=ps))
            t = time.perf_counter()
            (saved, state), first = Checkpointer(ckdir).restore(
                (params, state), shardings=sh)
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(saved[k])
            del saved
            out["restore_s"] = time.perf_counter() - t
        for fn in all_kernels():
            fn.launches = 0
        losses, step_s = [], []
        with counted_collectives() as coll:
            for s in range(first, first + steps):
                t = time.perf_counter()
                batch = synthetic_batch(cfg, shape, s, dev, mesh=mesh)
                params, state, m = step_fn(params, state, batch)
                losses.append(float(m["loss"]))
                step_s.append(time.perf_counter() - t)
        out["launches"] = {fn.__name__: fn.launches for fn in all_kernels()}
        if ckdir is not None and not resume:
            t = time.perf_counter()
            Checkpointer(ckdir).save(first + steps, (params, state))
            out["save_s"] = time.perf_counter() - t
    out.update(losses=losses, step_s=step_s, first=first,
               collectives={n: dict(calls=c, seconds=sec)
                            for n, (c, sec) in coll.items()},
               peak_mem_bytes=torch.cuda.max_memory_allocated(dev))
    return out


def mesh_train_rank(ckdir: str, ports: tuple) -> dict:
    """One of the 4 ranks of mesh_train: (a) on the (2, 2) mesh, saved;
    (b) the last data row lost, the survivors in a group of their own
    (``ports[0]``) on the shrunk mesh, resumed. The lost pair forms a
    group on ``ports[1]``, and its first rank meanwhile resumes alone,
    on no mesh: the one-rank run (b) is held against. Then the 4 ranks
    join a new group (``ports[2]``) for mesh_serve. Returns ``{"a":
    run, "b": the survivor's run, "alone": the lost rank's, "serve":
    mesh_serve_rank's}`` (None where a rank has none)."""
    import torch
    import torch.distributed as dist
    from repro_torch.fault import build_mesh, shrink_mesh
    mesh = build_mesh(4, model_axis=MESH_TRAIN["mesh"][1])
    a = mesh_train_run(MESH_TRAIN["steps"], mesh, ckdir)
    gc.collect()
    torch.cuda.empty_cache()
    small = shrink_mesh(mesh, 1)
    rank = dist.get_rank()
    survivor = rank in small.ranks
    dist.barrier()
    dist.destroy_process_group()
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{ports[not survivor]}",
        world_size=2, rank=rank % 2)
    b = alone = None
    if survivor:
        b = mesh_train_run(MESH_TRAIN["resumed"], small, ckdir, resume=True)
    elif rank % 2 == 0:
        alone = mesh_train_run(MESH_TRAIN["resumed"], None, ckdir,
                               resume=True)
    gc.collect()
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{ports[2]}", world_size=4,
        rank=rank)
    return {"a": a, "b": b, "alone": alone, "serve": mesh_serve_rank()}


def card():
    """This process's card."""
    import torch
    return torch.device("cuda", torch.cuda.current_device())


def mesh_serve_inputs(cfg, dev, long: bool) -> tuple:
    """(batch, fed tokens (B, steps), first decode position) of run (a)
    or (b), drawn from numpy seeds: the same on every rank."""
    import torch
    B, P, T = ((1, MESH_SERVE["long_prompt"], MESH_SERVE["long_steps"])
               if long else (MESH_SERVE["batch"], MESH_SERVE["prompt_len"],
                             MESH_SERVE["steps"]))
    rng = np.random.default_rng(7 if long else 5)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, P)))
    fed = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T)))
    return {"tokens": prompt.to(dev)}, fed.to(dev), P


def mesh_serve_rules(cfg, mesh, long: bool) -> dict:
    """The reference dry run's decode rules for run (a) (``hybrid``) or
    (b) (the long-context rules, the caches' rows and KV heads whole so
    that the slots take every rank)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.sharding import rules_for
    _, fed, P = mesh_serve_inputs(cfg, "cpu", long)
    B, T = fed.shape
    over = rules_for(cfg, ShapeConfig("mesh_serve", "decode", P + T, B),
                      mesh, "hybrid")
    if long:
        over.update(kv_batch=(), kv_heads=())
    return over


def mesh_serve_run(long: bool, mesh=None) -> dict:
    """Run (a) or (b) of mesh_serve on this process's card, on ``mesh``
    (the rank's rows and blocks) or on one rank: the prefill, then one
    decode a fed token. Returns every call's logits (the rows whole, on
    the host in bf16), their greedy tokens, each call's seconds, the
    launches of the prefill and of the decode steps, the collectives of
    the decode steps and the peak memory."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.sharding import rule_overrides
    from repro_torch.sharding.collectives import batch_axes, relay
    dev = card()
    cfg = get_config(MESH_SERVE["arch"])
    batch, fed, start = mesh_serve_inputs(cfg, dev, long)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model = build_model(cfg, device=dev, seed=0)
    rules = mesh_serve_rules(cfg, mesh, long) if mesh is not None else {}
    logits_out, call_s = [], []
    with rule_overrides(**rules), mesh or contextlib.nullcontext():
        if mesh is not None:
            model.shard(mesh)
            gc.collect()
            torch.cuda.empty_cache()
        weights = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)       # the serving's peak

        def local(b: dict) -> dict:
            return b if mesh is None else model.shard_batch(b)

        def keep(lg) -> None:
            if mesh is not None:
                lg = relay(lg, (batch_axes(),), ((),))
            torch.cuda.synchronize()
            call_s.append(time.perf_counter() - t)
            logits_out.append(lg[:, -1].to(torch.bfloat16).cpu())

        for fn in all_kernels():
            fn.launches = 0
        t = time.perf_counter()
        lg, cache = model.prefill(local(batch), max_len=start + fed.shape[1])
        keep(lg)
        prefill_launches = {fn.__name__: fn.launches for fn in all_kernels()}
        for fn in all_kernels():
            fn.launches = 0
        with counted_collectives() as coll:
            for i in range(fed.shape[1]):
                t = time.perf_counter()
                lg, cache = model.decode(cache, local(
                    {"token": fed[:, i:i + 1].to(torch.int32),
                     "pos": start + i}))
                keep(lg)
        decode_launches = {fn.__name__: fn.launches for fn in all_kernels()}
    del model, cache
    logits = torch.stack(logits_out)                   # (calls, B, V)
    return dict(logits=logits, tokens=logits.float().argmax(-1),
                call_s=call_s, prefill_launches=prefill_launches,
                decode_launches=decode_launches,
                collectives={n: dict(calls=c, seconds=sec)
                             for n, (c, sec) in coll.items()},
                weights_bytes=weights,
                peak_mem_bytes=torch.cuda.max_memory_allocated(dev))


def mesh_serve_rank() -> dict:
    """mesh_serve's runs (a) and (b) on this rank of the (2, 2) mesh;
    the phase's seconds on this rank."""
    from repro_torch.launch.mesh import make_test_mesh
    t0 = time.perf_counter()
    mesh = make_test_mesh(*MESH_SERVE["mesh"])
    a = mesh_serve_run(False, mesh)
    b = mesh_serve_run(True, mesh)
    return {"a": a, "b": b, "seconds": time.perf_counter() - t0}


def planted(fault: tuple):
    """``models.attention.decode_attend`` with ``fault``'s line replaced,
    compiled in memory against the module's globals."""
    import inspect
    from repro_torch.models import attention
    name, old, new = fault
    src = inspect.getsource(attention.decode_attend)
    if src.count(old) != 1:
        raise AssertionError(f"--plant-faults {name}: the line {old!r} is "
                             f"not in decode_attend once")
    scope = dict(vars(attention))
    exec(compile(src.replace(old, new), attention.__file__, "exec"), scope)
    return scope["decode_attend"]


def planted_rank() -> dict:
    """mesh_serve's runs (a) and (b) on this rank of the (2, 2) mesh,
    sound and with each of ``MERGE_FAULTS`` planted: ``{(fault or
    "sound", run): logits and tokens}``."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import attention
    mesh = make_test_mesh(*MESH_SERVE["mesh"])
    sound = attention.decode_attend
    out = {}
    for key, long in (("a", False), ("b", True)):
        for fault in (None, *MERGE_FAULTS):
            attention.decode_attend = sound if fault is None else \
                planted(fault)
            try:
                run = mesh_serve_run(long, mesh)
            finally:
                attention.decode_attend = sound
            out[(fault[0] if fault else "sound", key)] = {
                k: run[k] for k in ("logits", "tokens")}
    return out


def phase_planted_faults() -> None:
    """``--plant-faults``: each of mesh_serve's runs (a) and (b) on the 4
    ranks, sound and with each of ``MERGE_FAULTS``, against one rank:
    the gaps and token agreement that ``MESH_SERVE``'s bound has to tell
    apart, beside it."""
    import torch
    from repro_torch.launch.mesh import spawn
    got = spawn(planted_rank, 4, timeout=1200.0)
    one = {"a": mesh_serve_run(False), "b": mesh_serve_run(True)}
    torch.cuda.empty_cache()
    for (fault, key), run in got.items():
        res = mesh_serve_gaps(f"({key}) {fault}", run, one[key])
        emit(phase="planted_faults", run=key, fault=fault,
             largest_gap=max(res["max_abs_over_scale"]),
             **res, caught=max(res["max_abs_over_scale"])
             > MESH_SERVE["max_abs_over_scale"]
             or res["token_agreement"] < MESH_SERVE["token_agree"],
             tolerance={k: MESH_SERVE[k] for k in ("max_abs_over_scale",
                                                   "token_agree")},
             card=nvidia_smi())


def mesh_serve_launches(layers: int, steps: int) -> tuple:
    """(prefill, decode steps) launches of a mesh_serve run on any rank:
    flash once a layer, decode once a layer a step, nothing else."""
    pre = {fn.__name__: 0 for fn in all_kernels()}
    dec = dict(pre)
    pre["flash_attention"] = layers
    dec["decode_attention"] = layers * steps
    return pre, dec


def mesh_serve_gaps(what: str, got: dict, want: dict) -> dict:
    """``got``'s logits against one rank's ``want``: each call's largest
    |gap| over one rank's largest |logit|, and the share of greedy tokens
    that agree."""
    g, w = got["logits"].float(), want["logits"].float()
    if g.shape != w.shape or not bool(g.isfinite().all()):
        raise AssertionError(f"mesh_serve {what}: logits {tuple(g.shape)} "
                             f"against {tuple(w.shape)}, or not finite")
    gap = ((g - w).abs().amax(dim=(1, 2))
           / w.abs().amax(dim=(1, 2))).tolist()   # a call's largest gap
    agree = float((got["tokens"] == want["tokens"]).float().mean())
    return dict(max_abs_over_scale=gap, token_agreement=agree)


def check_mesh_serve(what: str, got: dict, want: dict) -> dict:
    """``mesh_serve_gaps`` within ``MESH_SERVE``'s bound and token
    agreement; returns them."""
    res = mesh_serve_gaps(what, got, want)
    gap, agree = res["max_abs_over_scale"], res["token_agreement"]
    if max(gap) > MESH_SERVE["max_abs_over_scale"] or \
            agree < MESH_SERVE["token_agree"]:
        raise AssertionError(f"mesh_serve {what}: gaps {gap} (bound "
                             f"{MESH_SERVE['max_abs_over_scale']}), tokens "
                             f"agree {agree}")
    return res


def mesh_serve_fields(run: dict) -> dict:
    """A run's report: prefill and decode seconds, collectives a decode
    step and their share of the steps, peak memory."""
    steps = len(run["call_s"]) - 1
    dec_s = sum(run["call_s"][1:])
    coll_s = sum(v["seconds"] for v in run["collectives"].values())
    return dict(prefill_s=run["call_s"][0], decode_step_s=run["call_s"][1:],
                collectives_per_step={k: v["calls"] / steps for k, v in
                                      run["collectives"].items()},
                collective_share_of_steps=coll_s / dec_s,
                weights_bytes=run["weights_bytes"],
                peak_mem_bytes=run["peak_mem_bytes"],
                prefill_launches=run["prefill_launches"],
                decode_launches=run["decode_launches"])


def phase_mesh_serve(ranks: list, one: dict, dry: dict) -> None:
    """mesh_serve's checks and report (the module docstring): the ranks'
    runs against one rank's ``one`` (``{"a", "b"}``) and the dry-run
    cell ``dry``."""
    from repro_torch.configs import get_config
    cfg = get_config(MESH_SERVE["arch"])
    errs = {}
    for key, steps in (("a", MESH_SERVE["steps"]),
                       ("b", MESH_SERVE["long_steps"])):
        want_pre, want_dec = mesh_serve_launches(cfg.num_layers, steps)
        for r, rk in enumerate(ranks):
            run = rk["serve"][key]
            if (run["prefill_launches"] != want_pre
                    or run["decode_launches"] != want_dec):
                raise AssertionError(
                    f"mesh_serve ({key}) rank {r}: launches "
                    f"{run['prefill_launches']} and "
                    f"{run['decode_launches']}")
            if not torch_equal(run["tokens"], ranks[0]["serve"][key]["tokens"]):
                raise AssertionError(f"mesh_serve ({key}): rank {r} picks "
                                     f"other tokens than rank 0")
        errs[key] = check_mesh_serve(key, ranks[0]["serve"][key], one[key])
    if dry.get("status") != "ok":
        raise AssertionError(f"mesh_serve (c): dry-run cell {dry}")
    seconds = max(rk["serve"]["seconds"] for rk in ranks) + dry["wall_s"]
    emit(phase="mesh_serve", arch=cfg.name, layers=cfg.num_layers,
         dtype=cfg.dtype, mesh=dict(zip(("data", "model"),
                                        MESH_SERVE["mesh"])),
         a=dict(batch=MESH_SERVE["batch"], prompt_len=MESH_SERVE["prompt_len"],
                steps=MESH_SERVE["steps"], layout="hybrid",
                ranks=[mesh_serve_fields(rk["serve"]["a"]) for rk in ranks],
                one_rank=mesh_serve_fields(one["a"]) | {"collectives_per_step":
                                                       None}, **errs["a"]),
         b=dict(batch=1, prompt_len=MESH_SERVE["long_prompt"],
                steps=MESH_SERVE["long_steps"],
                layout="long-context, the slots over (data, model)",
                ranks=[mesh_serve_fields(rk["serve"]["b"]) for rk in ranks],
                one_rank=mesh_serve_fields(one["b"]) | {"collectives_per_step":
                                                       None}, **errs["b"]),
         c={k: dry[k] for k in ("arch", "shape", "mesh", "status", "memory",
                                "cost", "collectives", "roofline", "rules",
                                "timing", "wall_s")},
         tolerance={k: MESH_SERVE[k] for k in ("max_abs_over_scale",
                                               "token_agree")},
         rank_seconds=[rk["serve"]["seconds"] for rk in ranks],
         seconds=seconds, budget_s=MESH_SERVE["budget_s"],
         within_budget=seconds <= MESH_SERVE["budget_s"], card=nvidia_smi())


def torch_equal(a, b) -> bool:
    import torch
    return bool(torch.equal(a, b))


def mesh_serve_dry() -> dict:
    """mesh_serve (c): the dry-run cell, traced on the host."""
    from repro_torch.launch import dryrun
    t = time.perf_counter()
    try:
        out = dryrun.run_cell(*MESH_SERVE["dry"], False)
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
    out["wall_s"] = time.perf_counter() - t
    return out


def want_launches(steps: int) -> dict:
    """The kernel launches of ``steps`` mesh_train steps on any rank:
    flash twice a layer a step (the forward and remat's recomputation),
    its backward once, no other kernel."""
    want = {fn.__name__: 0 for fn in all_kernels()}
    want.update(flash_attention=2 * MESH_TRAIN["layers"] * steps,
                flash_attention_bwd=MESH_TRAIN["layers"] * steps)
    return want


def check_mesh_losses(what: str, got: list, want: list) -> float:
    """``got`` within ``MESH_TRAIN``'s tolerance of ``want``; returns the
    largest relative gap."""
    got, want = np.asarray(got), np.asarray(want)
    if not (np.isfinite(got).all() and got.shape == want.shape):
        raise AssertionError(f"mesh_train {what}: losses {got.tolist()}")
    if not np.allclose(got, want, rtol=MESH_TRAIN["rtol"],
                       atol=MESH_TRAIN["atol"]):
        raise AssertionError(f"mesh_train {what}: {got.tolist()} against "
                             f"one rank's {want.tolist()}")
    return float(np.max(np.abs(got - want) / np.abs(want)))


def phase_mesh_train(dev) -> None:
    """Sharded training and the elastic restart on gloo ranks of the one
    card, each against one rank on the card (the module docstring)."""
    import shutil
    import tempfile
    import threading
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import _free_port, spawn
    from repro_torch.serving.router import QEdgeRouter
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = mesh_train_config()
    layers, steps, resumed = cfg.num_layers, MESH_TRAIN["steps"], \
        MESH_TRAIN["resumed"]
    ckdir = tempfile.mkdtemp(prefix="mesh_train_")
    got: dict = {}

    def ranks_run():
        try:
            got["ranks"] = spawn(mesh_train_rank, 4, ckdir,
                                 (_free_port(), _free_port(), _free_port()),
                                 every_rank=True,
                                 timeout=4 * MESH_TRAIN["budget_s"])
        except BaseException as e:              # raised below, here
            got["error"] = e

    # the one-rank run (a) on the card while the ranks start
    try:
        t1 = time.perf_counter()
        ranks_thread = threading.Thread(target=ranks_run)
        ranks_thread.start()
        one = mesh_train_run(steps + resumed)
        gc.collect()
        torch.cuda.empty_cache()
        # mesh_serve's one-rank runs and its dry-run cell meanwhile
        one_serve = {"a": mesh_serve_run(False), "b": mesh_serve_run(True)}
        gc.collect()
        torch.cuda.empty_cache()
        dry = mesh_serve_dry()
        ranks_thread.join()
        spawn_s = time.perf_counter() - t1
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    if "error" in got:
        raise got["error"]
    ranks = got["ranks"]
    one_resumed = next(rk["alone"] for rk in ranks if rk["alone"])
    gc.collect()
    torch.cuda.empty_cache()
    err_a = check_mesh_losses("(a) 4 ranks", ranks[0]["a"]["losses"],
                              one["losses"][:steps])
    err_b = check_mesh_losses("(b) resumed on 2 ranks",
                              ranks[0]["b"]["losses"],
                              one_resumed["losses"])
    err_resumed = check_mesh_losses("(b) resumed against uninterrupted",
                                    one_resumed["losses"],
                                    one["losses"][steps:])
    if any(rk[p]["launches"] != want_launches(n) for rk in ranks
           for p, n in (("a", steps), ("b", resumed), ("alone", resumed))
           if rk[p] is not None) or one["launches"] != want_launches(
               steps + resumed):
        raise AssertionError(
            "mesh_train: launches " + json.dumps(
                [{p: rk[p] and rk[p]["launches"] for p in ("a", "b", "alone")}
                 for rk in ranks] + [one["launches"]]))
    if ranks[0]["b"]["first"] != steps:
        raise AssertionError(f"mesh_train (b): resumed at step "
                             f"{ranks[0]['b']['first']}, not {steps}")
    router = QEdgeRouter(2, 2, device=dev)
    router.mesh_resized(1)
    if router.state.active.tolist() != [True, False] or \
            float(router.state.weights[:, 1].abs().max()) != 0.0:
        raise AssertionError(f"mesh_train: mesh_resized(1) left "
                             f"{router.state.active.tolist()}")

    def run_fields(run: dict, n: int) -> dict:
        secs = sum(run["step_s"])
        calls = {k: v["calls"] / n for k, v in run["collectives"].items()}
        coll_s = sum(v["seconds"] for v in run["collectives"].values())
        return dict(losses=run["losses"], step_s=run["step_s"],
                    steps_per_s=n / secs, collectives_per_step=calls,
                    collective_share_of_steps=coll_s / secs,
                    peak_mem_bytes=run["peak_mem_bytes"],
                    launches=run["launches"],
                    **{k: run[k] for k in ("save_s", "restore_s") if k in run})

    # the phase's seconds without mesh_serve's, which ran in its ranks after
    secs = time.perf_counter() - t0 - max(rk["serve"]["seconds"]
                                          for rk in ranks)
    emit(phase="mesh_train", arch=cfg.name, layers=layers,
         d_model=cfg.d_model, heads=[cfg.num_heads, cfg.num_kv_heads,
                                     cfg.head_dim],
         d_ff=cfg.d_ff, vocab=cfg.vocab_size, dtype=cfg.dtype, tf32=False,
         params=cfg.param_count(),
         reduced=dict(num_layers=[get_config(MESH_TRAIN["arch"]).num_layers,
                                 layers]),
         seq_len=MESH_TRAIN["seq_len"], batch=MESH_TRAIN["batch"],
         route="explicit collectives (gloo all-reduce, all-gather and "
               "reduce-scatter)",
         mesh=dict(data=MESH_TRAIN["mesh"][0], model=MESH_TRAIN["mesh"][1]),
         shrunk_mesh=dict(data=1, model=MESH_TRAIN["mesh"][1]),
         one_rank=run_fields(one, steps + resumed),
         ranks=[run_fields(rk["a"], steps) for rk in ranks],
         one_rank_resumed=run_fields(one_resumed, resumed),
         survivors=[run_fields(rk["b"], resumed) for rk in ranks
                    if rk["b"] is not None],
         concurrent="the one-rank run (a) ran while the ranks started; "
                    "the one-rank resume ran on a lost rank beside the "
                    "survivors",
         max_rel_err_a=err_a, max_rel_err_b=err_b,
         max_rel_err_resumed_vs_uninterrupted=err_resumed,
         rtol=MESH_TRAIN["rtol"], atol=MESH_TRAIN["atol"],
         router_after_mesh_resized=router.state.active.tolist(),
         spawn_seconds=spawn_s, seconds=secs,
         budget_s=MESH_TRAIN["budget_s"],
         within_budget=secs <= MESH_TRAIN["budget_s"], card=nvidia_smi())
    phase_mesh_serve(ranks, one_serve, dry)


def all_kernels() -> tuple:
    """Every kernel wrapper of the port (each carries ``launches``)."""
    from repro_torch.kernels import ops
    return ops.WRAPPERS


def time_row(kernel, plain, library, work: tuple, iters: int) -> dict:
    """``kernel``'s, its plain version's (unqueued, a tenth as many calls)
    and the library call's times by ``cuda_ms``, and the bound: the
    larger of ``work``'s bytes over the memory rate and its operations
    over the bf16 tensor-core rate (``roofline.analysis.kernel_bound_s``,
    the dry run's)."""
    bound_s, bound_by = kernel_bound_s(work)
    return dict(ms=cuda_ms(kernel, iters),
                plain_ms=cuda_ms(plain, max(iters // 10, 3), queued=False),
                bound_ms=bound_s * 1e3, bound_by=bound_by,
                library_ms=None if library is None else cuda_ms(library,
                                                                iters))


def phase_times(dev, launches: dict, errs: dict) -> list:
    """Kernel, plain version, library call and bound (``time_row``) at
    the main paths' shapes; then the round kernel with a lane axis.
    Returns the kernels line's rows."""
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
    Sc = DECODE_CASES[0][3]                              # last decode step
    dq, dk, dv, dlen = decode_inputs(B, Hq, Hkv, Sc, D, dtype, [Sc] * B, 31,
                                     dev)
    live = (torch.arange(Sc, device=dev)[None, :] < dlen[:, None])
    d_mask = live[:, None, None, :]

    B, S, H, P, N, chunk, dtype, model = SSD_CASES[0]
    s_args = ssd_inputs(B, S, H, P, N, dtype, model, 32, dev)
    bq, bk, bv = attention_inputs(*BWD_CASES[0][:6], 34, dev)
    bdo = torch.randn(bq.shape, generator=torch.Generator(device=dev)
                      .manual_seed(35), device=dev).to(bq.dtype)
    lq, lk, lv = (t.detach().requires_grad_() for t in (bq, bk, bv))
    l_out = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True,
                                           enable_gqa=True)
    # five products against the forward's two: 2.5 x its operations; q, k,
    # v and dO read once, dq, dk, dv written once
    b_work = (nbytes(bq, bk, bv, bdo) + nbytes(bq, bk, bv),
              int(2.5 * attention_work(bq, bk, bv)[1]))
    sb = SSD_BWD_CASES[0]
    sb_args = (*ssd_inputs(*sb[:5], sb[6], True, 37, dev),)
    sb_args += (torch.randn(sb_args[0].shape, generator=torch.Generator(
        device=dev).manual_seed(38), device=dev).to(sb_args[0].dtype),)
    k_rows, k_R = KDE_SIZES[0]
    k_lat, k_mask, k_bw = kde_inputs(k_rows, k_R, 33, dev)
    k_args = (k_lat, k_mask, 0.08, k_bw)
    k_bytes = nbytes(k_lat, k_mask, k_bw) + k_rows * 4
    rows_out = []
    for (name, src, replaces, kern, plain, library, args, kwargs, work,
         iters) in (
            ("round_step_swrr", "src/repro_torch/kernels/csrc/round_fused.cu",
             "src/repro/kernels/round_fused.py:183",
             round_fused.round_step_swrr, ref.round_step_swrr, None, r_args,
             kw, (r_bytes, 0), 20),
            ("fused_maintenance", "src/repro_torch/kernels/csrc/maintenance.cu",
             "src/repro/kernels/kde.py:127", kde.fused_maintenance,
             ref.bandit_maintenance_stats, None, m_args, {}, (m_bytes, 0),
             200),
            ("flash_attention",
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:97",
             flash_attention.flash_attention, ref.attention,
             lambda: F.scaled_dot_product_attention(
                 fq, fk, fv, is_causal=True, enable_gqa=True),
             (fq, fk, fv), {}, attention_work(fq, fk, fv), 20),
            ("flash_attention_bwd",
             "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
             "none (port-only backward of "
             "src/repro/kernels/flash_attention.py:97)",
             flash_attention.flash_attention_bwd, ref.attention_grads,
             lambda: torch.autograd.grad(l_out, (lq, lk, lv), bdo,
                                         retain_graph=True),
             (bq, bk, bv, bdo), {}, b_work, 10),
            ("decode_attention",
             "src/repro_torch/kernels/csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention.py:64",
             decode_attention.decode_attention, ref.decode_attention,
             lambda: F.scaled_dot_product_attention(
                 dq[:, :, None], dk, dv, attn_mask=d_mask, enable_gqa=True),
             (dq, dk, dv, dlen), {}, decode_work(dq, dk, dv, dlen), 200),
            ("ssd", "src/repro_torch/kernels/csrc/ssd.cu",
             "src/repro/kernels/ssd.py:66",
             functools.partial(ssd.ssd, chunk=chunk), ref.ssd, None, s_args,
             {}, ssd_work(*s_args), 20),
            ("ssd_bwd", "src/repro_torch/kernels/csrc/ssd_bwd.cu",
             "none (port-only backward of src/repro/kernels/ssd.py:66)",
             ssd.ssd_bwd, ref.ssd_grads, None, sb_args, {},
             ssd_bwd_work(*sb_args[:5]), 10),
            ("kde_success_prob", "src/repro_torch/kernels/csrc/maintenance.cu",
             "src/repro/kernels/kde.py:50", kde.kde_success_prob,
             ref.kde_success_prob, None, k_args, {}, (k_bytes, 0), 200)):
        rows_out.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name], max_abs_err=errs[name],
            **time_row(lambda: kern(*args, **kwargs),
                       lambda: plain(*args, **kwargs), library, work, iters)))
        if name in ("fused_maintenance", "kde_success_prob"):
            # one row: the launch and one row's chain
            one = [a[:1] if isinstance(a, torch.Tensor) else a for a in args]
            extra = dict(ms_1row=cuda_ms(lambda: kern(*one), iters))
        else:
            extra = ({"flops_chunk256": ssd_work(*s_args, tile=chunk)[1],
                      "flops_tensor_core_passes": ssd._mma_flops(B, S, H, N,
                                                                 P),
                      "cuda_launches_per_call": ssd.LAUNCHES_PER_CALL[
                          s_args[0].dtype]} if name == "ssd" else
                     round_launch_fields(K, M, C, dev)
                     if name == "round_step_swrr" else
                     {"cuda_launches_per_call": ssd.BWD_LAUNCHES_PER_CALL,
                      "workspace_bytes": 4 * ssd._bwd_workspace_floats(
                          *sb[:3], sb[4], sb[3]),
                      "shape": dict(zip("BSHPN", sb[:5]))}
                     if name == "ssd_bwd" else {})
        if name == "decode_attention":       # the log-sum-exp beside it
            extra = dict(ms_with_lse=cuda_ms(lambda: kern(
                *args, with_lse=True), iters), lse_bytes=dq.shape[0]
                * dq.shape[1] * 4)
        emit(phase="times", bytes=work[0], flops=work[1], **extra,
             **rows_out[-1])
    # the round kernel with a lane axis: the lanes phase's shape and the
    # fleet's, four lanes in one launch
    for S, Kl, Ml in ROUND_LANE_CASES[1:]:
        l_args = lane_round_inputs(S, Kl, Ml, C, R, Rq, 70 + Kl, dev)
        l_bytes = (nbytes(*l_args[:18])
                   + nbytes(*(x for i, x in enumerate(l_args[:12]) if i != 5))
                   + 2 * S * Ml * 4 + 3 * S * Kl * C * 4)
        row = time_row(lambda: round_fused.round_step_swrr(*l_args, **kw),
                       lambda: ref.round_step_swrr(*l_args, **kw), None,
                       (l_bytes, 0), 20)
        del row["library_ms"]
        emit(phase="times_lanes", name="round_step_swrr", lanes=S, K=Kl,
             M=Ml, **row, bytes=l_bytes,
             **round_launch_fields(S * Kl, Ml, C, dev, S))
    phase_train_times(dev)
    return rows_out


def phase_train_times(dev) -> None:
    """The training kernels at train_ssm's other shapes (``time_row``):
    ``ssd_bwd`` at hymba-1.5b's heads (``SSD_BWD_CASES[1]``, no library
    call: no PyTorch call computes the SSD backward), and flash at D 80
    (``TRAIN_100M_FLASH[0]``), forward beside SDPA and backward beside
    SDPA's backward through ``torch.autograd.grad``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention, ref, ssd
    B, S, H, P, N, chunk, dtype, _ = SSD_BWD_CASES[1]
    args = ssd_inputs(B, S, H, P, N, dtype, True, 39, dev)
    dy = torch.randn(args[0].shape, generator=torch.Generator(device=dev)
                     .manual_seed(40), device=dev).to(args[0].dtype)
    work = ssd_bwd_work(*args)
    emit(phase="times_train", name="ssd_bwd",
         shape=dict(B=B, S=S, H=H, P=P, N=N),
         **time_row(functools.partial(ssd.ssd_bwd, *args, dy),
                    functools.partial(ref.ssd_grads, *args, dy), None, work,
                    20), bytes=work[0], flops=work[1])
    del args, dy
    B, Hq, Hkv, S, D, dtype, causal, window = TRAIN_100M_FLASH[0]
    q, k, v = attention_inputs(B, Hq, Hkv, S, D, dtype, 41, dev)
    do = torch.randn(q.shape, generator=torch.Generator(device=dev)
                     .manual_seed(42), device=dev).to(q.dtype)
    work = attention_work(q, k, v)
    shape = dict(B=B, Hq=Hq, Hkv=Hkv, S=S, D=D, causal=causal)
    emit(phase="times_train", name="flash_attention", shape=shape,
         **time_row(functools.partial(flash_attention.flash_attention, q, k,
                                      v),
                    functools.partial(ref.attention, q, k, v),
                    functools.partial(F.scaled_dot_product_attention, q, k,
                                      v, is_causal=True, enable_gqa=True),
                    work, 20), bytes=work[0], flops=work[1])
    lq, lk, lv = (t.detach().requires_grad_() for t in (q, k, v))
    l_out = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True,
                                           enable_gqa=True)
    b_work = (nbytes(q, k, v, do) + nbytes(q, k, v), int(2.5 * work[1]))
    emit(phase="times_train", name="flash_attention_bwd", shape=shape,
         tensor_cores=flash_attention.bwd_tensor_cores(q.dtype, D),
         **time_row(functools.partial(flash_attention.flash_attention_bwd, q,
                                      k, v, do),
                    functools.partial(ref.attention_grads, q, k, v, do),
                    lambda: torch.autograd.grad(l_out, (lq, lk, lv), do,
                                                retain_graph=True),
                    b_work, 10), bytes=b_work[0], flops=b_work[1])


def phase_family_times(dev) -> None:
    """The serving kernels at the decoder families', Whisper's and
    InternVL2's shapes (``time_row``): flash at ``FAMILY_FLASH`` and
    ``AV_FLASH`` (its library call SDPA, causal or not, with the window
    as a boolean mask where there is one; the bound counts the pairs the
    mask keeps), decode attention on ``FAMILY_DECODE``'s and
    ``AV_DECODE``'s caches at their whole length, ``ssd`` at hymba's
    heads."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention, flash_attention, ref, ssd
    B = SERVE["batch"]
    for (Hq, Hkv), S, D, window, causal in (
            *((*c, True) for c in FAMILY_FLASH),
            *((heads, S, D, None, causal)
              for heads, S, D, causal in AV_FLASH)):
        q, k, v = attention_inputs(B, Hq, Hkv, S, D, "bfloat16", 34, dev)
        t = torch.arange(S, device=dev)
        mask = (t[:, None] >= t[None, :]) & (t[:, None] - t[None, :]
                                             < (window or S))
        library = functools.partial(
            F.scaled_dot_product_attention, q, k, v, enable_gqa=True,
            **(dict(is_causal=causal) if window is None else
               dict(attn_mask=mask)))
        work = attention_work(q, k, v, window, causal)
        emit(phase="times_families", name="flash_attention",
             shape=dict(B=B, Hq=Hq, Hkv=Hkv, S=S, D=D, window=window,
                        causal=causal),
             **time_row(functools.partial(flash_attention.flash_attention, q,
                                          k, v, causal=causal, window=window),
                        functools.partial(ref.attention, q, k, v,
                                          causal=causal, window=window),
                        library, work, 20),
             bytes=work[0], flops=work[1])
    for (Hq, Hkv), S, D, _ in (*FAMILY_DECODE, *AV_DECODE):
        q, k, v, length = decode_inputs(B, Hq, Hkv, S, D, "bfloat16",
                                        [S] * B, 35, dev)
        work = decode_work(q, k, v, length)
        emit(phase="times_families", name="decode_attention",
             shape=dict(B=B, Hq=Hq, Hkv=Hkv, S=S, D=D, length=S),
             **time_row(functools.partial(decode_attention.decode_attention,
                                          q, k, v, length),
                        functools.partial(ref.decode_attention, q, k, v,
                                          length),
                        functools.partial(F.scaled_dot_product_attention,
                                          q[:, :, None], k, v,
                                          enable_gqa=True), work, 200),
             bytes=work[0], flops=work[1])
    Bs, S, H, P, N, chunk, dtype, model = SSD_CASES[-1]
    args = ssd_inputs(Bs, S, H, P, N, dtype, model, 36, dev)
    work = ssd_work(*args)
    emit(phase="times_families", name="ssd",
         shape=dict(B=Bs, S=S, H=H, P=P, N=N, chunk=chunk),
         **time_row(functools.partial(ssd.ssd, *args, chunk=chunk),
                    functools.partial(ref.ssd, *args), None, work, 20),
         bytes=work[0], flops=work[1])


def profiled(fn, name: str, trace_dir: Path, sums: dict | None = None,
             **fields) -> None:
    """Run ``fn`` once under torch.profiler and emit the device time by
    kernel name and the busy share of the wall time. The busy time sums
    the device-side events only (an op's device time repeats its
    kernels'). ``sums`` names fields of device ms, each the kernels whose
    names hold one of its strings."""
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
    for field, keys in (sums or {}).items():
        fields[field] = sum(e.self_device_time_total for e in kernels
                            if any(k in e.key for k in keys)) / 1e3
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


def profile_fleet(dev, trace_dir: Path) -> None:
    """The profiler breakdown of 20 fleet steps, after 20 unprofiled."""
    from repro_torch.continuum import run_sim_stream
    cfg, rtt = fleet_inputs(dev, 2.0)
    run_sim_stream("qedgeproxy", rtt, cfg, 7, device=dev)      # warm
    profiled(lambda: run_sim_stream("qedgeproxy", rtt, cfg, 7, device=dev),
             "fleet", trace_dir, steps=cfg.num_steps)


def profile_train(dev, trace_dir: Path) -> None:
    """The profiler breakdown of one ``TRAIN`` step after two unprofiled:
    the loss and its gradients (the forward, remat's recomputation, the
    backward; with the flash backward's device ms), then the AdamW
    update, each alone."""
    import torch
    from repro_torch import training
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import build_model
    cfg = get_config(TRAIN["arch"])
    model = build_model(cfg, device=dev).trainable()
    params = dict(model.named_parameters())
    opt = training.adamw(training.cosine_schedule(TRAIN["lr"], 20,
                                                  TRAIN["steps"]))
    state = opt.init(params)
    shape = ShapeConfig("cli", "train", TRAIN["seq_len"], TRAIN["batch"])
    batch = training.synthetic_batch(cfg, shape, 0, dev)
    step = training.make_train_step(model, opt)
    for _ in range(2):                                           # warm
        params, state, _ = step(params, state, batch)
    found = {}

    def grads():
        loss = model.loss(batch, remat=True)
        found["grads"] = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))

    fields = dict(arch=cfg.name, batch=TRAIN["batch"],
                  seq_len=TRAIN["seq_len"])
    profiled(grads, "train_grads", trace_dir,
             sums=dict(flash_bwd_device_ms=("flash_bwd_",)), **fields)
    profiled(lambda: opt.update(found["grads"], state, params),
             "train_update", trace_dir, **fields)
    del model, params, state, found
    gc.collect()
    torch.cuda.empty_cache()


def phase_fleet_only(dev, repeats: int, trace_dir: Path | None) -> None:
    """The fleet phase alone, ``repeats`` times after a 20-step warm-up,
    then (``trace_dir``) its profile: the harness that compares two
    trees' step on one card (run it from each tree's root)."""
    from repro_torch.continuum import run_sim_stream
    cfg, rtt = fleet_inputs(dev, 2.0)
    run_sim_stream("qedgeproxy", rtt, cfg, 7, device=dev)      # warm
    for _ in range(repeats):
        phase_fleet(dev)
    if trace_dir is not None:
        profile_fleet(dev, trace_dir)


def phase_profile(dev, trace_dir: Path) -> None:
    """Profiler breakdowns: 20 fleet steps; 20 steps of each suite
    strategy on the 30x10 testbed (seed 1); one prefill and one decode
    call of each served model (qwen3-4b, mamba2-1.3b, then the families'
    hymba-1.5b, gemma3-1b and qwen3-moe-30b-a3b, batch 4, prompt 1000;
    whisper-tiny at its prompt of 4 beside 1,500 frames and internvl2-1b
    at 256 patches and 1,000 tokens); one training step's gradients and
    update (``profile_train``)."""
    import torch
    from repro_torch.bench import figures as bf
    from repro_torch.configs import get_config
    from repro_torch.continuum import make_topology, run_sim_stream
    from repro_torch.launch.serve import decode_start, request_batch
    from repro_torch.models import build_model
    profile_fleet(dev, trace_dir)
    cfg, rtt = fleet_inputs(dev, 2.0)
    # the fleet under the control plane (a), then also the lifecycle (b)
    import dataclasses
    from repro_torch.bench.scenarios import CONTROL_RES
    from repro_torch.continuum import ControlConfig
    ctl_cfg = dataclasses.replace(cfg, control=ControlConfig(
        **LIFECYCLE_CONTROL))
    for name, c in (("fleet_control", ctl_cfg),
                    ("fleet_lifecycle", dataclasses.replace(ctl_cfg,
                                                            **CONTROL_RES))):
        def run(c=c):
            run_sim_stream("qedgeproxy", rtt, c, 7, device=dev)
        run()                                                    # warm
        profiled(run, name, trace_dir, steps=c.num_steps)
    rtt = make_topology(1, bf.N_LBS, bf.N_INSTANCES, device=dev).lb_instance_rtt()
    for label, kw in bf.STRATEGIES:
        def lane():
            run_sim_stream(bf.strategy_name(label), rtt, cfg, 101, device=dev,
                           **kw)
        lane()                                                   # warm
        profiled(lane, f"suite_{label}", trace_dir, steps=cfg.num_steps)
    from repro_torch.continuum import run_sim_grid, slice_drivers, stack_drivers
    lcfg, rtts, keys, drivers = lanes_inputs(dev)
    lcfg = type(lcfg)(horizon=cfg.horizon)
    batch = stack_drivers([slice_drivers(d, 0, lcfg.num_steps)
                           for d in drivers])

    def lanes():
        run_sim_grid("qedgeproxy", rtts, lcfg, keys, drivers=batch,
                     device=dev)
    lanes()                                                      # warm
    profiled(lanes, "lanes", trace_dir, steps=lcfg.num_steps,
             lanes=len(drivers))
    # the multi-tenant lane: its four tenant scenarios as lanes, each
    # policy, 20 steps
    from repro_torch.bench import scenarios as bs
    conf, mcfg, names, rtts, keys, drivers = bs.mt_inputs(dev, horizon=2.0)
    batch = stack_drivers(drivers)
    for label, kw in bs.MT_POLICIES:
        def tenants(label=label, kw=kw):
            run_sim_grid(bf.strategy_name(label), rtts, mcfg, keys,
                         drivers=batch, warmup_steps=conf.warm, device=dev,
                         **kw)
        tenants()                                                # warm
        profiled(tenants, f"multi_tenant_{label}", trace_dir,
                 steps=mcfg.num_steps, lanes=len(names),
                 tenants=bs.MT_TENANTS)

    B, steps = SERVE["batch"], SERVE["decode_steps"]
    for arch, tag in (("qwen3-4b", ""), ("mamba2-1.3b", "ssm_"),
                      ("hymba-1.5b", "hymba_"), ("gemma3-1b", "gemma3_"),
                      ("qwen3-moe-30b-a3b", "moe_"),
                      ("whisper-tiny", "whisper_"),
                      ("internvl2-1b", "internvl2_")):
        mcfg = get_config(arch)
        S = AUDIO_VLM.get(arch, SERVE)["prompt_len"]
        model = build_model(mcfg, device=dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        tokens = torch.randint(0, mcfg.vocab_size, (B, S), generator=gen,
                               device=dev)
        batch, first = request_batch(mcfg, tokens, gen), decode_start(mcfg, S)
        token = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        _, cache = model.prefill(batch, max_len=first + steps)      # warm
        model.decode(cache, {"token": token, "pos": first})
        profiled(lambda: model.prefill(batch, max_len=first + steps),
                 f"{tag}prefill", trace_dir, arch=arch, batch=B, prompt=S)
        profiled(lambda: model.decode(cache, {"token": token,
                                              "pos": first + 1}),
                 f"{tag}decode", trace_dir, arch=arch, batch=B,
                 cache_slots=first + steps)
        del model, cache
        gc.collect()
        torch.cuda.empty_cache()
    profile_train(dev, trace_dir)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR", type=Path,
                    help="add torch.profiler breakdowns of fleet steps, suite "
                         "steps and a prefill and decode call of each served "
                         "model, and write their Chrome traces to "
                         "DIR/{fleet,fleet_control,fleet_lifecycle,"
                         "suite_<strategy>,lanes,multi_tenant_<policy>,"
                         "prefill,decode,ssm_prefill,ssm_decode,"
                         "<model>_prefill,<model>_decode,train_grads,"
                         "train_update}_trace.json")
    ap.add_argument("--profile-only", action="store_true",
                    help="with --profile: build the kernels and run only the "
                         "profiler breakdowns, no checks")
    ap.add_argument("--fleet-only", type=int, default=0, metavar="N",
                    help="build the kernels if missing or stale and time only "
                         "the fleet phase, N times after a warm-up (with "
                         "--profile DIR, also its profile): to compare two "
                         "trees on one card")
    ap.add_argument("--plant-faults", action="store_true",
                    help="build the kernels, run the kernels phase, then "
                         "mesh_serve's runs (a) and (b) on 4 ranks sound and "
                         "with each of MERGE_FAULTS planted in a copy of "
                         "decode_attend made in memory, each against one "
                         "rank: what MESH_SERVE's bound tells apart")
    ap.add_argument("--ssd-witness", action="store_true",
                    help="build the kernels, then mamba2-1.3b's loss, "
                         "gradients and layer outputs through the SSD "
                         "kernels against the plain scan's (WITNESS)")
    ap.add_argument("--save-only", type=int, default=0, metavar="N",
                    help="time only mesh_train's checkpoint save, N times "
                         "on 4 ranks (no kernel built): to compare two "
                         "trees' Checkpointer on one card")
    args = ap.parse_args()
    t_start = time.perf_counter()
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
    if args.fleet_only:
        _build.load()
        phase_fleet_only(dev, args.fleet_only, args.profile)
        return 0
    if args.save_only:
        phase_save_only(args.save_only)
        return 0
    build_s = _build.build()
    ptxas = ptxas_report((_build.BUILD_DIR / "build.log").read_text())
    emit(phase="build", seconds=build_s,
         sources=[str(s.relative_to(ROOT)) for s in _build.sources()],
         ptxas=ptxas)
    if args.profile_only and args.profile is not None:
        phase_profile(dev, args.profile)
        return 0
    if args.ssd_witness:
        phase_ssd_witness(dev)
        return 0
    spilled = [k for k in ptxas if k["spill_stores"]
               and k["kernel"].startswith(NO_SPILL)]
    if spilled:
        raise AssertionError(f"kernels that spill registers: {spilled}")
    errs = phase_kernels(dev)
    if args.plant_faults:
        phase_planted_faults()
        return 0
    phase_testbed(dev)
    launches, fleet_steps_per_s = phase_fleet(dev)
    phase_lifecycle_fleet(dev, fleet_steps_per_s)
    phase_recorder(dev, fleet_steps_per_s)
    phase_baselines(dev)
    phase_suite(dev)
    phase_lanes(dev)
    phase_scenarios(dev)
    phase_events(dev)
    phase_degradation(dev)
    phase_closed_loop(dev)
    phase_multi_tenant(dev)
    phase_players(dev)
    dense_graph_ms = phase_decode_graph(dev, "qwen3-4b")
    served = phase_serve(dev, "serve", "qwen3-4b")
    phase_decode_graph(dev, "mamba2-1.3b")
    served_ssm = phase_serve(dev, "serve_ssm", "mamba2-1.3b")
    families = phase_families(dev)
    phase_audio_vlm(dev)
    trained = phase_train(dev)
    trained_ssm = phase_train_ssm(dev)
    phase_mesh_train(dev)
    # each kernel's launches on its main path: the simulator kernels in the
    # fleet run, the serving kernels in their serve runs, the flash backward
    # in the train run; the KDE kernel, which no path calls, summed over the
    # fleet and serve runs
    for run in (served, served_ssm):
        launches.update({k: n for k, n in run["launches"].items()
                         if k not in launches})
        launches["kde_success_prob"] += run["launches"]["kde_success_prob"]
    launches["flash_attention_bwd"] = trained["flash_attention_bwd"]
    launches["ssd_bwd"] = trained_ssm["ssd_bwd"]
    kernels = phase_times(dev, launches, errs)
    phase_family_times(dev)
    times = {row["name"]: row["ms"] for row in kernels}
    # kernel time x launches per call over the serve run's median call
    emit(phase="serve_shares",
         flash_share_of_prefill=served["layers"] * times["flash_attention"]
         / served["prefill_ms"],
         decode_share_of_decode=served["layers"] * times["decode_attention"]
         / served["decode_ms"],
         decode_device_share=share(dense_graph_ms, served["decode_ms"]),
         ssd_share_of_prefill=served_ssm["layers"] * times["ssd"]
         / served_ssm["prefill_ms"],
         maintenance_launches_in_serve=served["launches"]["fused_maintenance"],
         maintenance_launches_in_serve_ssm=served_ssm["launches"][
             "fused_maintenance"])
    # a replayed decode call's device time over the served median call
    emit(phase="families_shares", **{
        arch: dict(prefill_ms=run["prefill_ms"], decode_ms=run["decode_ms"],
                   decode_device_share=share(run["decode_graph_ms"],
                                             run["decode_ms"]))
        for arch, run in families.items()})
    if args.profile is not None:
        phase_profile(dev, args.profile)
    emit(phase="total", seconds=time.perf_counter() - t_start)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
