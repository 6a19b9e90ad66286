"""One simulator step's C SWRR rounds as a CUDA kernel for Hopper.

Port of the TPU kernel ``repro/kernels/round_fused.py::round_step_swrr``:
SWRR selection, the shared-queue recursion, feedback control (error
counters, cooldown trips, pool and weight renormalisation) and the ring
writes for all C rounds of one step, in one cooperative launch over
every SM. The TPU kernel keeps the cross-player queue coupling exact by
relying on in-order grid steps and persistent output blocks; Hopper
blocks have neither, so ``csrc/round_fused.cu`` gives each player a warp
(its rows in shared memory for all C rounds), sums each round's
arrivals in a per-call workspace and crosses one grid barrier per
round, after which every CTA recomputes the queue itself; copy warps
stream the rings to the outputs meanwhile. Its header says what bounds
it; ``ref.round_step_swrr`` is the plain PyTorch version.

Lanes: one call may carry S independent simulations, the players of
all of them as rows (lane s owns rows [s·K, (s+1)·K)) and the queue,
liveness, service and drain rows as (S, M) (``ref.py`` says more). It
is still one cooperative launch: every CTA holds all S lanes' rows in
shared memory, which bounds S·M.

The launch geometry is computed here, in Python (``_smem_bytes``,
``_warps``, ``_grid``, ``_players``, ``_workspace_words``), so the CPU
tests can check it; ``geometry`` adds the card's occupancy.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.ref import RoundStepOut

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

WARPS = 8                # player warps a CTA, at most (kPlayerWarps)
COPY_WARPS = 4           # warps a CTA that copy the rings (kCopyWarps)
SMEM_LIMIT = 232_448     # dynamic shared memory a CTA may use on the H100
WORKSPACE_HEAD = 32      # words before the arrivals: the barrier counter's line
# CUDA launches a call: the workspace's zero fill and the round kernel
LAUNCHES_PER_CALL = 2


def _smem_bytes(M: int, C: int, warps: int, S: int = 1) -> int:
    """Dynamic shared memory of a CTA (``round_kernel``'s layout): for
    each of the S lanes the queue, the CTA's round arrivals, s_m and
    served (float rows of M rounded up to 4 words) and active (M bytes
    rounded up to 16), then per player warp its player's weights,
    credits, cooldowns, latencies, error counters and ring pointers,
    its C noise draws (rounded up to 4 words), its request count (a
    16-byte slot) and its pool bits."""
    m4, c4, mb = (M + 3) & ~3, (C + 3) & ~3, (M + 15) & ~15
    return S * (16 * m4 + mb) + warps * (24 * m4 + 4 * c4 + 16 + mb)


def _warps(M: int, C: int, S: int = 1) -> int:
    """Player warps a CTA: ``WARPS``, fewer when their rows do not fit."""
    for warps in range(WARPS, 0, -1):
        if _smem_bytes(M, C, warps, S) <= SMEM_LIMIT:
            return warps
    raise ValueError(f"round_step_swrr: S={S} lanes of M={M} arms and C={C} "
                     f"rounds do not fit one warp's rows in {SMEM_LIMIT} "
                     f"bytes of shared memory (S*M must stay below about "
                     f"{SMEM_LIMIT // 17})")


def _grid(K: int, warps: int, ctas_per_sm: int, sms: int) -> tuple[int, int]:
    """(CTAs, players per warp) for ``warps`` player warps a CTA: a warp
    for each player where the resident CTAs allow it, else every
    resident CTA with each warp looping over players."""
    if ctas_per_sm < 1:
        raise ValueError("round_step_swrr: the kernel fits no CTA on an SM")
    grid = min(-(-K // warps), ctas_per_sm * sms)
    return grid, -(-K // (grid * warps))


def _players(warp: int, K: int, warps_in_grid: int) -> range:
    """The players a warp owns (``round_kernel``'s loop)."""
    return range(warp, K, warps_in_grid)


def _workspace_words(C: int, M: int, S: int = 1) -> int:
    """float32 words of the per-call workspace: the barrier counter on
    its own 128-byte line, then each round's (S, M) arrivals."""
    return WORKSPACE_HEAD + C * S * M


@functools.cache
def _launcher():
    return _build.function("round_step_launch",
                           [_P] * 35 + [_I] * 11 + [_F, _F, _I, _F, _P])


@functools.cache
def _occupancy(index: int, threads: int, smem: int) -> tuple[int, int]:
    """(CTAs resident per SM, SMs) of card ``index``."""
    fn = _build.function("round_step_occupancy",
                         [_I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)])
    ctas, sms = _I(0), _I(0)
    with torch.cuda.device(index):
        _build.check(fn(threads, smem, ctypes.byref(ctas), ctypes.byref(sms)),
                     "round_step_occupancy")
    return ctas.value, sms.value


def geometry(K: int, M: int, C: int, device, S: int = 1) -> dict:
    """The launch on ``device`` for K players (of all S lanes), M arms
    and C rounds."""
    warps = _warps(M, C, S)
    smem = _smem_bytes(M, C, warps, S)
    threads = 32 * (warps + COPY_WARPS)
    index = torch.device(device).index or 0
    ctas_per_sm, sms = _occupancy(index, threads, smem)
    grid, ppw = _grid(K, warps, ctas_per_sm, sms)
    return dict(grid=grid, threads=threads, player_warps_per_cta=warps,
                copy_warps_per_cta=COPY_WARPS, smem_bytes=smem,
                resident_ctas_per_sm=ctas_per_sm, sms=sms,
                players_per_warp=ppw)


def _check(x: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if x.dtype != dtype or tuple(x.shape) != shape or x.device != device \
            or not x.is_contiguous():
        raise ValueError(
            f"round_step_swrr: {name} must be a contiguous {dtype} {shape} "
            f"tensor on {device}; got {x.dtype} {tuple(x.shape)} on "
            f"{x.device}")


def round_step_swrr(
    weights, cw, err, cooldown_until, in_pool, active,
    lat_buf, ts_buf, ptr, r_buf, rts_buf, rptr,
    q, nc, z, rtt_t, s_m, served_per_round, t,
    tau: float, err_thresh: int, cooldown: float, cooldown_at=None,
) -> RoundStepOut:
    """CUDA round kernel; same contract as ``ref.round_step_swrr``.

    The inputs are left untouched: the kernel reads each once and writes
    every output, which the wrapper allocates empty. ``t`` is the step
    time as a host number (a float32 value), so the launch needs no host
    sync. Every output is bit-exact against the plain version. With
    (S, M) per-instance rows it runs S lanes in the one launch. It has no
    backward: a float input that requires grad under grad mode raises.
    """
    launch = _launcher()
    _build.refuse_grad("round_step_swrr", weights, cw, cooldown_until,
                       lat_buf, ts_buf, r_buf, rts_buf, q, z, rtt_t, s_m,
                       served_per_round)
    K, M, R = lat_buf.shape
    C = z.shape[0]
    Rq = r_buf.shape[1]
    dev = weights.device
    if dev.type != "cuda":
        raise ValueError(f"round_step_swrr: tensors must be on CUDA, not {dev}")
    S = q.shape[0] if q.dim() == 2 else 1
    if min(K, M, R, Rq, C, S) < 1 or K % S:
        raise ValueError(f"round_step_swrr: shape K={K}, M={M}, R={R}, "
                         f"Rq={Rq}, C={C}, S={S} (K a multiple of S)")
    lane = tuple(q.shape)
    f32, i32, b = torch.float32, torch.int32, torch.bool
    ins = (weights, cw, err, cooldown_until, in_pool, active, lat_buf, ts_buf,
           ptr, r_buf, rts_buf, rptr, q, nc, z, rtt_t, s_m, served_per_round)
    for x, name, dtype, shape in zip(ins, (
            "weights", "cw", "err", "cooldown_until", "in_pool", "active",
            "lat_buf", "ts_buf", "ptr", "r_buf", "rts_buf", "rptr", "q", "nc",
            "z", "rtt_t", "s_m", "served_per_round"), (
            f32, f32, i32, f32, b, b, f32, f32, i32, f32, f32, i32, f32, i32,
            f32, f32, f32, f32), (
            (K, M), (K, M), (K, M), (K, M), (K, M), lane, (K, M, R),
            (K, M, R), (K, M), (K, Rq), (K, Rq), (K,), lane, (K,), (C, K),
            (K, M), lane, lane)):
        _check(x, name, dtype, shape, dev)
    if isinstance(t, torch.Tensor):
        if t.is_cuda:
            raise ValueError("round_step_swrr: pass t as a host number")
        t = t.item()
    t_cd = ref.cooldown_deadline(t, cooldown, cooldown_at)
    geo = geometry(K, M, C, dev, S)
    state = [torch.empty_like(x) for x in (weights, cw, err, cooldown_until,
                                           in_pool, lat_buf, ts_buf, ptr,
                                           r_buf, rts_buf, rptr)]
    q_out = torch.empty(lane, dtype=f32, device=dev)
    arrivals = torch.empty(lane, dtype=f32, device=dev)
    choices = torch.empty(K, C, dtype=i32, device=dev)
    lats = torch.empty(K, C, dtype=f32, device=dev)
    procs = torch.empty(K, C, dtype=f32, device=dev)
    workspace = torch.zeros(_workspace_words(C, M, S), dtype=f32, device=dev)
    outs = (*state, q_out, arrivals, choices, lats, procs, workspace)
    err_code = launch(*(x.data_ptr() for x in ins + outs), K, M, R, Rq, C,
                      S, K // S,
                      geo["grid"], geo["player_warps_per_cta"],
                      geo["smem_bytes"],
                      geo["players_per_warp"], float(t), float(tau),
                      int(err_thresh), t_cd,
                      torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err_code, "round_step_launch")
    round_step_swrr.launches += 1
    return RoundStepOut(*state, q_out, arrivals, choices, lats, procs)


round_step_swrr.launches = 0
