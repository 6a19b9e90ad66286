"""One simulator step's C SWRR rounds as a CUDA kernel for Hopper.

Port of the TPU kernel ``repro/kernels/round_fused.py::round_step_swrr``:
SWRR selection, the shared-queue recursion, feedback control (error
counters, cooldown trips, pool and weight renormalisation) and the ring
writes for all C rounds of one step, in one launch. The TPU kernel
keeps cross-player queue coupling exact by relying on in-order grid
steps and persistent output blocks; Hopper blocks have neither, so
``csrc/round_fused.cu`` runs the whole step in one CTA (one thread per
player, the queue in shared memory, block barriers between rounds). Its
header says what bounds it; ``ref.round_step_swrr`` is the plain
PyTorch version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import RoundStepOut

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.cache
def _launcher():
    return _build.function("round_step_launch",
                           [_P] * 23 + [_I] * 5 + [_F, _F, _I, _F, _P])


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
    tau: float, err_thresh: int, cooldown: float,
) -> RoundStepOut:
    """CUDA round kernel; same contract as ``ref.round_step_swrr``.

    The inputs are left untouched: the state is copied into the outputs
    and the kernel updates the copies in place. ``t`` is the step time
    as a host number (a float32 value), so the launch needs no host
    sync. Every output is bit-exact against the plain version.
    """
    launch = _launcher()
    K, M, R = lat_buf.shape
    C = z.shape[0]
    Rq = r_buf.shape[1]
    dev = weights.device
    if dev.type != "cuda":
        raise ValueError(f"round_step_swrr: tensors must be on CUDA, not {dev}")
    f32, i32, b = torch.float32, torch.int32, torch.bool
    for x, name, dtype, shape in (
            (weights, "weights", f32, (K, M)), (cw, "cw", f32, (K, M)),
            (err, "err", i32, (K, M)), (cooldown_until, "cooldown_until",
                                        f32, (K, M)),
            (in_pool, "in_pool", b, (K, M)), (active, "active", b, (M,)),
            (lat_buf, "lat_buf", f32, (K, M, R)),
            (ts_buf, "ts_buf", f32, (K, M, R)), (ptr, "ptr", i32, (K, M)),
            (r_buf, "r_buf", f32, (K, Rq)), (rts_buf, "rts_buf", f32, (K, Rq)),
            (rptr, "rptr", i32, (K,)), (q, "q", f32, (M,)),
            (nc, "nc", i32, (K,)), (z, "z", f32, (C, K)),
            (rtt_t, "rtt_t", f32, (K, M)), (s_m, "s_m", f32, (M,)),
            (served_per_round, "served_per_round", f32, (M,))):
        _check(x, name, dtype, shape, dev)
    if isinstance(t, torch.Tensor):
        if t.is_cuda:
            raise ValueError("round_step_swrr: pass t as a host number")
        t = t.item()
    state = [x.clone() for x in (weights, cw, err, cooldown_until, in_pool,
                                 lat_buf, ts_buf, ptr, r_buf, rts_buf, rptr)]
    q_out = torch.empty(M, dtype=f32, device=dev)
    arrivals = torch.empty(M, dtype=f32, device=dev)
    choices = torch.empty(K, C, dtype=i32, device=dev)
    lats = torch.empty(K, C, dtype=f32, device=dev)
    procs = torch.empty(K, C, dtype=f32, device=dev)
    ptrs = [x.data_ptr() for x in state[:5]] + [active.data_ptr()] \
        + [x.data_ptr() for x in state[5:]] \
        + [x.data_ptr() for x in (q, q_out, arrivals, nc, z, rtt_t, s_m,
                                  served_per_round, choices, lats, procs)]
    err_code = launch(*ptrs, K, M, R, Rq, C, float(t), float(tau),
                      int(err_thresh), float(cooldown),
                      torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err_code, "round_step_launch")
    round_step_swrr.launches += 1
    (w_o, cw_o, err_o, cd_o, pool_o, lat_o, ts_o, ptr_o, rb_o, rts_o,
     rp_o) = state
    return RoundStepOut(w_o, cw_o, err_o, cd_o, pool_o, lat_o, ts_o, ptr_o,
                        rb_o, rts_o, rp_o, q_out, arrivals, choices, lats,
                        procs)


round_step_swrr.launches = 0
