"""Causal GQA prefill attention as CUDA kernels for Hopper.

Port of the TPU kernel ``repro/kernels/flash_attention.py::
flash_attention``: query head h attends over kv head ``h // (Hq /
Hkv)`` with a causal mask, an optional sliding window and an online
softmax over kv tiles, in float32 inside. The kernels are in
``csrc/flash_attention.cu``, chosen by dtype alone: bfloat16 runs on the
tensor cores (one CTA per (batch row, head, 128-row q block), K and V
tiles loaded by TMA into a 2-stage ring by a producer warp, both
products as ``wgmma``), float32 on the CUDA cores (exact to float32
rounding). The work is bound by operations, ~400 FLOP a byte at the
serving shape; the header says how each design meets that.
``ref.attention`` is their plain PyTorch version.

``flash_attention_bwd`` is the backward, a kernel the TPU package does
not have (its training differentiates the plain attention): two CUDA
kernels in ``csrc/flash_attention_bwd.cu`` that recompute the
probabilities from q and k, deterministic (no atomics). The route goes
by dtype and head dim (``bwd_tensor_cores``): bfloat16 at D 64 and 128
on the tensor cores (``wgmma`` on TMA-loaded tiles, P and dS in two
bfloat16 terms), float32 and bfloat16 at D 16, 32 and 256 on the CUDA
cores in float32. ``ref.attention_grads`` is its plain version;
``ops.attention`` pairs the two kernels in an autograd Function.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)
# head dims whose bfloat16 backward runs on the tensor cores; D 256 would
# hold 256 float32 accumulators a thread in the dK/dV kernel
BWD_TC_HEAD_DIMS = (64, 128)


def _smem_bytes(D: int) -> int:
    """The bfloat16 kernel's shared memory (``tc::Cfg<D>::kSmem``): 1024
    bytes of alignment slack, the q block (128 rows, 64 at D = 256), two
    stages of a 64-row K and V tile, five mbarriers."""
    rows = 64 if D == 256 else 128
    return 1024 + rows * D * 2 + 4 * 64 * D * 2 + 64


def _bwd_smem_bytes(D: int) -> int:
    """The larger of the tensor-core backward's two kernels' shared
    memory (``tc::Cfg<D>::kDqSmem``, ``kKvSmem``): 1024 bytes of
    alignment slack; the dQ kernel's 128-row q and dO blocks and two
    stages of a 64-row K and V tile; the dK/dV kernel's 64-row K and V
    and two stages of a 64-row q and dO tile and their 64 lse and delta
    floats; five mbarriers each."""
    tile = 64 * D * 2
    return max(1024 + 2 * 128 * D * 2 + 4 * tile + 64,
               1024 + 6 * tile + 2 * 2 * 64 * 4 + 64)


def bwd_tensor_cores(dtype: torch.dtype, D: int) -> bool:
    """Whether ``flash_attention_bwd`` takes the tensor-core kernels for
    this dtype and head dim (else the CUDA-core ones)."""
    return dtype == torch.bfloat16 and D in BWD_TC_HEAD_DIMS


def _lse_rows(S: int) -> int:
    """Rows of the backward's lse and delta scratch a head: S rounded up
    to the 64-row tile, so the dK/dV kernel copies whole tiles."""
    return -(-S // 64) * 64


@functools.cache
def _launcher():
    return _build.function("flash_attention_launch", [
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _I, _P])


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(f"flash_attention: {what}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """Attention over the full sequence, as ``ref.attention``.

    ``q`` (B, Hq, S, D), ``k`` and ``v`` (B, Hkv, S, D), one dtype
    (float32 or bfloat16), contiguous on one CUDA device, Hq a multiple
    of Hkv, D in ``HEAD_DIMS``; ``window`` None or >= 1. Returns (B, Hq,
    S, D) in q's dtype. float32: within float32 rounding of the plain
    version (sums in another order, CUDA's expf). bfloat16: the logits
    are scaled after the product and the probabilities enter the second
    as two bfloat16 terms, so each output is within 2e-3 plus two
    bfloat16 steps of its own magnitude. Launches on the current stream
    and counts one launch a call.
    """
    launch = _launcher()
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    _require(q.is_cuda and k.device == q.device and v.device == q.device,
             "tensors must share a CUDA device")
    _require(q.dtype in DTYPES and k.dtype == q.dtype and v.dtype == q.dtype,
             "q, k, v must all be float32 or all bfloat16")
    _require(k.shape == (B, Hkv, S, D) and v.shape == k.shape
             and Hkv > 0 and Hq % Hkv == 0, "shapes")
    _require(D in HEAD_DIMS, f"head_dim {D} not in {HEAD_DIMS}")
    _require(window is None or window >= 1, f"window {window} < 1")
    _require(all(t.is_contiguous() and t.data_ptr() % 16 == 0
                 for t in (q, k, v)), "tensors must be contiguous")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    scale = scale if scale is not None else D ** -0.5
    err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 DTYPES[q.dtype], B, Hq, Hkv, S, D, scale, int(causal),
                 window or 0,
                 torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_launch")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


@functools.cache
def _bwd_launcher():
    return _build.function("flash_attention_bwd_launch", [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
        ctypes.c_float, _I, _I, _P])


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dout: torch.Tensor, causal: bool = True,
                        window: int | None = None,
                        scale: float | None = None):
    """The gradients ``(dq, dk, dv)`` of ``flash_attention(q, k, v,
    causal, window, scale)`` against the output gradient ``dout``, as
    ``ref.attention_grads``.

    ``q`` and ``dout`` (B, Hq, S, D), ``k`` and ``v`` (B, Hkv, S, D), the
    rules of ``flash_attention`` (``dout`` may be strided: it is made
    contiguous). Returns the three gradients in q's dtype, float32
    inside. Where ``bwd_tensor_cores`` (bfloat16 at D 64 and 128) the
    products are ``wgmma`` with P and dS entering as two bfloat16 terms
    each and ex2.approx exponentials: each gradient is within 1e-3 + 2**-7
    of its own magnitude of the plain version's, most of it the final
    rounding to bfloat16. Else the CUDA-core kernels: float32 sums in
    another order than the plain version's (CUDA's expf), bfloat16
    inputs widened exactly and each gradient rounded once at the end.
    dk and dv of kv head j sum over the Hq / Hkv query heads of its
    group. Two kernels on the current stream, no atomics (two calls give
    the same bits); allocates float32 log-sum-exp and delta rows (B, Hq,
    ``_lse_rows(S)``). Counts one launch a call. A training step with
    remat runs the forward twice a layer (the step's forward and the
    checkpoint's recomputation) and this once.
    """
    launch = _bwd_launcher()
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    dout = dout.contiguous()
    _require(q.is_cuda and all(t.device == q.device for t in (k, v, dout)),
             "tensors must share a CUDA device")
    _require(q.dtype in DTYPES and all(t.dtype == q.dtype
                                       for t in (k, v, dout)),
             "q, k, v, dout must all be float32 or all bfloat16")
    _require(k.shape == (B, Hkv, S, D) and v.shape == k.shape
             and dout.shape == q.shape and Hkv > 0 and Hq % Hkv == 0,
             "shapes")
    _require(D in HEAD_DIMS, f"head_dim {D} not in {HEAD_DIMS}")
    _require(window is None or window >= 1, f"window {window} < 1")
    _require(all(t.is_contiguous() and t.data_ptr() % 16 == 0
                 for t in (q, k, v, dout)), "tensors must be contiguous")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk, dv
    lse, delta = (torch.empty((B, Hq, _lse_rows(S)), dtype=torch.float32,
                              device=q.device) for _ in range(2))
    scale = scale if scale is not None else D ** -0.5
    err = launch(*(t.data_ptr() for t in (q, k, v, dout, dq, dk, dv, lse,
                                          delta)),
                 DTYPES[q.dtype], int(bwd_tensor_cores(q.dtype, D)), B, Hq,
                 Hkv, S, D, scale, int(causal),
                 window or 0,
                 torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_bwd_launch")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
