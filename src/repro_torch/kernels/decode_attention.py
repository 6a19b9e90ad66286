"""GQA decode attention as a split-KV CUDA kernel for Hopper.

Port of the TPU kernel ``repro/kernels/decode_attention.py::
decode_attention``: one query token per head against a KV cache, the G
query heads of a kv group served together, each batch row masked to
its first ``length[b]`` slots, softmax in float32. The work is bound by
bytes (the cache is read once), so ``csrc/decode_attention.cu`` spreads
each (batch row, kv head) over ``ceil(S / CHUNK)`` CTAs that write
partial (max, normaliser, output) to a float32 workspace, and a second
kernel combines them; its header says more. The combine kernel also
writes each row's log-sum-exp where it is asked for (``with_lse``): a
rank that holds a slice of the cache's slots attends over it, and the
ranks merge their outputs by it (``models/attention.py``).
``ref.decode_attention`` is its plain PyTorch version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPES

_P = ctypes.c_void_p
_I = ctypes.c_int
_SMEM_LIMIT = 232_448          # bytes of shared memory a block may opt into
CHUNK = 64                     # cache slots per split
# head dims the decode kernel takes (the card has checked these; flash also
# takes 80, which no served model uses)
HEAD_DIMS = (16, 32, 64, 128, 256)


@functools.cache
def _launcher():
    return _build.function("decode_attention_launch", [
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float,
        _P])


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(f"decode_attention: {what}")


def _smem_bytes(G: int, D: int, itemsize: int = 4) -> int:
    """The split kernel's shared memory: the K and V rows of a split
    (``CHUNK`` x D of the input type, each row padded by 16 bytes), q
    scaled and the logits (G x D and G x ``CHUNK``, float32)."""
    return 2 * CHUNK * (D * itemsize + 16) + 4 * G * (D + CHUNK)


def _splits(S: int) -> list[tuple[int, int]]:
    """The slot range ``[lo, hi)`` of each split of a cache of capacity S
    (one empty split when S = 0); on the card a split also stops at its
    row's length."""
    return [(lo, min(lo + CHUNK, S)) for lo in range(0, max(S, 1), CHUNK)]


def _workspace_floats(B: int, Hkv: int, G: int, S: int, D: int) -> int:
    """float32 partials of the split pass: (B, Hkv, splits, G, D) outputs,
    then (B, Hkv, splits, G, 2) maxima and normalisers."""
    return B * Hkv * len(_splits(S)) * G * (D + 2)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: torch.Tensor, scale: float | None = None,
                     with_lse: bool = False):
    """One-token attention against the cache, as ``ref.decode_attention``
    for every ``length[b] >= 1`` (a row with length 0 gets zeros here,
    as the TPU kernel gives). ``with_lse``: also the (B, Hq) float32
    log-sum-exp of each row's scaled logits over its live slots (-inf
    at length 0), returned as ``(out, lse)``.

    ``q`` (B, Hq, D), ``k`` and ``v`` (B, Hkv, S, D), one dtype (float32
    or bfloat16), ``length`` (B,) int32, contiguous on one CUDA device,
    Hq a multiple of Hkv, D in ``HEAD_DIMS``. Returns (B, Hq, D) in q's
    dtype, within float32 rounding of the plain version before the cast
    (sums in another order, CUDA's expf). Launches the split and combine
    kernels on the current stream and counts one launch a call. It has
    no backward: an input that requires grad under grad mode raises
    (``_build.refuse_grad``).
    """
    launch = _launcher()
    _build.refuse_grad("decode_attention", q, k, v)
    B, Hq, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    _require(q.is_cuda and all(t.device == q.device for t in (k, v, length)),
             "tensors must share a CUDA device")
    _require(q.dtype in DTYPES and k.dtype == q.dtype and v.dtype == q.dtype,
             "q, k, v must all be float32 or all bfloat16")
    _require(length.dtype == torch.int32 and length.shape == (B,),
             "length must be (B,) int32")
    _require(k.shape == (B, Hkv, S, D) and v.shape == k.shape
             and Hkv > 0 and Hq % Hkv == 0, "shapes")
    _require(D in HEAD_DIMS, f"head_dim {D} not in {HEAD_DIMS}")
    _require(_smem_bytes(Hq // Hkv, D, q.element_size()) <= _SMEM_LIMIT,
             f"group of {Hq // Hkv} heads of {D} exceeds shared memory")
    _require(all(t.is_contiguous() and t.data_ptr() % 16 == 0
                 for t in (q, k, v, length)), "tensors must be contiguous")
    out = torch.empty_like(q)
    lse = (torch.empty((B, Hq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if q.numel() == 0:
        return (out, lse) if with_lse else out
    scale = scale if scale is not None else D ** -0.5
    work = torch.empty(_workspace_floats(B, Hkv, Hq // Hkv, S, D),
                       dtype=torch.float32, device=q.device)
    err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
                 out.data_ptr(), lse.data_ptr() if with_lse else None,
                 work.data_ptr(), DTYPES[q.dtype], B, Hkv,
                 Hq // Hkv, S, D, scale,
                 torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "decode_attention_launch")
    decode_attention.launches += 1
    return (out, lse) if with_lse else out


decode_attention.launches = 0
