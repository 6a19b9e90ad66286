"""Mamba-2 SSD chunked scan as a CUDA kernel for Hopper.

Port of the TPU kernel ``repro/kernels/ssd.py::ssd``: per (batch row,
head) the state (N, P) is carried across the sequence, the products of
each chunk computed by the SSD decomposition, in float32 inside, with B
and C shared by all heads (ngroups = 1). The kernel is ``csrc/ssd.cu``
(one CTA per (batch row, head), walking the sequence in tiles of 32
rows; its header says what bounds it and why it is built so);
``ref.ssd``, the sequential recurrence, is its plain PyTorch version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
STATE_DIMS = (8, 16, 128)             # N: reduced configs, hymba, mamba2
HEAD_DIMS = (16, 32, 64)              # P
TILE = 32                             # rows per tile in csrc/ssd.cu


@functools.cache
def _launcher():
    return _build.function("ssd_launch", [
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(f"ssd: {what}")


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        Bm: torch.Tensor, Cm: torch.Tensor, chunk: int = 128) -> torch.Tensor:
    """The SSD scan, as ``ref.ssd``.

    ``x`` (B, S, H, P) float32 or bfloat16; ``dt`` (B, S, H), ``A``
    (H,), ``Bm`` and ``Cm`` (B, S, N) float32; all contiguous on one
    CUDA device, N in ``STATE_DIMS``, P in ``HEAD_DIMS``. ``chunk`` is
    the TPU kernel's chunk length; the decomposition is exact for any
    chunk, and the CUDA kernel always works in tiles of ``TILE`` rows,
    so it changes nothing but the rounding the reference would give.
    Returns (B, S, H, P) in x's dtype, within float32 rounding of the
    plain version (another summation order, CUDA's expf). Launches on
    the current stream.
    """
    launch = _launcher()
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    _require(chunk >= 1, f"chunk {chunk} < 1")
    _require(x.is_cuda and all(t.device == x.device for t in (dt, A, Bm, Cm)),
             "tensors must share a CUDA device")
    _require(x.dtype in DTYPES and all(t.dtype == torch.float32
                                       for t in (dt, A, Bm, Cm)),
             "x must be float32 or bfloat16, dt, A, Bm, Cm float32")
    _require(dt.shape == (Bsz, S, H) and A.shape == (H,)
             and Bm.shape == (Bsz, S, N) and Cm.shape == Bm.shape, "shapes")
    _require(N in STATE_DIMS, f"state dim {N} not in {STATE_DIMS}")
    _require(P in HEAD_DIMS, f"head dim {P} not in {HEAD_DIMS}")
    _require(all(t.is_contiguous() and t.data_ptr() % 16 == 0
                 for t in (x, dt, A, Bm, Cm)), "tensors must be contiguous")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    err = launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                 Cm.data_ptr(), y.data_ptr(), DTYPES[x.dtype], Bsz, S, H, N, P,
                 torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ssd_launch")
    ssd.launches += 1
    return y


ssd.launches = 0
