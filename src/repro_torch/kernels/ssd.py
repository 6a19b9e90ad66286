"""Mamba-2 SSD chunked scan as CUDA kernels for Hopper.

Port of the TPU kernel ``repro/kernels/ssd.py::ssd``: per (batch row,
head) the state (N, P) is carried across the sequence, the products of
each chunk computed by the SSD decomposition, in float32 inside, with B
and C shared by all heads (ngroups = 1). The kernels are in
``csrc/ssd.cu``, chosen by x's dtype alone: bfloat16 runs four passes on
the tensor cores over chunks of ``CHUNK`` rows in parallel (C·Bᵀ once per
chunk for all heads, the chunk states, the pass of the states across
chunks, the chunk scan; every float32 operand as two bf16 terms), float32
one kernel on the CUDA cores (one CTA per (batch row, head), walking the
sequence in tiles of 32 rows). The header says what bounds them and
why they are built so; ``ref.ssd``, the sequential recurrence, is their
plain PyTorch version.

``ssd_bwd`` is the backward, a kernel the TPU package does not have (its
training differentiates the plain scan): four CUDA kernels in
``csrc/ssd_bwd.cu``, float32 on the CUDA cores for both dtypes of x, in
tiles of ``BWD_TILE`` rows, deterministic (no atomics).
``ref.ssd_grads`` is its plain version; ``ops.ssd`` pairs the two in an
autograd Function.
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
CHUNK = 256                           # chunk rows of the bfloat16 passes
ROWS = 64                             # rows of one wgmma tile
SCAN_HEADS = 8                        # heads per CTA of the chunk scan
SCAN_ROWS = 128                       # rows per CTA of the chunk scan
LAUNCHES_PER_CALL = {torch.float32: 1, torch.bfloat16: 4}   # CUDA launches
BWD_TILE = 32                         # rows of a tile of the backward
# (N, P) the backward is built for: the SSM and hybrid configs', reduced
# (8, 16), hymba (16, 64), mamba2 (128, 64)
BWD_WIDTHS = ((8, 16), (16, 64), (128, 64))
BWD_LAUNCHES_PER_CALL = 4             # CUDA launches of one ssd_bwd call


def _padded_state(N: int) -> int:
    """N padded with zeros to whole 64-column boxes (``tc::Dims::kNP``)."""
    return 128 if N > 64 else 64


def _chunks(S: int) -> int:
    return -(-S // CHUNK)


def _workspace_floats(B: int, S: int, H: int, N: int, P: int) -> int:
    """float32 entries of the bfloat16 passes' workspace (``tc::carve``):
    C·Bᵀ (B, nc, T, T), the chunk states (B, nc, H, N, P), cum and dt
    (B, nc, H, 2, T), the chunk decays (B, nc, H)."""
    bc = B * _chunks(S)
    return (bc * CHUNK * CHUNK + bc * H * N * P + bc * H * 2 * CHUNK
            + bc * H)


def _bwd_tiles(S: int) -> int:
    return -(-S // BWD_TILE)


def _bwd_workspace_floats(B: int, S: int, H: int, N: int, P: int) -> int:
    """float32 entries of the backward's workspace (``bwd::launch``): the
    state entering each tile and the adjoint leaving it (B, H, tiles, N,
    P) each, the heads' partials of dB and dC (B, H, S, N) each, r and
    x . v (B, H, S) each, dA's partials (B, H)."""
    bh = B * H
    return (2 * bh * _bwd_tiles(S) * N * P + 2 * bh * S * N + 2 * bh * S
            + bh)


def _h_rows(N: int) -> int:
    """h_in rows in the scan's shared memory: N, at least one k-step."""
    return max(16, N)


def _smem_bytes(N: int) -> dict:
    """Shared memory of each pass (``tc::cb_smem`` etc.): 1024 bytes of
    alignment slack, then bf16 tiles of 64 rows by N padded (hi and lo
    terms), float32 scan arrays: C·Bᵀ's four 64-row tiles; the states'
    B·w and x of one 64-row slab; the scan's C·Bᵀ block (SCAN_ROWS rows of
    CHUNK + 8 floats), x (CHUNK rows), h_in (hi and lo), cum and dt."""
    tile = ROWS * _padded_state(N) * 2
    return {"cb": 1024 + 4 * tile,
            "state": (1024 + 2 * tile + ROWS * 128
                      + (2 * CHUNK + CHUNK // 32) * 4),
            "pass": 0,
            "scan": (1024 + SCAN_ROWS * (CHUNK + 8) * 4 + CHUNK * 128
                     + 2 * _h_rows(N) * 128 + 2 * CHUNK * 4)}


def _grids(B: int, S: int, H: int, N: int, P: int) -> dict:
    """Each pass's (grid, threads per CTA), as ``tc::launch`` launches
    them: C·Bᵀ over the lower 64-row tiles of every (batch row, chunk);
    the states per (head, chunk, batch row); the pass over (P·N / 8,
    head, batch row), a thread per run of 8 entries; the scan per
    (``SCAN_ROWS``-row block, ``SCAN_HEADS`` heads, batch row and chunk),
    the blocks that share x next to each other."""
    nc = _chunks(S)
    blocks = CHUNK // ROWS
    return {"cb": ((blocks * (blocks + 1) // 2, B * nc, 1), 128),
            "state": ((H, nc, B), 2 * _padded_state(N)),
            "pass": ((-(-N * P // 8 // 256), H, B), 256),
            "scan": ((CHUNK // SCAN_ROWS, -(-H // SCAN_HEADS), B * nc), 256)}


def _mma_flops(B: int, S: int, H: int, N: int, P: int) -> int:
    """Tensor-core FLOPs the bfloat16 passes issue, padding and split
    terms included: C·Bᵀ three m64n64 products per k-step over the padded
    N of each live lower tile; the states two per 64-row slab, per 64
    state rows; the scan three for C·h_in over N (at least 16; chunks
    after the first) and two per tile of M (at most: the scan skips the
    tiles whose decays all underflow)."""
    NP = _padded_state(N)
    nc = _chunks(S)
    blocks = CHUNK // ROWS
    mma = 2 * ROWS * 64                           # m64 n64, per unit of K
    flops = 0
    for c in range(nc):
        live = [ib for ib in range(blocks) if c * CHUNK + ib * ROWS < S]
        flops += B * sum(ib + 1 for ib in live) * 3 * mma * NP
        flops += B * H * len(live) * (NP // 64) * 2 * mma * ROWS
        flops += B * H * len(live) * (3 * mma * _h_rows(N) if c else 0)
        flops += B * H * sum(ib + 1 for ib in live) * 2 * mma * ROWS
    return flops


@functools.cache
def _launcher():
    return _build.function("ssd_launch", [
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])


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
    chunk, and the CUDA kernels always work in their own (``CHUNK``
    rows in bfloat16, 32-row tiles in float32), so it changes nothing
    but the rounding the reference would give. Returns (B, S, H, P) in
    x's dtype: float32 within float32 rounding of the plain version (another
    summation order, CUDA's expf); bfloat16 within about one bf16 step of
    it (every float32 operand of a product enters as two bf16 terms).
    One call is one count of ``ssd.launches`` and ``LAUNCHES_PER_CALL``
    CUDA launches on the current stream; bfloat16 also allocates a float32
    workspace of ``_workspace_floats`` entries (33.5 MB of chunk states at
    the serving shape). It records no autograd graph: ``ops.ssd`` wraps
    it with ``ssd_bwd`` in an autograd Function.
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
    ws = None
    if x.dtype == torch.bfloat16:
        ws = torch.empty(_workspace_floats(Bsz, S, H, N, P),
                         dtype=torch.float32, device=x.device)
    err = launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                 Cm.data_ptr(), y.data_ptr(), None if ws is None else
                 ws.data_ptr(), DTYPES[x.dtype], Bsz, S, H, N, P,
                 torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ssd_launch")
    ssd.launches += 1
    return y


ssd.launches = 0


@functools.cache
def _bwd_launcher():
    return _build.function("ssd_bwd_launch", [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
        _I, _P])


def ssd_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor):
    """The gradients ``(dx, ddt, dA, dB, dC)`` of ``ssd(x, dt, A, Bm,
    Cm)`` against the output gradient ``dy``, as ``ref.ssd_grads``.

    The inputs follow ``ssd``'s rules, (N, P) in ``BWD_WIDTHS``; ``dy``
    (B, S, H, P) in x's dtype may be strided (it is made contiguous). Returns dx in x's dtype, ddt
    (B, S, H), dA (H,), dB and dC (B, S, N) in float32, all computed in
    float32 on the CUDA cores: float32 sums in another order than the
    plain version's (CUDA's expf), dx rounded once to x's dtype. Four
    CUDA launches on the current stream (``BWD_LAUNCHES_PER_CALL``), no
    atomics (two calls give the same bits); allocates a float32
    workspace of ``_bwd_workspace_floats`` entries (404 MB at
    mamba2-1.3b's training shape, B 8, S 256). Counts one launch a call.
    A training step with remat runs ``ssd`` twice a layer (the step's
    forward and the checkpoint's recomputation) and this once.
    """
    launch = _bwd_launcher()
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    dy = dy.contiguous()
    _require(x.is_cuda and all(t.device == x.device
                               for t in (dt, A, Bm, Cm, dy)),
             "tensors must share a CUDA device")
    _require(x.dtype in DTYPES and dy.dtype == x.dtype
             and all(t.dtype == torch.float32 for t in (dt, A, Bm, Cm)),
             "x and dy must be float32 or bfloat16, dt, A, Bm, Cm float32")
    _require(dt.shape == (Bsz, S, H) and A.shape == (H,)
             and Bm.shape == (Bsz, S, N) and Cm.shape == Bm.shape
             and dy.shape == x.shape, "shapes")
    _require((N, P) in BWD_WIDTHS,
             f"(state, head) dims {(N, P)} not in {BWD_WIDTHS}")
    _require(all(t.is_contiguous() and t.data_ptr() % 16 == 0
                 for t in (x, dt, A, Bm, Cm, dy)),
             "tensors must be contiguous")
    dx = torch.empty_like(x)
    ddt, dA, dB, dC = (torch.empty_like(t) for t in (dt, A, Bm, Cm))
    if x.numel() == 0:
        return dx, ddt, dA.zero_(), dB, dC
    ws = torch.empty(_bwd_workspace_floats(Bsz, S, H, N, P),
                     dtype=torch.float32, device=x.device)
    err = launch(*(t.data_ptr() for t in (x, dt, A, Bm, Cm, dy, dx, ddt, dA,
                                          dB, dC, ws)),
                 DTYPES[x.dtype], Bsz, S, H, N, P,
                 torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ssd_bwd_launch")
    ssd_bwd.launches += 1
    return dx, ddt, dA, dB, dC


ssd_bwd.launches = 0
