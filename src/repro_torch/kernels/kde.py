"""Fused Alg-1 maintenance statistics, and the KDE success probability
alone, as CUDA kernels for Hopper.

Port of the TPU kernel ``repro/kernels/kde.py::fused_maintenance``:
per (player, arm) row of R windowed latencies, the Silverman bandwidth,
the Gaussian-CDF success probability at tau and the masked
rho-quantile of ``max(lat - rtt, 0)``, in one pass. The kernel is
``csrc/maintenance.cu`` (each row in the registers of the lanes
``row_geometry`` gives it, the quantile by a bitonic sort across them;
its header says what bounds it and why it is built so);
``ref.bandit_maintenance_stats`` is its plain PyTorch version.
``kde_success_prob`` ports the TPU kernel of that name, the middle stage
with the bandwidths given: the second kernel in ``csrc/maintenance.cu``
(``kde_geometry`` lays out its rows), plain version
``ref.kde_success_prob``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.cache
def _launcher():
    return _build.function("maintenance_launch", [
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _P])


def row_geometry(R: int) -> tuple[int, int]:
    """(lanes, chunks) of a row of R samples in the kernels: the fewest
    lanes, a power of two up to 32, that hold its ceil(R / 4) quads of
    4 samples, each lane holding ``chunks`` quads (a power of two, above
    1 only at 32 lanes)."""
    quads = -(-R // 4)
    lanes = min(32, 1 << (quads - 1).bit_length())
    return lanes, 1 << (-(-quads // lanes) - 1).bit_length()


def _vector_loads(lat: torch.Tensor, mask: torch.Tensor) -> int:
    """1 where every quad can be one 16-byte load of ``lat`` and one
    4-byte load of ``mask``: R a multiple of 4 and both rows aligned."""
    return int(lat.shape[1] % 4 == 0 and lat.data_ptr() % 16 == 0
               and mask.data_ptr() % 4 == 0)


def _require(ok: bool, what: str, name: str = "fused_maintenance") -> None:
    if not ok:
        raise ValueError(f"{name}: {what}")


def fused_maintenance(lat: torch.Tensor, mask: torch.Tensor,
                      rtt: torch.Tensor, tau: float, rho: float,
                      min_bandwidth: float = 1e-4):
    """Bandwidth + KDE success prob + rho-quantile per row.

    ``lat`` (rows, R) float32, ``mask`` (rows, R) bool, ``rtt`` (rows,)
    float32, all contiguous on one CUDA device, R <= 1024. Returns
    ``(mu (rows,), q (rows,))``, both bit-exact against
    ``ref.bandit_maintenance_stats``: q the same sample of the same rank
    (of equal zeros, the one of lowest index), mu computed op for op as
    the plain version computes it (its row sums in XLA:CPU's order, its
    ``n ** -0.2`` table, which this passes in, ``fmath.erf``, a correctly
    rounded root). Launches on the current stream. No backward: a float
    input that requires grad under grad mode raises.
    """
    launch = _launcher()
    _build.refuse_grad("fused_maintenance", lat, rtt)
    rows, R = lat.shape
    _require(lat.is_cuda and mask.device == lat.device
             and rtt.device == lat.device, "tensors must share a CUDA device")
    _require(lat.dtype == torch.float32 and rtt.dtype == torch.float32
             and mask.dtype == torch.bool, "dtypes must be f32, bool, f32")
    _require(mask.shape == lat.shape and rtt.shape == (rows,), "shapes")
    _require(lat.is_contiguous() and mask.is_contiguous()
             and rtt.is_contiguous(), "tensors must be contiguous")
    _require(0 < R <= 1024, f"R={R} outside 1..1024")
    mu = torch.empty(rows, dtype=torch.float32, device=lat.device)
    q = torch.empty(rows, dtype=torch.float32, device=lat.device)
    if rows == 0:
        return mu, q
    pow_table = ref._powf_on(R, lat.device)      # glibc's n ** -0.2, n <= R
    err = launch(lat.data_ptr(), mask.data_ptr(), rtt.data_ptr(),
                 pow_table.data_ptr(), mu.data_ptr(), q.data_ptr(), rows, R,
                 *row_geometry(R),
                 _vector_loads(lat, mask), tau, rho, min_bandwidth,
                 torch.cuda.current_stream(lat.device).cuda_stream)
    _build.check(err, "maintenance_launch")
    fused_maintenance.launches += 1
    return mu, q


fused_maintenance.launches = 0


_KDE = "kde_success_prob"


def kde_geometry(R: int) -> tuple[int, int]:
    """(lanes, chunks) of ``kde_success_prob``'s kernel: a lane takes up
    to 4 quads (16 samples) of a row at a time, on the fewest lanes (a
    power of two up to 32) that hold the row; a longer row runs in
    segments of 4 * lanes * chunks samples. At R = 64: 4 lanes of 4 quads,
    8 rows a warp."""
    quads = -(-R // 4)
    chunks = min(4, 1 << (quads - 1).bit_length())
    return min(32, 1 << (-(-quads // chunks) - 1).bit_length()), chunks


@functools.cache
def _kde_launcher():
    return _build.function("kde_launch", [
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P])


def kde_success_prob(lat: torch.Tensor, mask: torch.Tensor, tau: float,
                     bandwidth: torch.Tensor) -> torch.Tensor:
    """Masked mean Gaussian CDF at tau per row.

    ``lat`` (rows, R) float32, ``mask`` (rows, R) bool, ``bandwidth``
    (rows,) float32, all contiguous on one CUDA device. Returns (rows,)
    float32, within a few float32 ULP of ``ref.kde_success_prob`` (shuffle
    tree sums, CUDA's erff, one reciprocal of the bandwidth a row).
    Launches on the current stream. No backward: a float input that
    requires grad under grad mode raises.
    """
    launch = _kde_launcher()
    _build.refuse_grad(_KDE, lat, bandwidth)
    rows, R = lat.shape
    _require(lat.is_cuda and mask.device == lat.device
             and bandwidth.device == lat.device,
             "tensors must share a CUDA device", _KDE)
    _require(lat.dtype == torch.float32 and bandwidth.dtype == torch.float32
             and mask.dtype == torch.bool, "dtypes must be f32, bool, f32", _KDE)
    _require(mask.shape == lat.shape and bandwidth.shape == (rows,), "shapes",
             _KDE)
    _require(lat.is_contiguous() and mask.is_contiguous()
             and bandwidth.is_contiguous(), "tensors must be contiguous", _KDE)
    _require(R > 0, f"R={R} < 1", _KDE)
    out = torch.empty(rows, dtype=torch.float32, device=lat.device)
    if rows == 0:
        return out
    err = launch(lat.data_ptr(), mask.data_ptr(), bandwidth.data_ptr(),
                 out.data_ptr(), rows, R, *kde_geometry(R),
                 _vector_loads(lat, mask), float(tau),
                 torch.cuda.current_stream(lat.device).cuda_stream)
    _build.check(err, "kde_launch")
    kde_success_prob.launches += 1
    return out


kde_success_prob.launches = 0
