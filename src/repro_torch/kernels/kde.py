"""Fused Alg-1 maintenance statistics, and the KDE success probability
alone, as CUDA kernels for Hopper.

Port of the TPU kernel ``repro/kernels/kde.py::fused_maintenance``:
per (player, arm) row of R windowed latencies, the Silverman bandwidth,
the Gaussian-CDF success probability at tau and the masked
rho-quantile of ``max(lat - rtt, 0)``, in one pass. The kernel is
``csrc/maintenance.cu`` (one warp per row; its header says what bounds
it and why it is built so); ``ref.bandit_maintenance_stats`` is its
plain PyTorch version. ``kde_success_prob`` ports the TPU kernel of that
name, the middle stage with the bandwidths given: the second kernel in
``csrc/maintenance.cu``, plain version ``ref.kde_success_prob``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_P = ctypes.c_void_p


@functools.cache
def _launcher():
    return _build.function("maintenance_launch", [
        _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, _P])


def _require(ok: bool, what: str, name: str = "fused_maintenance") -> None:
    if not ok:
        raise ValueError(f"{name}: {what}")


def fused_maintenance(lat: torch.Tensor, mask: torch.Tensor,
                      rtt: torch.Tensor, tau: float, rho: float,
                      min_bandwidth: float = 1e-4):
    """Bandwidth + KDE success prob + rho-quantile, one warp per row.

    ``lat`` (rows, R) float32, ``mask`` (rows, R) bool, ``rtt`` (rows,)
    float32, all contiguous on one CUDA device, R <= 1024. Returns
    ``(mu (rows,), q (rows,))``: q bit-exact against
    ``ref.bandit_maintenance_stats``, mu within a few float32 ULP (warp
    tree sums, CUDA's erff/powf). Launches on the current stream.
    """
    launch = _launcher()
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
    err = launch(lat.data_ptr(), mask.data_ptr(), rtt.data_ptr(),
                 mu.data_ptr(), q.data_ptr(), rows, R, tau, rho,
                 min_bandwidth, torch.cuda.current_stream(lat.device).cuda_stream)
    _build.check(err, "maintenance_launch")
    fused_maintenance.launches += 1
    return mu, q


fused_maintenance.launches = 0


_KDE = "kde_success_prob"


@functools.cache
def _kde_launcher():
    return _build.function("kde_launch", [
        _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_float, _P])


def kde_success_prob(lat: torch.Tensor, mask: torch.Tensor, tau: float,
                     bandwidth: torch.Tensor) -> torch.Tensor:
    """Masked mean Gaussian CDF at tau per row, one warp per row.

    ``lat`` (rows, R) float32, ``mask`` (rows, R) bool, ``bandwidth``
    (rows,) float32, all contiguous on one CUDA device. Returns (rows,)
    float32, within a few float32 ULP of ``ref.kde_success_prob`` (warp
    tree sums, CUDA's erff). Launches on the current stream.
    """
    launch = _kde_launcher()
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
                 out.data_ptr(), rows, R, float(tau),
                 torch.cuda.current_stream(lat.device).cuda_stream)
    _build.check(err, "kde_launch")
    kde_success_prob.launches += 1
    return out


kde_success_prob.launches = 0
