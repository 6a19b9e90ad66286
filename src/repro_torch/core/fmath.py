"""float32 elementary functions rounded as the reference's compiler rounds them.

The reference draws its noise on XLA:CPU, which lowers ``exp``,
``log``, ``log1p`` and ``erf_inv`` to fixed polynomial approximations
(Cephes' ``expf``/``logf``, a rational ``log1p`` for small arguments,
Giles' ``erfinv``, a rational ``erf``) and, on an x86 host with FMA,
contracts each ``a * b + c`` of them into one fused multiply-add. It
also runs with denormals flushed to zero. ``torch.exp``/``torch.log``
use other algorithms and land a few ULP away, enough to move a latency
across a histogram edge. The functions here replay XLA's operation
sequence, FMA for FMA, so a draw made from the same bits is the same
float.

``fma`` is emulated in float64: the product of two float32 values is
exact there, so only the sum is rounded twice (to float64, then to
float32), which differs from one rounding with probability about
2^-29 per operation. The functions are plain torch ops, on any device.
"""
from __future__ import annotations

import numpy as np
import torch

_TINY = float(np.finfo(np.float32).tiny)


def _c(x: float) -> float:
    """A constant as the float32 value the compiled code holds."""
    return float(np.float32(x))


def fma(a, b, c) -> torch.Tensor:
    """``a * b + c`` with the product unrounded (float32 in and out)."""
    def f64(x):
        return x.double() if isinstance(x, torch.Tensor) else float(np.float32(x))
    out = f64(a) * f64(b) + f64(c)
    return out.float()


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """float32 square root, correctly rounded as the reference's is:
    through float64, whose root rounds to the nearest float32. torch's
    own float32 ``sqrt`` on the CPU takes a vectorised path for most
    elements of a tensor that lands an ULP away for some inputs."""
    return torch.sqrt(x.double()).float()


def _ftz(x: torch.Tensor) -> torch.Tensor:
    """Flush denormals to zero, as the reference's host does."""
    return torch.where(x.abs() < _TINY, 0.0 * x, x)


_EXP_LO, _EXP_HI = _c(-87.8), _c(88.8)
_EXP_POLY = tuple(map(_c, (0.00019875691, 0.0013981999, 0.008333452,
                           0.041665796, 0.16666666, 0.5)))


def exp(x: torch.Tensor) -> torch.Tensor:
    """Cephes ``expf``: ``2^n · p(x - n·ln2)``."""
    x = torch.where(x < _EXP_LO, _EXP_LO, x)       # NaN passes through
    x = torch.where(x > _EXP_HI, _EXP_HI, x)
    fx = torch.floor(fma(x, _c(1.442695), 0.5)).clamp(-127.0, 127.0)
    z = fma(-_c(0.6933594), fx, x)
    z = fma(-_c(-0.00021219444), fx, z)
    y = fma(z, _EXP_POLY[0], _EXP_POLY[1])
    for c in _EXP_POLY[2:]:
        y = fma(y, z, c)
    y = 1.0 + fma(y, z * z, z)
    pow2n = ((fx.to(torch.int32) + 127) << 23).view(torch.float32)
    return _ftz(y * pow2n)


def _log_normal(v: torch.Tensor) -> torch.Tensor:
    """Cephes ``logf`` for finite ``v >= FLT_MIN``."""
    bits = v.view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)   # [0.5, 1)
    small = m < _c(0.70710677)
    x = (m - 1.0) + torch.where(small, m, 0.0)
    e = e - torch.where(small, 1.0, 0.0)
    z = x * x
    x3 = z * x
    y1 = fma(fma(x, _c(0.070376836), _c(-0.1151461)), x, _c(0.116769984))
    y2 = fma(fma(x, _c(-0.12420141), _c(0.14249323)), x, _c(-0.16668057))
    y3 = fma(fma(x, _c(0.20000714), _c(-0.24999994)), x, _c(0.3333333))
    y2 = fma(y1, x3, y2)
    y3 = fma(y2, x3, y3)
    y = fma(y3, x3, e * _c(-0.00021219444))
    r = fma(z, -0.5, x) + y
    return fma(e, _c(0.6933594), r)


def log(v: torch.Tensor) -> torch.Tensor:
    """Cephes ``logf`` with IEEE special cases; denormal inputs are 0."""
    v = _ftz(v)
    r = _log_normal(torch.where(v >= _TINY, v, _TINY))
    r = torch.where(v < 0, float("nan"), r)
    r = torch.where(v == 0, float("-inf"), r)
    r = torch.where(v == float("inf"), float("inf"), r)
    return torch.where(torch.isnan(v), v, r)


_LOG1P_P = tuple(map(_c, (1.0, 15.062909, 83.04757, 221.7624, 309.09872,
                          216.42789, 60.11866)))
_LOG1P_Q = tuple(map(_c, (4.527e-05, 0.49854103, 6.5787325, 29.911919,
                          60.94967, 57.112965, 20.039553)))
_LOG1P_SMALL = _c(0.41421354)        # |x| below this: the rational form


def log1p(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + x)``: a rational approximation for small ``|x|``, else
    ``log`` of the rounded sum."""
    p = fma(x, 0.0, _LOG1P_P[0])
    for c in _LOG1P_P[1:]:
        p = fma(p, x, c)
    q = fma(x, 0.0, _LOG1P_Q[0])
    for c in _LOG1P_Q[1:]:
        q = fma(q, x, c)
    x2 = x * x
    small = x + fma(x2, -0.5, (x * x2) * (q / p))
    return torch.where(x.abs() < _LOG1P_SMALL, small, log(x + 1.0))


_ERFINV_LT5 = tuple(map(_c, (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                             -4.39150654e-06, 0.00021858087, -0.00125372503,
                             -0.00417768164, 0.246640727, 1.50140941)))
_ERFINV_GE5 = tuple(map(_c, (-0.000200214257, 0.000100950558, 0.00134934322,
                             -0.00367342844, 0.00573950773, -0.0076224613,
                             0.00943887047, 1.00167406, 2.83297682)))


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """Giles' single-precision ``erfinv`` (two polynomial branches)."""
    w = -log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = fma(p, w, torch.where(lt, a, b))
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


_ERF_CLAMP = _c(3.7439211627767994)
_ERF_P = tuple(map(_c, (2.2905065861350646e-4, 3.4082910107109506e-3,
                        5.0955695062380861e-2, 1.8520832239976145e-1,
                        1.128379143519084)))
_ERF_Q = tuple(map(_c, (-1.1791602954361697e-7, 2.3547966471313185e-5,
                        1.0179625278914885e-3, 1.4070470171167667e-2,
                        1.1098505178285362e-1, 4.9746925110067538e-1,
                        1.0)))


def erf(x: torch.Tensor) -> torch.Tensor:
    """float32 ``erf``: ``x * p(x^2) / q(x^2)`` on x clamped to
    +-3.7439, where the quotient reaches 1.0f; each polynomial an FMA
    Horner chain in ``x^2``."""
    x = _ftz(x).clamp(-_ERF_CLAMP, _ERF_CLAMP)
    x2 = (x * x).double()
    p = torch.full_like(x, _ERF_P[0])
    for c in _ERF_P[1:]:
        torch.add(p * x2, c, out=p)      # fma(p, x2, c), stored in float32
    q = torch.full_like(x, _ERF_Q[0])
    for c in _ERF_Q[1:]:
        torch.add(q * x2, c, out=q)
    return x * p / q
