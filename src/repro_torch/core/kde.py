"""Kernel Density Estimation of QoS success probabilities (paper §V-A).

Port of ``repro/core/kde.py``: the Gaussian-kernel CDF at the latency
threshold, ``mu_hat = (1/n) * sum_i Phi((tau - l_i) / h)``, over the
masked samples of each sliding window, with Silverman's bandwidth.
``empirical_success_prob`` is the prior-work fraction below tau.

These pure functions are the composition the fused maintenance kernel
(``repro_torch/kernels``) computes in one pass.
"""
from __future__ import annotations

import torch

from repro_torch.core import fmath

_INV_SQRT2 = 0.7071067811865476


def normal_cdf(x: torch.Tensor) -> torch.Tensor:
    """Standard normal CDF through the reference's float32 ``erf``
    (``fmath.erf``), on every device."""
    return 0.5 * (1.0 + fmath.erf(x * _INV_SQRT2))


def silverman_bandwidth(lat: torch.Tensor, mask: torch.Tensor,
                        min_bandwidth: float = 1e-4) -> torch.Tensor:
    """Per-row Silverman bandwidth h = 1.06 * sigma * n^(-1/5).

    ``lat``: (..., R) samples, ``mask``: (..., R) validity. Rows with
    fewer than 2 samples fall back to ``min_bandwidth``.
    """
    m = mask.to(lat.dtype)
    n = torch.clamp_min(m.sum(-1), 1.0)
    mean = (lat * m).sum(-1) / n
    var = ((lat - mean[..., None]) ** 2 * m).sum(-1) / n
    sigma = fmath.sqrt(torch.clamp_min(var, 0.0))
    h = 1.06 * sigma * n ** (-0.2)
    return torch.clamp_min(h, min_bandwidth)


def kde_success_prob(lat: torch.Tensor, mask: torch.Tensor, tau: float,
                     bandwidth: torch.Tensor | None = None,
                     min_bandwidth: float = 1e-4) -> torch.Tensor:
    """P(latency <= tau) via Gaussian-kernel CDF over masked samples.

    Returns (...,) in [0, 1]; rows with no valid sample return 0.
    """
    if bandwidth is None:
        bandwidth = silverman_bandwidth(lat, mask, min_bandwidth)
    m = mask.to(lat.dtype)
    n = m.sum(-1)
    z = (tau - lat) / bandwidth[..., None]
    contrib = (normal_cdf(z) * m).sum(-1)
    return torch.where(n > 0, contrib / torch.clamp_min(n, 1.0), 0.0)


def empirical_success_prob(lat: torch.Tensor, mask: torch.Tensor,
                           tau: float) -> torch.Tensor:
    """Plain windowed success fraction (the [2] baseline estimator)."""
    m = mask.to(lat.dtype)
    n = m.sum(-1)
    succ = ((lat <= tau) * m).sum(-1)
    return torch.where(n > 0, succ / torch.clamp_min(n, 1.0), 0.0)


def masked_quantile(x: torch.Tensor, mask: torch.Tensor,
                    q: float) -> torch.Tensor:
    """q-quantile over masked samples along the last axis.

    Invalid entries are pushed to float32 max before sorting; the index
    ``int(q * (n - 1))`` is taken in float32 as the reference does. Rows
    with no samples return float32 max.
    """
    big = torch.finfo(x.dtype).max
    xs = torch.sort(torch.where(mask, x, big), dim=-1)[0]
    n = mask.sum(-1).to(torch.float32)
    idx = torch.clamp((q * (n - 1.0)).to(torch.int64), 0, x.shape[-1] - 1)
    val = torch.gather(xs, -1, idx[..., None])[..., 0]
    return torch.where(n > 0, val, big)
