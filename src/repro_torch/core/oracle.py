"""Oracle weights and regret (paper §IV-D, Eq. 8–9).

Port of ``repro/core/oracle.py``. The oracle weight vector is a one-hot
on the best arm, so per-step regret is ``max_m mu - <w, mu>``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import _xla_row_dot, lane_rows


def oracle_weights(mu: torch.Tensor,
                   active: torch.Tensor | None = None) -> torch.Tensor:
    """(K, M) one-hot on argmax_m mu_{k,m} over active arms."""
    if active is not None:
        mu = torch.where(active[None, :], mu, -torch.inf)
    best = torch.argmax(mu, dim=-1)
    return torch.nn.functional.one_hot(best, mu.shape[-1]).to(torch.float32)


def step_regret(weights: torch.Tensor, mu: torch.Tensor,
                active: torch.Tensor | None = None) -> torch.Tensor:
    """Per-player instantaneous regret (Eq. 8 summand). Returns (K,).
    ``active`` is (M,), or (S, M) for S lanes of K/S players each."""
    mu_eff = (torch.where(lane_rows(active, mu.shape[0]), mu, -torch.inf)
              if active is not None else mu)
    best = mu_eff.max(-1).values
    # the reference's compiler sums the products as an FMA chain
    got = _xla_row_dot(weights, torch.where(torch.isfinite(mu_eff), mu, 0.0))
    return torch.clamp_min(best - got, 0.0)


def variation_budget(mu_t: torch.Tensor) -> torch.Tensor:
    """V_k(T) (Definition 1) from a (T, K, M) trajectory of true mus."""
    d = torch.abs(mu_t[1:] - mu_t[:-1])
    return d.max(-1).values.sum(0)
