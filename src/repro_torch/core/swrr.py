"""Smooth Weighted Round Robin (paper §V-B, NGINX-style).

Port of ``repro/core/swrr.py``: ``cw += w``; pick ``argmax(cw)``;
subtract the total weight from the winner. Vectorized over the leading
player axis.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import _row_sum


def swrr_select(weights: torch.Tensor, cw: torch.Tensor):
    """One SWRR selection per player (row).

    ``weights``: (K, M) nonnegative routing weights; ``cw``: (K, M) SWRR
    current-weight state. Returns ``(choice (K,) int64, new_cw (K, M),
    valid (K,) bool)``; ``valid`` is False for an all-zero weight row.
    Exact ties go to the lowest index, as ``jnp.argmax`` breaks them
    (``torch.argmax`` documents the first maximal index as well).
    """
    total = _row_sum(weights)   # left to right, as the fused round sums
    valid = total[..., 0] > 0
    cw = cw + weights
    choice = torch.argmax(cw, dim=-1)
    onehot = torch.nn.functional.one_hot(choice, weights.shape[-1]).to(cw.dtype)
    cw = cw - onehot * total
    return choice.to(torch.int32), cw, valid
