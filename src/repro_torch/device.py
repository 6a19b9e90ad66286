"""Device selection for the port: the card by default, the CPU on request.

Every entry point of ``repro_torch`` takes a ``device`` argument and
resolves it here. ``None`` means ``cuda``; asking for ``cuda`` where no
card is visible raises instead of running on the CPU, so a run never
moves to the host without the caller saying so (``device="cpu"``, as
the tests do).
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``torch.device`` for ``device`` (default ``cuda``); raises when a
    CUDA device is asked for and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the host")
    return dev
