"""Observability: the flight recorder, the metrics registry, trace
export, provenance, run directories and the ``python -m
repro_torch.obs`` CLI. Port of ``repro/obs``.

Only :mod:`repro_torch.obs.recorder` is imported eagerly: it needs
torch and numpy alone, and the simulator imports it at import time.
Everything else (registry, trace, provenance, runlog, report) imports
``repro_torch.continuum`` and is loaded on first use, so that
``repro_torch.continuum.simulator`` can import this package while
``repro_torch.continuum`` is itself being imported.
"""
from __future__ import annotations

import importlib

from repro_torch.obs import recorder
from repro_torch.obs.recorder import (  # noqa: F401  (re-exported surface)
    FLEET,
    KIND_BREAKER_RESET,
    KIND_BREAKER_TRIP,
    KIND_MARK,
    KIND_MIGRATE,
    KIND_QOS_SPIKE,
    KIND_RETRY_EXHAUSTED,
    KIND_SCALE_DOWN,
    KIND_SCALE_UP,
    KIND_SHED,
    KIND_NAMES,
    Event,
    RecorderConfig,
    RecorderState,
    events_appended,
    events_dropped,
    kind_name,
    recorder_enabled,
    recorder_events,
    recorder_init,
    record_step,
)

_LAZY = ("registry", "trace", "provenance", "runlog", "report")

__all__ = ["recorder", *_LAZY, "RecorderConfig", "RecorderState", "Event"]


def __getattr__(name: str):
    if name in _LAZY:
        mod = importlib.import_module(f"repro_torch.obs.{name}")
        globals()[name] = mod
        return mod
    raise AttributeError(
        f"module 'repro_torch.obs' has no attribute {name!r}")
