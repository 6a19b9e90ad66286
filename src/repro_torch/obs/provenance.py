"""Provenance stamps for result artifacts. Port of
``repro/obs/provenance.py``.

A payload gains a ``provenance`` key recording what produced it: the
artifact schema version, the git sha, the torch and CUDA versions, the
backend (``cuda`` or ``cpu``), the device's name and count, and a
content hash of the run's config. The stamp is additive: keys are
merged into the payload, never wrapped around it.

:func:`config_hash` is the reference's algorithm, so equal configs of
the two packages hash equal. The block's other fields are the port's
own (torch and CUDA in place of jax), and :func:`validate_artifact`
checks the port's schema.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import subprocess

import torch

ARTIFACT_SCHEMA_VERSION = 1

_FIELDS = {
    "schema_version": int,
    "git_sha": str,
    "torch_version": str,
    "cuda_version": str,
    "backend": str,
    "device_name": str,
    "device_count": int,
    "config_hash": str,
}


def git_sha(repo_dir: str | None = None) -> str:
    """HEAD sha of the repo holding this file (or ``repo_dir``);
    "unknown" outside a git checkout."""
    if repo_dir is None:
        repo_dir = os.path.dirname(os.path.abspath(__file__))
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=repo_dir,
            capture_output=True, text=True, timeout=10,
        ).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _canonical(obj):
    """A deterministically serialisable view of a config: dataclasses
    and NamedTuples as dicts, everything else as its repr."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _canonical(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if hasattr(obj, "_asdict"):                       # NamedTuple
        return {k: _canonical(v) for k, v in obj._asdict().items()}
    if isinstance(obj, dict):
        return {str(k): _canonical(v) for k, v in sorted(obj.items())}
    if isinstance(obj, (list, tuple)):
        return [_canonical(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return repr(obj)


def config_hash(config) -> str:
    """Stable short hash of a config object (``SimConfig``,
    ``ControlConfig``, a plain dict, ...)."""
    blob = json.dumps(_canonical(config), sort_keys=True,
                      separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def provenance(config=None, extra: dict | None = None,
               device=None) -> dict:
    """The provenance block of this process. ``device`` is the run's
    device (default: ``cuda`` when a card is visible, else the CPU)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    block = {
        "schema_version": ARTIFACT_SCHEMA_VERSION,
        "git_sha": git_sha(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda or "none",
        "backend": dev.type,
        "device_name": (torch.cuda.get_device_name(dev) if on_card
                        else "cpu"),
        "device_count": torch.cuda.device_count() if on_card else 1,
        "config_hash": config_hash(config) if config is not None else "",
    }
    if extra:
        block.update(extra)
    return block


def stamp(payload: dict, config=None, extra: dict | None = None,
          device=None) -> dict:
    """Merge the provenance block into an artifact payload, in place:
    readers of the payload's other keys see no change of shape."""
    payload["provenance"] = provenance(config, extra, device)
    return payload


def validate_artifact(path_or_doc) -> list[str]:
    """Read one artifact back and check its provenance block; a list of
    problems (empty: valid)."""
    problems = []
    if isinstance(path_or_doc, (str, os.PathLike)):
        try:
            with open(path_or_doc) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            return [f"unreadable: {e}"]
    else:
        doc = path_or_doc
    if not isinstance(doc, dict):
        return ["artifact is not a JSON object"]
    prov = doc.get("provenance")
    if not isinstance(prov, dict):
        return ["missing provenance block"]
    for k, typ in _FIELDS.items():
        if k not in prov:
            problems.append(f"provenance missing {k!r}")
        elif not isinstance(prov[k], typ):
            problems.append(
                f"provenance {k!r} is {type(prov[k]).__name__}, "
                f"want {typ.__name__}")
    sv = prov.get("schema_version")
    if isinstance(sv, int) and sv > ARTIFACT_SCHEMA_VERSION:
        problems.append(f"schema_version {sv} is from the future")
    return problems


def validate_all(results_dir: str) -> dict:
    """{filename: [problems]} over every ``*.json`` of a directory."""
    out = {}
    for name in sorted(os.listdir(results_dir)):
        if name.endswith(".json"):
            out[name] = validate_artifact(os.path.join(results_dir, name))
    return out
