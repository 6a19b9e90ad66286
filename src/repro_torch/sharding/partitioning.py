"""Logical-axis partitioning: one rule table maps logical axis names to
the mesh axes that split them.

Port of the continuum half of ``repro/sharding/partitioning.py``:

  players -> ("players",)   the K load balancers inside one simulation
  arms    -> ()             the M instances: never split
  grid    -> ("data",)      the independent lanes of an evaluation grid

The meshes are ``launch.mesh``'s 2-D (``data``, ``players``) grids of
ranks. Rules are a context-managed global; mesh axes a mesh lacks are
dropped, so the same logical names serve a grid mesh and a continuum
mesh.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence, Tuple

Rules = Dict[str, Tuple[str, ...]]

DEFAULT_RULES: Rules = {
    # player axis K inside one continuum simulation: bandit state
    # (rings, weights, KDE stats) splits over the mesh's players axis
    "players": ("players",),
    "arms": (),
    # evaluation-grid lanes: independent simulations over the data axis
    "grid": ("data",),
}

_rules: Rules = dict(DEFAULT_RULES)


def set_rules(rules: Rules) -> None:
    global _rules
    _rules = dict(DEFAULT_RULES)
    _rules.update(rules)


def get_rules() -> Rules:
    return dict(_rules)


@contextlib.contextmanager
def rule_overrides(**overrides: Tuple[str, ...]):
    global _rules
    old = dict(_rules)
    _rules.update(overrides)
    try:
        yield
    finally:
        _rules = old


def logical_to_spec(logical: Sequence[Optional[str]], mesh=None) -> tuple:
    """For each tensor dim, the mesh axis that splits it: ``None`` (not
    split), an axis name, or a tuple of names. Logical names resolve
    through the rule table; mesh axes absent from ``mesh`` are dropped,
    and a mesh axis splits at most one dim (the first to claim it)."""
    names = set(mesh.axis_names) if mesh is not None else set()
    spec = []
    used: set = set()
    for ax in logical:
        if ax is None:
            spec.append(None)
            continue
        kept = tuple(a for a in _rules.get(ax, ())
                     if a in names and a not in used)
        used.update(kept)
        spec.append(None if not kept else kept[0] if len(kept) == 1
                    else kept)
    return tuple(spec)
