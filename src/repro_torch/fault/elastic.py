"""Elastic re-meshing: rebuild the mesh after rank loss or gain and
re-shard live state onto it.

Port of ``repro/fault/elastic.py``. Failure model: a pod (or a data-axis
slice) disappears. The runtime
 1. builds a new mesh from the surviving ranks (shrinking the data
    axis; the model axis must stay whole, since its blocks are not
    recoverable without a checkpoint),
 2. places parameters and optimizer state on the new mesh
    (``reshard_state``, or ``Checkpointer.restore`` with the new mesh's
    shardings),
 3. tells the router (paper Alg 4) so traffic stops flowing to the dead
    replicas at once (``serving.QEdgeRouter.mesh_resized`` feeds
    ``surviving_replicas`` into the router's active mask), and
 4. resumes; when capacity returns, Alg 3 ramps it back gradually.

A mesh here is a grid of ranks of one process group (``launch/mesh.py``),
so the survivors of a shrink run in a new group of their own: the
shrunk mesh's ranks are the first of the old, numbered as the new
group numbers them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.launch.mesh import Mesh, _ranks
from repro_torch.sharding.collectives import gather_whole
from repro_torch.sharding.partitioning import (is_axes_leaf, place,
                                               tree_shardings)


def build_mesh(devices, model_axis: int,
               pod_axis: Optional[int] = None) -> Mesh:
    """Arrange the surviving ranks (a count or a sequence of ranks) into
    (pod?, data, model)."""
    devs = np.asarray(_ranks(devices))
    n = devs.size
    if n % model_axis:
        raise ValueError(f"{n} devices not divisible by model={model_axis}")
    rows = n // model_axis
    if pod_axis:
        if rows % pod_axis:
            raise ValueError(
                f"data rows {rows} not divisible by pod={pod_axis}")
        return Mesh(devs.reshape(pod_axis, rows // pod_axis, model_axis),
                    ("pod", "data", "model"))
    return Mesh(devs.reshape(rows, model_axis), ("data", "model"))


def shrink_mesh(mesh: Mesh, lost_data_rows: int) -> Mesh:
    """Drop the last ``lost_data_rows`` rows of the data axis."""
    data_idx = mesh.axis_names.index("data")
    keep = mesh.ranks.shape[data_idx] - lost_data_rows
    if keep < 1:
        raise ValueError("cannot shrink data axis below 1")
    sl = [slice(None)] * mesh.ranks.ndim
    sl[data_idx] = slice(0, keep)
    return Mesh(mesh.ranks[tuple(sl)], mesh.axis_names)


def reshard_state(state, axes_tree, new_mesh: Mesh):
    """Every tensor of ``state`` placed on ``new_mesh`` per its logical
    axes in ``axes_tree`` (the same structure: params, optimizer state).
    A leaf placed on another mesh is gathered there first, which every
    rank of that mesh calls; a whole leaf (from a checkpoint or the
    host) is placed as it is."""
    shardings = tree_shardings(axes_tree, new_mesh)

    def move(x, axes, sh):
        if is_axes_leaf(axes):
            return place(gather_whole(x), sh)
        if isinstance(axes, dict):
            return {k: move(x[k], axes[k], sh[k]) for k in axes}
        vals = [move(a, b, c) for a, b, c in zip(x, axes, sh)]
        return type(x)(*vals) if hasattr(x, "_fields") else type(x)(vals)

    return move(state, axes_tree, shardings)


def surviving_replicas(old_rows: int, new_rows: int) -> np.ndarray:
    """Replica liveness vector for the router after a shrink (Alg 4)."""
    alive = np.zeros((old_rows,), bool)
    alive[:new_rows] = True
    return alive
