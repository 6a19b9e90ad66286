"""Elastic re-meshing and the restart from a checkpoint onto a shrunk
mesh, the port's counterparts of ``tests/test_elastic.py`` and
``tests/test_serving.py::test_router_masks_dead_replicas_on_mesh_shrink``.

The restart (``torch_mesh_ranks.elastic``): 4 gloo CPU ranks
(``build_mesh(4, model_axis=2)``, 2 x 2) train the reduced qwen3-4b in
float32 for 3 steps and save; the last data row is lost
(``shrink_mesh``), and the 2 survivors leave the group, form one of
their own, restore onto the 1 x 2 mesh (``restore(..., shardings=)``)
and take 2 steps, which must be finite and equal one rank resumed from
the same checkpoint, and that one an uninterrupted run of one rank (the
lost pair runs both meanwhile; ``rtol=1e-4, atol=1e-5``, the
reference's SPMD tolerance); the checkpoint holds the ranks' blocks gathered whole, and
``reshard_state`` of the whole restored state places the same blocks.
A save on a (pod 2, data 2, model 2) mesh of 8 ranks, with no collective
made before it, gathers leaves split over data and model together, and
the ranks make the groups of a later collective across the pods alike;
in the same spawn ``reduce_scatter`` over one axis and over two (in and
against the mesh's order) gives each rank its block of the all-reduce.
"""
import dataclasses

import numpy as np
import pytest

from repro.core.bandit import BanditParams as JBanditParams
from repro.fault import surviving_replicas as jax_surviving
from repro.serving.router import QEdgeRouter as JRouter
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.bandit import BanditParams
from repro_torch.fault import build_mesh, shrink_mesh, surviving_replicas
from repro_torch.launch.mesh import _free_port, spawn
from repro_torch.models import build_model
from repro_torch.serving.router import QEdgeRouter
from torch_mesh_ranks import (SCATTER_CASES, call_all, elastic,
                              reduce_scatter_cases, save_on_pod_mesh)

SHAPE = ShapeConfig("t", "train", 32, 8)


def test_build_and_shrink_mesh_shapes():
    mesh = build_mesh(8, model_axis=2)
    assert mesh.shape == {"data": 4, "model": 2}
    small = shrink_mesh(mesh, 1)
    assert small.shape == {"data": 3, "model": 2}
    assert small.ranks.tolist() == [[0, 1], [2, 3], [4, 5]]
    assert surviving_replicas(4, 3).tolist() == [True, True, True, False]
    np.testing.assert_array_equal(surviving_replicas(4, 3),
                                  jax_surviving(4, 3))
    mesh3 = build_mesh(range(8), model_axis=2, pod_axis=2)
    assert mesh3.shape == {"pod": 2, "data": 2, "model": 2}
    assert shrink_mesh(mesh3, 1).shape == {"pod": 2, "data": 1, "model": 2}


def test_elastic_restart_from_checkpoint(tmp_path):
    cfg = dataclasses.replace(get_config("qwen3-4b", reduced=True),
                              dtype="float32")
    weights = build_model(cfg, "cpu").state_dict()
    got, _, alone, whole = spawn(elastic, 4, cfg, weights, SHAPE,
                                 str(tmp_path), (_free_port(), _free_port()),
                                 threads=1, every_rank=True)
    after = got["after"]
    one = alone["alone"]["losses"]
    uninterrupted = whole["uninterrupted"]["losses"][3:]
    assert np.isfinite(got["before"]["losses"]).all()
    assert got["before"]["saved_equal"]
    assert np.isfinite(after["losses"]).all() and after["reshard_equal"]
    np.testing.assert_allclose(after["losses"], one, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(one, uninterrupted, rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def pod_ranks(tmp_path_factory) -> list:
    """Every rank's results of one 8-rank spawn on the (2, 2, 2) mesh."""
    ckdir = str(tmp_path_factory.mktemp("pod"))
    return spawn(call_all, 8, [(save_on_pod_mesh, (ckdir,), {}),
                               (reduce_scatter_cases, (), {})],
                 threads=1, every_rank=True, timeout=60.0)


def test_save_on_a_pod_mesh_before_any_collective(pod_ranks):
    """The blocks gathered onto the writer along two axes at once, whose
    groups every rank (the other pod's too) must make together."""
    assert pod_ranks[0][0] == {"saved_equal": True, "batch_sum": 4.0}


@pytest.mark.parametrize("case", range(len(SCATTER_CASES)))
def test_reduce_scatter_is_the_all_reduce_block(pod_ranks, case):
    assert all(rank[1][case] for rank in pod_ranks), SCATTER_CASES[case]


def test_router_masks_dead_replicas_on_mesh_shrink():
    router = QEdgeRouter(3, 4, BanditParams(), seed=2, device="cpu")
    ref = JRouter(3, 4, JBanditParams(), seed=2)
    for rows in (2, 4):             # lose the last two groups; they return
        router.mesh_resized(rows)
        ref.mesh_resized(rows)
        np.testing.assert_array_equal(router.state.active.numpy(),
                                      np.asarray(ref.state.active))
        np.testing.assert_allclose(router.weights, ref.weights, atol=1e-6)
    assert np.abs(router.weights[:, 2:]).max() == 0.0     # Alg 3 ramp
    router.mesh_resized(1)
    for _ in range(20):             # no microbatch routes to a dead row
        assert router.route().max() < 1
    assert [e[1] for e in router.events] == [
        "mesh_resized", "replicas_changed"] * 3
