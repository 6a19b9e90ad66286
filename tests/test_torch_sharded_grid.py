"""The sharded evaluation grid: ``run_sim_grid(mesh=)`` on gloo ranks
against the JAX package's single-device ``run_sim_grid``, live, on the
CPU.

Grid lanes are independent simulations, so spreading them over the
``data`` axis changes no result: on a 1-D grid mesh of 4 ranks every
accumulator field and series value equals the reference's exactly. On
a 2 x 2 (``data``, ``players``) mesh the lanes spread over ``data`` and
every lane's players over ``players``: every accumulator field and the
request series exact, the regret series (a float sum over the player
shards) to ``rtol=1e-4``. S = 3 lanes never fill either data axis, so
the pad path runs (copies of the last lane, sliced off). One 4-rank
``launch.mesh.spawn`` runs both meshes for ``qedgeproxy`` and
``dec_sarsa`` on three library scenarios as lanes, and the 2 x 2 mesh
once more with the ``players`` rule overridden to split nothing (each
lane's players whole on every rank of a data row: the regret exact
too). In process: a mesh of one rank runs the plain lanes bit for bit;
the partitioning rules.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.continuum import library as jlib
from repro.continuum import scenarios as jscn
from repro.continuum import simulator as js
from repro.continuum import topology as jtopo
from repro.sharding import partitioning as jpart
from repro_torch import convert
from repro_torch import sharding as tshard
from repro_torch.continuum import simulator as ts
from repro_torch.launch.mesh import make_continuum_mesh, make_grid_mesh, spawn
from test_torch_sharded_players import call_all

K, M, S, WARM = 16, 4, 3, 10
HORIZON = 3.0
SCENARIOS = ("surge", "cascade_failure", "partition_heal")
STRATEGIES = ("qedgeproxy", "dec_sarsa")
MESHES = {"grid": dict(players=1), "grid_x_players": dict(players=2)}


@functools.cache
def inputs():
    """The reference's lanes (topologies 1-3, compile keys 500 + i, run
    keys 20 + i) and the port's conversion of them."""
    cfg = js.SimConfig(horizon=HORIZON)
    lib = jlib.get_library(cfg.horizon, K, M)
    drv = jscn.stack_drivers([jscn.compile_scenario(
        lib[n], cfg, jax.random.PRNGKey(500 + i))
        for i, n in enumerate(SCENARIOS)])
    rtts = jnp.stack([jtopo.make_topology(jax.random.PRNGKey(s), K, M)
                      .lb_instance_rtt() for s in (1, 2, 3)])
    keys = jnp.stack([jax.random.PRNGKey(20 + s) for s in range(S)])
    port = (np.asarray(rtts), ts.SimConfig(horizon=HORIZON),
            convert.key_to_torch(np.asarray(keys), "cpu"),
            convert.drivers_to_torch(jax.tree.map(np.asarray, drv), "cpu"))
    return (rtts, cfg, keys, drv), port


@functools.cache
def reference(strategy):
    rtts, cfg, keys, drv = inputs()[0]
    return js.run_sim_grid(strategy, rtts, cfg, keys, drivers=drv,
                           warmup_steps=WARM)


def without_player_split(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with the ``players`` rule splitting
    nothing."""
    with tshard.rule_overrides(players=()):
        return fn(*args, **kwargs)


@pytest.fixture(scope="module")
def sharded():
    """``{(mesh, strategy): StreamOutputs}`` from one spawn of 4 ranks."""
    rtts, cfg, keys, drv = inputs()[1]
    labels, calls = [], []
    kw = dict(drivers=drv, warmup_steps=WARM, device="cpu")
    for mesh, shape in MESHES.items():
        for strategy in STRATEGIES:
            labels.append((mesh, strategy))
            calls.append((ts.run_sim_grid, (strategy, rtts, cfg, keys),
                          dict(mesh=make_continuum_mesh(devices=4, **shape),
                               **kw)))
    labels.append(("rules_off", "qedgeproxy"))
    calls.append((without_player_split,
                  (ts.run_sim_grid, "qedgeproxy", rtts, cfg, keys),
                  dict(mesh=make_continuum_mesh(devices=4, players=2), **kw)))
    return dict(zip(labels, spawn(call_all, 4, calls, threads=1)))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_sharded_grid_matches_the_reference(sharded, mesh, strategy):
    want, got = reference(strategy), sharded[(mesh, strategy)]
    for f in want.acc._fields:
        a, b = np.asarray(getattr(want.acc, f)), getattr(got.acc, f).numpy()
        assert a.shape == b.shape and a.shape[0] == S, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    for f in want.series._fields:
        a, b = np.asarray(getattr(want.series, f)), getattr(got.series,
                                                            f).numpy()
        if f == "regret" and mesh == "grid_x_players":
            np.testing.assert_allclose(b, a, rtol=1e-4, err_msg=f)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)


def test_the_rules_decide_the_split(sharded):
    """With the ``players`` rule splitting nothing, the 2 x 2 mesh runs
    each lane's players whole: every field exact, the regret too; and a
    K that the players axis does not divide is no longer refused."""
    want, got = reference("qedgeproxy"), sharded[("rules_off", "qedgeproxy")]
    for part in ("acc", "series"):
        for f in getattr(want, part)._fields:
            np.testing.assert_array_equal(
                getattr(getattr(got, part), f).numpy(),
                np.asarray(getattr(getattr(want, part), f)), err_msg=f)
    mesh = make_continuum_mesh(players=2, devices=4)
    cfg = inputs()[1][1]
    with pytest.raises(ValueError, match="multiple of the 2-way"):
        ts.build_sim_grid_fn("qedgeproxy", cfg, K + 1, M, mesh=mesh)
    with tshard.rule_overrides(players=()):
        ts.build_sim_grid_fn("qedgeproxy", cfg, K + 1, M, mesh=mesh)
        ts.build_sim_players_fn("qedgeproxy", cfg, K + 1, M, mesh=mesh)


def test_one_rank_grid_mesh_is_the_plain_lanes():
    rtts, cfg, keys, drv = inputs()[1]
    plain = ts.run_sim_grid("qedgeproxy", rtts, cfg, keys, drivers=drv,
                            warmup_steps=WARM, device="cpu")
    run_grid, mesh = ts.build_sim_grid_fn("qedgeproxy", cfg, K, M,
                                          warmup_steps=WARM)
    assert mesh.size() == 1
    got = run_grid(torch.tensor(rtts), drv, keys)
    for part in ("acc", "series"):
        for f in getattr(plain, part)._fields:
            assert torch.equal(getattr(getattr(got, part), f),
                               getattr(getattr(plain, part), f)), f


def test_the_continuum_rules_match_the_reference():
    """The continuum rules, and the spec each logical layout resolves to
    on each mesh, equal the reference's."""
    for name in ("players", "arms", "grid"):
        assert tshard.DEFAULT_RULES[name] == jpart.DEFAULT_RULES[name]
    for mesh in (make_grid_mesh(devices=4),
                 make_continuum_mesh(players=2, devices=4),
                 make_continuum_mesh(devices=4)):
        jmesh = jax.sharding.AbstractMesh(
            tuple(mesh.shape.values()), tuple(mesh.shape))
        for logical in (("players", None), ("grid", "players", None),
                        ("grid",), (None, "arms"), ("players", "players")):
            want = tuple(jpart.logical_to_spec(logical, jmesh))
            assert tshard.logical_to_spec(logical, mesh) == want, logical
    with tshard.rule_overrides(arms=("players",)):
        assert tshard.logical_to_spec(("arms",), make_continuum_mesh(
            devices=2)) == ("players",)
    assert tshard.get_rules() == tshard.DEFAULT_RULES
