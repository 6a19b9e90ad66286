"""Player sharding: ``run_sim_players`` on gloo ranks against the JAX
package's unsharded ``run_sim_stream``, live, on the CPU.

The bandit state factorizes over players; the one coupling across them
is the shared (M,) queues, which every sharded round keeps equal with
one all-reduce of its arrivals. Every draw is keyed by global player id
and the stagger clocks by player block, so a shard draws and maintains
what the whole run does. So each count field of the accumulator (QoS
and request counts, routing and latency histograms, event windows,
attempts, timeouts, drops, open breakers) and each per-player float
(regret, variation budget, the last true ``mu``) equals the reference's
exactly, the request series too; the regret series, a float sum over
the shards, holds ``rtol=1e-4``.

One 4-rank ``launch.mesh.spawn`` a file runs its cases, each on a 2 x 2
(``data``, ``players``) mesh (2-way sharding, each data row the same
run) or a 4-way players mesh, in turn: here ``surge`` and
``rolling_restart`` under ``qedgeproxy``, ``proxy_mity(alpha=0.9)`` and
``dec_sarsa``; ``tests/test_torch_sharded_lifecycle.py`` the request
lifecycle, control, the recorder and tenants. In process: a 1-rank
mesh is the plain program bit for bit, and the reference's errors. One
test holds a 2-rank run against the reference's own ``run_sim_players``
on a 2-way mesh (``conftest.run_sub``).
"""
import functools

import jax
import numpy as np
import pytest
import torch

from conftest import run_sub
from repro.continuum import control as jctl
from repro.continuum import library as jlib
from repro.continuum import scenarios as jscn
from repro.continuum import simulator as js
from repro.continuum import tenancy as jten
from repro.continuum import topology as jtopo
from repro.obs import recorder as jrec
from repro_torch import convert
from repro_torch.continuum import control as tctl
from repro_torch.continuum import simulator as ts
from repro_torch.continuum import tenancy as tten
from repro_torch.launch.mesh import make_continuum_mesh, make_grid_mesh, spawn
from repro_torch.obs import recorder as trec

K, WARM, HORIZON = 16, 10, 3.0
RES = dict(attempt_timeout=0.055, max_retries=2, retry_backoff=0.002,
           breaker_threshold=4, breaker_cooldown=1.0)
CTL = dict(managed=2, warmup=0.3, up_queue=1.5, down_queue=0.2, hold=0.2,
           action_cooldown=1.0, batch=2, admit=True, target_queue=3.0,
           admit_floor=0.3, regions=2, mig_threshold=2.0)
STRATEGIES = {"qedgeproxy": {}, "proxy_mity": dict(alpha=0.9),
              "dec_sarsa": {}}


def _case(scenario, strategy, M=4, knobs=None, kind=None):
    return dict(scenario=scenario, strategy=strategy, M=M,
                knobs=knobs or {}, kind=kind)


CASES = {
    **{f"{scn}-{st}": _case(scn, st) for scn in ("surge", "rolling_restart")
       for st in STRATEGIES},
    **{f"resilient-{st}": _case("hetero_slowdown", st, knobs=RES,
                                kind="resilient") for st in STRATEGIES},
    "control-qedgeproxy": _case("metastable_overload", "qedgeproxy", M=6,
                                knobs=dict(service_time=0.0275, **RES),
                                kind="control"),
    "recorder-qedgeproxy": _case("retry_storm", "qedgeproxy", M=6,
                                 knobs=dict(tau=0.150, service_time=0.0275,
                                            **RES), kind="recorder"),
    **{f"tenants-{st}": _case("mt_tenant_surge", st, M=6, kind="tenants")
       for st in ("qedgeproxy", "dec_sarsa")},
}
# the players axis of each case's mesh: 2 (a 2 x 2 mesh) or 4, in turn
PLAYERS = {name: (2, 4)[i % 2] for i, name in enumerate(CASES)}
HERE = [n for n in CASES if CASES[n]["kind"] is None]


@functools.cache
def inputs(name):
    """``(jax args, port args)``: each ``(strategy, rtt, cfg, key,
    drivers, kw)`` of case ``name``, the port's converted from the
    reference's."""
    c = CASES[name]
    M, kw = c["M"], STRATEGIES[c["strategy"]]
    jknobs, tknobs = dict(c["knobs"]), dict(c["knobs"])
    if c["kind"] == "control":
        jknobs["control"] = jctl.ControlConfig(**CTL)
        tknobs["control"] = tctl.ControlConfig(**CTL)
    if c["kind"] == "recorder":
        jknobs["recorder"] = jrec.RecorderConfig(capacity=65536)
        tknobs["recorder"] = trec.RecorderConfig(capacity=65536)
    if c["kind"] == "tenants":
        jknobs["tenancy"] = jten.TenancyConfig(taus=(0.080, 0.150),
                                               interference=0.3)
        tknobs["tenancy"] = tten.TenancyConfig(taus=(0.080, 0.150),
                                               interference=0.3)
    jcfg = js.SimConfig(horizon=HORIZON, **jknobs)
    tcfg = ts.SimConfig(horizon=HORIZON, **tknobs)
    rtt = jtopo.make_topology(jax.random.PRNGKey(0), K, M).lb_instance_rtt()
    key = jax.random.PRNGKey(7)
    if c["kind"] == "tenants":
        lib = jlib.get_tenant_library(jcfg.horizon, K, M, n_tenants=2)
        drv = jscn.compile_tenant_scenario(lib[c["scenario"]], jcfg,
                                           jax.random.PRNGKey(3))
    elif c["kind"] == "control":
        scn = jscn.with_standby(
            jlib.get_library(jcfg.horizon, K, M - 2)[c["scenario"]], 2)
        drv = jscn.compile_scenario(scn, jcfg, jax.random.PRNGKey(3))
    else:
        drv = jscn.compile_scenario(
            jlib.get_library(jcfg.horizon, K, M)[c["scenario"]], jcfg,
            jax.random.PRNGKey(3))
    tdrv = convert.drivers_to_torch(jax.tree.map(np.asarray, drv), "cpu")
    return ((c["strategy"], rtt, jcfg, key, drv, kw),
            (c["strategy"], np.asarray(rtt), tcfg,
             convert.key_to_torch(np.asarray(key), "cpu"), tdrv, kw))


@functools.cache
def reference(name):
    strategy, rtt, cfg, key, drv, kw = inputs(name)[0]
    return js.run_sim_stream(strategy, rtt, cfg, key, drivers=drv,
                             warmup_steps=WARM, **kw)


def call_all(calls) -> list:
    """``[fn(*args, **kwargs) for fn, args, kwargs in calls]``: several
    runs in one ``spawn``, the ranks making each call together."""
    return [fn(*args, **kwargs) for fn, args, kwargs in calls]


def sharded_runs(names) -> dict:
    """Each case of ``names`` on its mesh, from one spawn of 4 ranks:
    ``{name: StreamOutputs}``."""
    calls = []
    for name in names:
        strategy, rtt, cfg, key, drv, kw = inputs(name)[1]
        calls.append((ts.run_sim_players, (strategy, rtt, cfg, key),
                      dict(drivers=drv, warmup_steps=WARM, device="cpu",
                           mesh=make_continuum_mesh(players=PLAYERS[name],
                                                    devices=4), **kw)))
    return dict(zip(names, spawn(call_all, 4, calls, threads=1)))


@pytest.fixture(scope="module")
def sharded():
    return sharded_runs(HERE)


def assert_matches(want, got, label):
    """Every accumulator field exact, the series exact but the regret
    (``rtol=1e-4``)."""
    accs = want.acc if isinstance(want.acc, tuple) and not hasattr(
        want.acc, "_fields") else (want.acc,)
    gots = got.acc if len(accs) > 1 else (got.acc,)
    for a_acc, g_acc in zip(accs, gots):
        for f in a_acc._fields:
            a, b = np.asarray(getattr(a_acc, f)), getattr(g_acc, f).numpy()
            assert a.shape == b.shape, (label, f)
            np.testing.assert_array_equal(b, a, err_msg=f"{label} {f}")
    for f in want.series._fields:
        a, b = np.asarray(getattr(want.series, f)), getattr(got.series,
                                                            f).numpy()
        if f == "regret":
            np.testing.assert_allclose(b, a, rtol=1e-4,
                                       err_msg=f"{label} series.{f}")
        else:
            np.testing.assert_array_equal(b, a,
                                          err_msg=f"{label} series.{f}")


def check_case(sharded, name):
    """Case ``name``'s sharded run against the reference's unsharded
    one, with what its kind adds."""
    want, got = reference(name), sharded[name]
    kind = CASES[name]["kind"]
    if kind == "resilient":
        assert float(np.asarray(want.acc.timeout_k).sum()) > 0
    if kind == "control":
        assert float(np.asarray(want.ctrl.shed_k).sum()) > 0
    assert_matches(want, got, name)
    if kind == "control":
        for f in want.ctrl._fields:
            np.testing.assert_array_equal(
                getattr(got.ctrl, f).numpy(),
                np.asarray(getattr(want.ctrl, f)), err_msg=f)
    if kind == "recorder":
        # one ring a shard; decoded, the events are the reference's
        assert tuple(got.rec.ptr.shape) == (PLAYERS[name],)
        evs = sorted((e.step, e.kind, e.entity, e.value)
                     for e in trec.recorder_events(got.rec))
        ref = sorted((e.step, e.kind, e.entity, e.value)
                     for e in jrec.recorder_events(want.rec))
        assert len(ref) > 10 and evs == ref


@pytest.mark.parametrize("name", HERE)
def test_sharded_players_match_the_reference(sharded, name):
    check_case(sharded, name)


def test_one_rank_mesh_is_the_plain_program():
    """A players axis of one (no process group: a mesh of one rank)
    runs the plain streaming program, bit for bit."""
    strategy, rtt, cfg, key, drv, kw = inputs("surge-qedgeproxy")[1]
    plain = ts.run_sim_stream(strategy, rtt, cfg, key, drivers=drv,
                              warmup_steps=WARM, device="cpu")
    mesh = make_continuum_mesh()
    assert mesh.shape == {"data": 1, "players": 1}
    for got in (ts.run_sim_players(strategy, rtt, cfg, key, drivers=drv,
                                   warmup_steps=WARM, mesh=mesh,
                                   device="cpu"),
                ts.run_sim_stream(strategy, rtt, cfg, key, drivers=drv,
                                  warmup_steps=WARM, mesh=mesh,
                                  device="cpu")):
        for part in ("acc", "series"):
            for f in getattr(plain, part)._fields:
                assert torch.equal(getattr(getattr(got, part), f),
                                   getattr(getattr(plain, part), f)), f
    run, m = ts.build_sim_players_fn(strategy, cfg, K, 4, mesh=mesh,
                                     warmup_steps=WARM)
    assert m is mesh and run(torch.tensor(rtt), drv, key).acc.succ_kc.shape \
        == (K, cfg.max_clients)


def test_the_references_errors():
    cfg = ts.SimConfig(horizon=1.0)
    with pytest.raises(ValueError, match="multiple"):
        ts.build_sim_parts("qedgeproxy", cfg, 10, 4, trace=False,
                           pshard=ts.PlayerSharding(None, 4))
    with pytest.raises(ValueError, match="streaming"):
        ts.build_sim_parts("qedgeproxy", cfg, K, 4, trace=True,
                           pshard=ts.PlayerSharding(None, 4))
    with pytest.raises(ValueError, match="multiple"):
        ts.build_sim_players_fn("qedgeproxy", cfg, 10, 4,
                                mesh=make_continuum_mesh(players=4,
                                                         devices=4))
    rtt = np.ones((K, 4), np.float32) * 0.01
    with pytest.raises(ValueError, match="chunk_steps"):
        ts.run_sim_stream("qedgeproxy", rtt, cfg, 7, chunk_steps=5,
                          mesh=make_continuum_mesh(players=2, devices=2),
                          device="cpu")
    with pytest.raises(ValueError, match="divide"):
        make_continuum_mesh(players=3, devices=4)
    assert make_continuum_mesh(players=1, devices=4).shape == {
        "data": 4, "players": 1}
    assert make_grid_mesh(devices=3).shape == {"data": 3, "players": 1}


def test_two_ranks_match_the_references_player_mesh():
    """The port's 2-rank run against the reference's own
    ``run_sim_players`` on a 2-way players mesh of host devices."""
    out = run_sub("""
        import jax, numpy as np, torch
        from repro.continuum import (SimConfig, compile_scenario,
                                     get_library, make_topology,
                                     run_sim_players)
        from repro.launch.mesh import make_continuum_mesh
        from repro_torch import convert
        from repro_torch.continuum import simulator as ts
        from repro_torch.launch import mesh as tmesh

        if __name__ == "__main__":
            K, M, WARM = 16, 4, 10
            cfg = SimConfig(horizon=3.0)
            rtt = make_topology(jax.random.PRNGKey(0), K, M).lb_instance_rtt()
            key = jax.random.PRNGKey(7)
            drv = compile_scenario(get_library(cfg.horizon, K, M)["surge"],
                                   cfg, jax.random.PRNGKey(3))
            want = run_sim_players(
                "qedgeproxy", rtt, cfg, key, drivers=drv, warmup_steps=WARM,
                mesh=make_continuum_mesh(players=2,
                                         devices=jax.devices()[:2]))
            got = tmesh.spawn(
                ts.run_sim_players, 2, "qedgeproxy", np.asarray(rtt),
                ts.SimConfig(horizon=3.0),
                convert.key_to_torch(np.asarray(key), "cpu"),
                drivers=convert.drivers_to_torch(
                    jax.tree.map(np.asarray, drv), "cpu"),
                warmup_steps=WARM, device="cpu", threads=1,
                mesh=tmesh.make_continuum_mesh(players=2, devices=2))
            for f in want.acc._fields:
                np.testing.assert_array_equal(
                    getattr(got.acc, f).numpy(),
                    np.asarray(getattr(want.acc, f)), err_msg=f)
            for f in ("succ", "issued", "attempts"):
                np.testing.assert_array_equal(
                    getattr(got.series, f).numpy(),
                    np.asarray(getattr(want.series, f)), err_msg=f)
            np.testing.assert_allclose(got.series.regret.numpy(),
                                       np.asarray(want.series.regret),
                                       rtol=1e-4)
            print("OK port ranks = reference mesh")
    """)
    assert "OK port ranks = reference mesh" in out
