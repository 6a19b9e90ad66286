"""The port's closed-loop control plane against the JAX package's, live
JAX calls on the CPU.

* ``control_actuate`` / ``control_observe`` step by step on seeded
  queue, liveness and demand traces, for every ``CONTROL_POLICIES``
  entry with a controller: the effective drivers, the shed counts and
  every carry field exact at every step; a lane-batched carry computes
  each lane as it does alone.
* Whole runs (``qedgeproxy``, ``proxy_mity``, ``dec_sarsa``) with a
  policy exercising the autoscaler, admission and migration over the
  bounded request lifecycle: the control counters and every count of
  the accumulator and the series exact, the float sums of the true
  ``mu`` within ``rtol=1e-6`` plus ``M * eps32`` a term.
* The reference's carry at step s, injected through ``convert``, stepped
  on in both packages: the same carry after n more steps.
* Control on the fused round equals control on the round scan; a
  neutral ``ControlConfig`` is ``control=None``.
* ``control_stats_stream`` and ``per_tenant_qos_spread`` equal the
  reference's readouts on the same accumulator and counters.
"""
import dataclasses
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import scenario_suite as bsuite
from repro.continuum import control as jc
from repro.continuum import library as jlib
from repro.continuum import scenarios as jscn
from repro.continuum import simulator as js
from repro.continuum import topology as jtopo
from repro_torch import convert
from repro_torch.bench import scenarios as tsuite
from repro_torch.continuum import control as tc
from repro_torch.continuum import metrics as tm
from repro_torch.continuum import scenarios as tscn
from repro_torch.continuum import simulator as ts

EPS32 = float(np.finfo(np.float32).eps)
K, M, STANDBY, C, R = 12, 4, 2, 4, 16
MT = M + STANDBY
HORIZON, WARM = 6.0, 10                 # 60 steps
SMALL = dict(max_clients=C, ring=R, horizon=HORIZON)
FLOATS = ("regret_k", "vb_k", "prev_mu")
# every mechanism at this size: 2 standby instances, shedding, 2 regions
CTL = dict(managed=STANDBY, warmup=0.5, up_queue=2.0, down_queue=0.3,
           hold=0.3, action_cooldown=1.0, batch=1, admit=True,
           target_queue=3.0, admit_floor=0.3, regions=2, mig_threshold=2.0,
           mig_step=0.1)
RES = bsuite.CONTROL_RES
POLICIES = [(label, c) for label, c in bsuite.CONTROL_POLICIES
            if c is not None]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors: one intra-op thread is faster than many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(x) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(x), copy=True))


def port_config(c) -> tc.ControlConfig:
    return tc.ControlConfig(**dataclasses.asdict(c))


def assert_same_carry(want, got, what):
    for part in ("state", "counters"):
        w, g = getattr(want, part), getattr(got, part)
        for f in w._fields:
            np.testing.assert_array_equal(getattr(g, f).numpy(),
                                          np.asarray(getattr(w, f)),
                                          err_msg=f"{what}: {part}.{f}")


# ---------------------------------------------------------------------------
# The controller, step by step.
# ---------------------------------------------------------------------------

def traces(seed, steps=60, KK=K, MM=8):
    """Seeded step-start observations: backlog waves that cross every
    threshold, a scenario kill of one standby and of a base instance,
    client demand, a service row."""
    rng = np.random.default_rng(seed)
    wave = 4.0 + 3.5 * np.sin(np.arange(steps) / 6.0)
    q = np.maximum(wave[:, None] * rng.uniform(0.2, 1.8, (steps, MM)), 0.0)
    q = q.astype(np.float32)
    act = np.ones((steps, MM), bool)
    act[20:35, -1] = False
    act[40:, 1] = False
    nc = rng.integers(0, C + 1, (steps, KK)).astype(np.int32)
    s_m = rng.uniform(0.004, 0.007, MM).astype(np.float32)
    obs = np.stack([rng.integers(0, 40, steps), rng.integers(30, 48, steps),
                    rng.integers(0, 10, steps), rng.integers(40, 60, steps)],
                   -1).astype(np.float32)
    obs[:, 0] = np.minimum(obs[:, 0], obs[:, 1])
    return q, act, nc, s_m, obs


@pytest.mark.parametrize("label,ccfg", POLICIES + [("all", jc.ControlConfig(
    **CTL, qos_floor=0.9, timeout_ceiling=0.1))],
    ids=[p for p, _ in POLICIES] + ["all"])
def test_controller_steps_match_the_reference(label, ccfg):
    q, act, nc, s_m, obs = traces(len(label))
    MM = q.shape[1]
    tcfg = port_config(ccfg)
    want = jc.control_init(ccfg, K, MM)
    got = tc.control_init(tcfg, K, MM, device="cpu")
    assert_same_carry(want, got, "init")
    dt = 0.1
    for i in range(q.shape[0]):
        t = np.float32(i) * np.float32(dt)
        measf = 1.0 if i >= 10 else 0.0
        want, *w_out = jc.control_actuate(
            ccfg, dt, jnp.float32(t), want, jnp.asarray(q[i]),
            jnp.asarray(act[i]), jnp.asarray(nc[i]), jnp.asarray(s_m),
            jnp.float32(measf))
        got, *g_out = tc.control_actuate(tcfg, dt, float(t), got, T(q[i]),
                                         T(act[i]), T(nc[i]), T(s_m), measf)
        for a, b in zip(w_out, g_out):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=f"{label} step {i}")
        assert_same_carry(want, got, f"{label} step {i} actuate")
        want = jc.control_observe(ccfg, want, jnp.asarray(obs[i]), dt)
        got = tc.control_observe(tcfg, got, T(obs[i]), dt)
        assert_same_carry(want, got, f"{label} step {i} observe")
    if ccfg.managed and math.isfinite(ccfg.up_queue):
        assert float(want.counters.scale_up) > 0, label


def test_controller_lanes_compute_each_lane_alone():
    """Three controllers as the lanes of one carry: each lane's outputs
    and carry equal that controller run alone."""
    ccfg = tc.ControlConfig(**CTL)
    S, MM = 3, 8
    tr = [traces(10 + s, steps=30) for s in range(S)]
    lanes = tc.control_init(ccfg, S * K, MM, lanes=S, device="cpu")
    alone = [tc.control_init(ccfg, K, MM, device="cpu") for _ in range(S)]
    for i in range(30):
        t = float(np.float32(i) * np.float32(0.1))
        lanes, *out = tc.control_actuate(
            ccfg, 0.1, t, lanes, T(np.stack([x[0][i] for x in tr])),
            T(np.stack([x[1][i] for x in tr])),
            T(np.concatenate([x[2][i] for x in tr])),
            T(np.stack([x[3] for x in tr])), 1.0)
        lanes = tc.control_observe(ccfg, lanes,
                                   T(np.stack([x[4][i] for x in tr])), 0.1)
        for s in range(S):
            q, act, nc, s_m, obs = tr[s]
            alone[s], *one = tc.control_actuate(
                ccfg, 0.1, t, alone[s], T(q[i]), T(act[i]), T(nc[i]),
                T(s_m), 1.0)
            alone[s] = tc.control_observe(ccfg, alone[s], T(obs[i]), 0.1)
            rows = slice(s * K, (s + 1) * K)
            for a, b, per_player in zip(one, out, (False, True, False, True)):
                assert torch.equal(a, b[rows] if per_player else b[s]), (i, s)
            for part in ("state", "counters"):
                for f in getattr(lanes, part)._fields:
                    v = getattr(getattr(lanes, part), f)
                    mine = v[rows] if f in tc.PLAYER_FIELDS else v[s]
                    assert torch.equal(mine,
                                       getattr(getattr(alone[s], part), f)), \
                        (i, s, part, f)


# ---------------------------------------------------------------------------
# Whole runs against the reference.
# ---------------------------------------------------------------------------

def inputs(scenario="retry_storm", key=5):
    jcfg = js.SimConfig(**SMALL)
    sc = jscn.with_standby(jlib.get_library(HORIZON, K, M)[scenario], STANDBY)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jdrv = jscn.compile_scenario(sc, jcfg, jax.random.PRNGKey(700))
    rtt = jtopo.make_topology(jax.random.PRNGKey(1), K, MT).lb_instance_rtt()
    return jdrv, rtt, jax.random.PRNGKey(key)


def port_inputs(jdrv, rtt, key):
    return (np.asarray(rtt), convert.key_to_torch(np.asarray(key), "cpu"),
            convert.drivers_to_torch(jax.tree.map(np.asarray, jdrv), "cpu"))


def assert_run_matches(want, got):
    steps = int(HORIZON / 0.1)
    for f in want.acc._fields:
        a, b = np.asarray(getattr(want.acc, f)), getattr(got.acc, f).numpy()
        if f in FLOATS:
            np.testing.assert_allclose(b, a, rtol=1e-6,
                                       atol=steps * MT * EPS32, err_msg=f)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)
    for f in ("succ", "issued", "attempts"):
        np.testing.assert_array_equal(getattr(got.series, f).numpy(),
                                      np.asarray(getattr(want.series, f)),
                                      err_msg=f)
    np.testing.assert_allclose(got.series.regret.numpy(),
                               np.asarray(want.series.regret), rtol=1e-6,
                               atol=K * MT * EPS32)
    for f in want.ctrl._fields:
        np.testing.assert_array_equal(getattr(got.ctrl, f).numpy(),
                                      np.asarray(getattr(want.ctrl, f)),
                                      err_msg=f)


STRATEGIES = (("qedgeproxy", {}), ("proxy_mity", dict(alpha=0.9)),
              ("dec_sarsa", {}))


@pytest.mark.parametrize("name,kw", STRATEGIES,
                         ids=[s for s, _ in STRATEGIES])
def test_closed_loop_runs_match_the_reference(name, kw):
    jdrv, rtt, key = inputs()
    want = js.run_sim_stream(name, rtt, js.SimConfig(
        **SMALL, **RES, control=jc.ControlConfig(**CTL)), key, drivers=jdrv,
        warmup_steps=WARM, **kw)
    rtt_t, key_t, drv_t = port_inputs(jdrv, rtt, key)
    got = ts.run_sim_stream(name, rtt_t, ts.SimConfig(
        **SMALL, **RES, control=tc.ControlConfig(**CTL)), key_t,
        drivers=drv_t, warmup_steps=WARM, device="cpu", **kw)
    assert_run_matches(want, got)
    # the controller acted, and sheds are issued misses never served
    stats = tc.control_stats_stream(got.acc, got.ctrl)
    assert stats["scale_up"] > 0
    if name == "qedgeproxy":
        assert stats["migrations"] > 0
    assert stats["shed"] > 0 and got.acc.drop_k.sum() >= stats["shed"]
    assert float(got.acc.arrivals_m.sum()) < float(got.acc.att_k.sum()) + 1


def test_injected_carry_steps_as_the_reference():
    """The reference's carry after s steps (breaker and control slots
    included), converted, stepped n more steps by the port equals the
    reference's n more steps: every count, ring, pool, breaker and
    control field exact; the float estimates maintenance computes
    (``mu_hat``, which lands an ULP from XLA's, ROADMAP C, and the
    weights and SWRR credit made from it), the true-``mu`` sums and the
    control's float averages within a few float32 roundings."""
    jdrv, rtt, key = inputs()
    jcfg = js.SimConfig(**SMALL, **RES, control=jc.ControlConfig(**CTL))
    tcfg = ts.SimConfig(**SMALL, **RES, control=tc.ControlConfig(**CTL))
    s, n = 25, 20
    jinit, jchunk = js.build_sim_chunks("qedgeproxy", jcfg, K, MT,
                                        warmup_steps=WARM)
    jchunk = jax.jit(jchunk)
    carry, keys = jax.jit(jinit)(rtt, jdrv.active[0], key)
    carry, _ = jchunk(rtt, carry, jnp.arange(s),
                      jscn.slice_drivers(jdrv, 0, s), keys[:s])
    start = jax.tree.map(np.asarray, carry)
    want, want_ys = jchunk(rtt, carry, jnp.arange(s, s + n),
                           jscn.slice_drivers(jdrv, s, s + n), keys[s:s + n])
    rtt_t, key_t, drv_t = port_inputs(jdrv, rtt, key)
    _, tchunk = ts.build_sim_chunks("qedgeproxy", tcfg, K, MT,
                                    warmup_steps=WARM)
    got, got_ys = tchunk(torch.tensor(rtt_t), convert.carry_to_torch(
        start, "cpu"), range(s, s + n), tscn.slice_drivers(drv_t, s, s + n),
        convert.key_to_torch(np.asarray(keys[s:s + n]), "cpu"))
    want = jax.tree.map(np.asarray, want)
    want_flat = dict(zip(*_named(convert.carry_to_numpy(
        convert.carry_to_torch(want, "cpu")))))
    got_flat = dict(zip(*_named(convert.carry_to_numpy(got))))
    assert want_flat.keys() == got_flat.keys()
    for k, a in want_flat.items():
        b = got_flat[k]
        if k.split(".")[-1] in FLOATS + ("ema_qos", "ema_timeout", "mu_hat",
                                         "weights", "cw"):
            np.testing.assert_allclose(b, a, rtol=4 * EPS32,
                                       atol=n * MT * EPS32, err_msg=k)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)
    for f in ("succ", "issued", "attempts"):
        np.testing.assert_array_equal(getattr(got_ys, f).numpy(),
                                      np.asarray(getattr(want_ys, f)))
    # the controller acted inside the stepped window
    assert float(got[7].counters.scale_up) + float(
        got[7].counters.shed_k.sum()) > float(start[7].counters.scale_up) \
        + float(start[7].counters.shed_k.sum())


def _named(tree, prefix=""):
    """(names, leaves) of a numpy carry, NamedTuple fields by name."""
    names, leaves = [], []
    if tree is None:
        return names, leaves
    if isinstance(tree, tuple):
        fields = getattr(tree, "_fields", [str(i) for i in range(len(tree))])
        for f, v in zip(fields, tree):
            n, lv = _named(v, f"{prefix}{f}.")
            names += n
            leaves += lv
        return names, leaves
    return [prefix[:-1]], [np.asarray(tree)]


def test_fused_round_under_control_equals_the_round_scan():
    """Control only (no lifecycle): the round kernel's plain version takes
    the effective liveness, service row and admitted slots and equals
    the round scan, every field and counter bit for bit."""
    jdrv, rtt, key = inputs()
    rtt_t, key_t, drv_t = port_inputs(jdrv, rtt, key)
    outs = [ts.run_sim_stream("qedgeproxy", rtt_t, ts.SimConfig(
        **SMALL, fused_round=fused, control=tc.ControlConfig(**CTL)), key_t,
        drivers=drv_t, warmup_steps=WARM, device="cpu")
        for fused in (True, False)]
    for part in ("acc", "series", "ctrl"):
        for f in getattr(outs[0], part)._fields:
            assert torch.equal(getattr(getattr(outs[0], part), f),
                               getattr(getattr(outs[1], part), f)), (part, f)
    assert outs[0].ctrl.shed_k.sum() > 0 or outs[0].ctrl.scale_up > 0


def test_neutral_control_is_the_open_loop_run():
    assert not tc.ControlConfig().enabled
    assert tc.ControlConfig(managed=1).enabled
    assert tc.ControlConfig(admit=True).enabled
    assert tc.ControlConfig(regions=2).enabled
    assert not tc.ControlConfig(regions=1).enabled
    jdrv, rtt, key = inputs()
    rtt_t, key_t, drv_t = port_inputs(jdrv, rtt, key)
    outs = [ts.run_sim_stream("qedgeproxy", rtt_t, ts.SimConfig(
        **SMALL, **RES, control=c), key_t, drivers=drv_t, warmup_steps=WARM,
        device="cpu") for c in (None, tc.ControlConfig())]
    assert outs[0].ctrl is None and outs[1].ctrl is None
    for part in ("acc", "series"):
        for f in getattr(outs[0], part)._fields:
            assert torch.equal(getattr(getattr(outs[0], part), f),
                               getattr(getattr(outs[1], part), f)), (part, f)
    with pytest.raises(ValueError, match="streaming-only"):
        ts.run_sim("qedgeproxy", rtt_t, ts.SimConfig(
            **SMALL, control=tc.ControlConfig(**CTL)), key_t, device="cpu")


def test_readouts_match_the_reference():
    jdrv, rtt, key = inputs()
    want = js.run_sim_stream("qedgeproxy", rtt, js.SimConfig(
        **SMALL, **RES, control=jc.ControlConfig(**CTL)), key, drivers=jdrv,
        warmup_steps=WARM)
    want = jax.tree.map(np.asarray, want)
    acc = convert.accumulator_to_torch(want.acc, "cpu")
    ctrl = convert.control_to_torch(want.ctrl, "cpu")
    assert tc.control_stats_stream(acc, ctrl) == \
        jc.control_stats_stream(want.acc, want.ctrl)
    assert tc.per_tenant_qos_spread(acc) == jc.per_tenant_qos_spread(want.acc)
    empty = acc._replace(n_kc=torch.zeros_like(acc.n_kc))
    assert tc.per_tenant_qos_spread(empty) == \
        jc.per_tenant_qos_spread(want.acc._replace(
            n_kc=np.zeros_like(want.acc.n_kc)))
    assert math.isfinite(tc.control_stats_stream(acc, ctrl)["mean_admit_frac"])
    assert tsuite.CONTROL_STANDBY == bsuite.CONTROL_STANDBY
