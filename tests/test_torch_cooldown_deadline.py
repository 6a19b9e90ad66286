"""A tripped arm's cooldown deadline, against the JAX package's, live
JAX calls on the CPU.

The reference computes the step time as ``t_idx * dt`` and a tripped
arm's deadline as ``t + cooldown`` in the same compiled step, and
XLA:CPU contracts the two into one FMA: the deadline rounds once. On
the steps where that differs from rounding ``t`` first (42, 47, 52, 57,
... at ``dt = 0.1``, ``cooldown = 10``), an arm rounded twice comes
back into the pool one step late, and the runs part (at step 323 of
the graceful-degradation lane's 60 s ``bounded`` run). Here every
request misses its deadline, so arms trip all the time: over 60 steps
the carry's ``cooldown_until``, error counters, pools and the counts
of the run must equal the reference's exactly on each path that trips
arms (the fused round, the round scan, per-round records, the request
lifecycle).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import scenario_suite as bsuite
from repro.continuum import scenarios as jscn
from repro.continuum import simulator as js
from repro.continuum import topology as jtopo
from repro_torch import convert
from repro_torch.continuum import simulator as ts

K, M, C, R = 6, 4, 4, 16
BASE = dict(max_clients=C, ring=R, horizon=6.0,
            tau=0.01)                       # every request misses
PATHS = {
    "fused_round": ({}, {}),
    "round_scan": (dict(fused_round=False), {}),
    "per_round_record": ({}, dict(fused=False)),
    "lifecycle": (dict(bsuite.DEGRADE_POLICIES)["bounded"], {}),
}


def rounds_apart(t_idx: int, dt: float = 0.1, cooldown: float = 10.0):
    """Does ``t_idx * dt + cooldown`` round differently once and twice?"""
    t = np.float32(np.float32(t_idx) * np.float32(dt))
    twice = np.float32(t + np.float32(cooldown))
    once = np.float32(np.float64(np.float32(t_idx)) * np.float64(
        np.float32(dt)) + np.float64(np.float32(cooldown)))
    return twice != once


@pytest.mark.parametrize("path", PATHS)
def test_cooldown_deadline_rounds_as_the_reference(path):
    knobs, kw = PATHS[path]
    jcfg = js.SimConfig(**BASE, **knobs)
    tcfg = ts.SimConfig(**BASE, **knobs)
    rtt = jtopo.make_topology(jax.random.PRNGKey(1), K, M).lb_instance_rtt()
    jdrv = jscn.neutral_drivers(jcfg, K, M)
    key = jax.random.PRNGKey(4)
    jinit, jchunk = js.build_sim_chunks("qedgeproxy", jcfg, K, M, **kw)
    carry, keys = jax.jit(jinit)(rtt, jdrv.active[0], key)
    T = jcfg.num_steps
    start = convert.carry_to_torch(jax.tree.map(np.asarray, carry), "cpu")
    want, want_ys = jax.jit(jchunk)(rtt, carry, jnp.arange(T), jdrv, keys)
    _, tchunk = ts.build_sim_chunks("qedgeproxy", tcfg, K, M, **kw)
    got, got_ys = tchunk(
        torch.tensor(np.asarray(rtt)), start, range(T),
        convert.drivers_to_torch(jax.tree.map(np.asarray, jdrv), "cpu"),
        convert.key_to_torch(np.asarray(keys), "cpu"))
    ws, gs = want[0], got[0]
    # deadlines set on steps where the two roundings differ are held
    cd = np.asarray(ws.cooldown_until)
    steps = np.rint((cd[cd > 0] - 10.0) / 0.1).astype(int)
    assert sum(rounds_apart(i) for i in steps) >= 3, sorted(set(steps))
    for f in ("cooldown_until", "err", "in_pool", "ptr", "rptr"):
        np.testing.assert_array_equal(getattr(gs, f).numpy(),
                                      np.asarray(getattr(ws, f)), err_msg=f)
    for f in ("n_kc", "succ_kc", "choice_counts", "arrivals_m", "att_k"):
        np.testing.assert_array_equal(getattr(got[3], f).numpy(),
                                      np.asarray(getattr(want[3], f)),
                                      err_msg=f)
    for f in ("succ", "issued", "attempts"):
        np.testing.assert_array_equal(getattr(got_ys, f).numpy(),
                                      np.asarray(getattr(want_ys, f)))


def test_a_direct_kernel_call_keeps_t_plus_cooldown():
    """Called alone with ``t`` a number, the round kernel's plain version
    adds ``cooldown`` to it (the reference kernel's rounding, ``t`` an
    operand); ``cooldown_at`` sets the deadline itself."""
    from repro_torch.kernels import ref
    assert ref.cooldown_deadline(4.2, 10.0) == float(
        np.float32(4.2) + np.float32(10.0))
    assert ref.cooldown_deadline(torch.tensor(4.2), 10.0) == float(
        np.float32(4.2) + np.float32(10.0))
    assert ref.cooldown_deadline(4.2, 10.0, 99.5) == 99.5
