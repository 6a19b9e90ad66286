"""The multi-tenant engine's arithmetic and semantics against the JAX
package's, live JAX calls on the CPU, at the reference test's sizes
(K=10 x M=4, a 12 s horizon, warm-up 30, topology key 2, run key 5).

* A run with a per-tenant ``service_scale`` equals the reference's:
  every count exact, the true ``mu`` within 2 float32 eps, its float
  sums within ``rtol=1e-6`` plus ``M * eps32`` a term.
* The queue trajectory, step by step, equals the reference's bit for
  bit, and does not when the interference factor ``1 + xi * other`` or
  the drain's ``sum_i b_i * s_eff_i`` is rounded in two steps where the
  reference's compiler fuses them (one FMA, an FMA chain over the
  tenants).
* A reference tenant carry (NT-tuples of strategy states and
  accumulators, the (NT, M) queue) crosses into the port through
  ``convert``, and the port runs on from it to the reference's end
  state; ``carry_to_numpy`` gives it back unchanged.
* Counts follow the per-tenant schedules; interference and a heavy
  tenant's service scale lower QoS.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.continuum import library as jlib
from repro.continuum import scenarios as jscn
from repro.continuum import simulator as js
from repro.continuum import tenancy as jt
from repro.continuum import topology as jtopo
from repro_torch import convert
from repro_torch.continuum import scenarios as tscn
from repro_torch.continuum import simulator as ts
from repro_torch.continuum import tenancy as tt

EPS32 = float(np.finfo(np.float32).eps)
K, M, WARM, HORIZON = 10, 4, 30, 12.0
STEPS = int(HORIZON / 0.1)
TN2 = dict(taus=(0.080, 0.150), interference=0.3)
FLOATS = ("regret_k", "vb_k", "prev_mu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors: one intra-op thread is faster than many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(**tn):
    tn = {**TN2, **tn}
    return (js.SimConfig(horizon=HORIZON, tenancy=jt.TenancyConfig(**tn)),
            ts.SimConfig(horizon=HORIZON, tenancy=tt.TenancyConfig(**tn)))


def inputs():
    rtt = jtopo.make_topology(jax.random.PRNGKey(2), K, M).lb_instance_rtt()
    return rtt, jax.random.PRNGKey(5)


def to_torch(jdrv):
    return convert.drivers_to_torch(jax.tree.map(np.asarray, jdrv), "cpu")


def port_inputs():
    rtt, key = inputs()
    return torch.tensor(np.asarray(rtt)), convert.key_to_torch(
        np.asarray(key), "cpu")


def assert_accs_match(want, got):
    """Per-tenant accumulators: counts exact, floats within the bound."""
    assert isinstance(got, tuple) and len(got) == len(want)
    for s, (a_acc, b_acc) in enumerate(zip(want, got)):
        for f in a_acc._fields:
            a = np.asarray(getattr(a_acc, f))
            b = getattr(b_acc, f).numpy()
            assert a.shape == b.shape, (s, f)
            if f == "prev_mu":
                np.testing.assert_allclose(b, a, rtol=0, atol=2 * EPS32,
                                           err_msg=f"tenant {s} {f}")
            elif f in FLOATS:
                np.testing.assert_allclose(b, a, rtol=1e-6,
                                           atol=STEPS * M * EPS32,
                                           err_msg=f"tenant {s} {f}")
            else:
                np.testing.assert_array_equal(b, a, err_msg=f"tenant {s} {f}")


def assert_tenant_runs_match(want, got):
    assert_accs_match(want.acc, got.acc)
    for f in ("succ", "issued", "attempts"):
        np.testing.assert_array_equal(getattr(got.series, f).numpy(),
                                      np.asarray(getattr(want.series, f)),
                                      err_msg=f)
    np.testing.assert_allclose(got.series.regret.numpy(),
                               np.asarray(want.series.regret), rtol=1e-6,
                               atol=K * M * EPS32)


def noisy_neighbor(jcfg, base_clients):
    lib = jlib.get_tenant_library(HORIZON, K, M, n_tenants=2,
                                  base_clients=base_clients)
    return jscn.compile_tenant_scenario(lib["mt_noisy_neighbor"], jcfg,
                                        jax.random.PRNGKey(3))


def test_service_scale_run_matches_the_reference():
    jcfg, tcfg = configs(taus=(0.080, 0.080), service_scale=(1.0, 2.5))
    rtt, key = inputs()
    jdrv = jscn.tenant_neutral_drivers(jcfg, 2, K, M, base_clients=2)
    want = js.run_sim_stream("qedgeproxy", rtt, jcfg, key, drivers=jdrv,
                             warmup_steps=WARM)
    rtt_t, key_t = port_inputs()
    got = ts.run_sim_stream("qedgeproxy", rtt_t, tcfg, key_t,
                            drivers=to_torch(jdrv), warmup_steps=WARM,
                            device="cpu")
    assert_tenant_runs_match(want, got)


def _first_divergence(cfg_t, tdrv, rtt_t, key_t, want):
    """The first step after which the port's (NT, M) queue differs from
    ``want``'s, or None."""
    init_fn, step_fn = ts.build_sim_parts("qedgeproxy", cfg_t, K, M,
                                          trace=False, warmup_steps=WARM)
    carry, keys = init_fn(rtt_t, tdrv.active[0], key_t)
    act = tdrv.active.numpy()
    for i in range(len(want)):
        xs = (i, *(getattr(tdrv, f)[i] for f in tscn.STEP_FIELDS), keys[i],
              carry[4][i % 10])
        carry, _ = step_fn(rtt_t, tdrv.marks, carry, xs,
                           bool((act[i] != act[max(i - 1, 0)]).any()))
        if not np.array_equal(carry[1].numpy(), want[i]):
            return i
    return None


def test_queues_need_the_references_fmas(monkeypatch):
    """The (NT, M) queue after every step equals the reference's bit for
    bit. XLA:CPU contracts the interference factor ``1 + xi * other``
    into one FMA and sums the drain's work ``sum_i b_i * s_eff_i`` as an
    FMA chain over the tenants; rounding either in two steps moves a
    queue within the run."""
    jcfg, tcfg = configs()
    rtt, key = inputs()
    jdrv = noisy_neighbor(jcfg, 3)
    init_fn, step_fn = js.build_sim_parts("qedgeproxy", jcfg, K, M,
                                          trace=False, warmup_steps=WARM)
    carry, keys = init_fn(rtt, jdrv.active[0], key)
    step = jax.jit(lambda c, x: step_fn(rtt, jdrv.marks, c, x))
    want = []
    for i in range(STEPS):
        xs = (jnp.int32(i), *(getattr(jdrv, f)[i] for f in jscn.STEP_FIELDS),
              keys[i], carry[4][i % 10])
        carry, _ = step(carry, xs)
        want.append(np.asarray(carry[1]))
    assert (np.stack(want) > 0).mean() > 0.5        # the queues are busy
    args = (tcfg, to_torch(jdrv), *port_inputs(), want)
    assert _first_divergence(*args) is None
    with monkeypatch.context() as mp:
        mp.setattr(ts, "_interference", lambda other, xi: 1.0 + xi * other)
        assert _first_divergence(*args) is not None
    with monkeypatch.context() as mp:
        mp.setattr(ts, "_backlog_work", lambda b, s: b[:, 0] * s[:, 0]
                   + b[:, 1] * s[:, 1])
        assert _first_divergence(*args) is not None


def _qos(acc) -> float:
    return float(acc.succ_kc.double().sum() / max(float(acc.n_kc.sum()), 1.0))


def test_tenant_counts_follow_schedules():
    """Each tenant's issued and arrival totals follow its own schedule;
    the (T, NT) series columns sum to the full-horizon totals, and the
    module-built drivers serve every tenant."""
    _, cfg = configs()
    rtt, key = port_inputs()
    drv = tscn.tenant_neutral_drivers(cfg, 2, K, M, base_clients=1,
                                      device="cpu")
    drv = drv._replace(n_clients=drv.n_clients * torch.tensor([1, 2])[
        None, :, None].to(torch.int32))
    out = ts.run_sim_stream("qedgeproxy", rtt, cfg, key, drivers=drv,
                            warmup_steps=WARM, device="cpu")
    meas = STEPS - WARM
    issued = [float(a.n_kc.sum()) for a in out.acc]
    assert issued == [meas * K, meas * K * 2]
    for s, a in enumerate(out.acc):
        assert float(a.arrivals_m.sum()) == issued[s]
    assert tuple(out.series.issued.shape) == (STEPS, 2)
    assert out.series.issued.sum(0).tolist() == [STEPS * K, STEPS * K * 2]
    dflt = ts.run_sim_stream("qedgeproxy", rtt, cfg, key, warmup_steps=WARM,
                             device="cpu")
    assert [float(a.n_kc.sum()) for a in dflt.acc] == [meas * K * 4] * 2


def test_interference_and_service_scale_lower_qos():
    rtt, key = port_inputs()
    base = ts.SimConfig(horizon=HORIZON)

    def qos(tn):
        cfg = dataclasses.replace(base, tenancy=tn)
        drv = tscn.tenant_neutral_drivers(cfg, 2, K, M, base_clients=2,
                                          device="cpu")
        out = ts.run_sim_stream("qedgeproxy", rtt, cfg, key, drivers=drv,
                                warmup_steps=WARM, device="cpu")
        return [_qos(a) for a in out.acc]

    taus = (base.tau, base.tau)
    plain = qos(tt.TenancyConfig(taus=taus))
    assert np.mean(qos(tt.TenancyConfig(taus=taus, interference=1.0))) \
        < np.mean(plain)
    heavy = qos(tt.TenancyConfig(taus=taus, service_scale=(1.0, 4.0)))
    assert heavy[1] <= plain[1]
    assert np.mean(heavy) < np.mean(plain)


def test_a_reference_carry_runs_on_in_the_port():
    """The reference's tenant carry at step 60 (two strategy states, two
    accumulators, the (2, M) queue) crosses through ``convert``; the
    port's chunk over steps 60-120 from it ends where the reference's
    whole run ends."""
    jcfg, tcfg = configs()
    rtt, key = inputs()
    jdrv = noisy_neighbor(jcfg, 2)
    init_fn, chunk_fn = js.build_sim_chunks("qedgeproxy", jcfg, K, M,
                                            warmup_steps=WARM)
    carry0, keys = init_fn(rtt, jdrv.active[0], key)
    chunk = jax.jit(chunk_fn)
    mid, _ = chunk(rtt, carry0, jnp.arange(60), jscn.slice_drivers(jdrv, 0, 60),
                   keys[:60])
    end, want_ys = chunk(rtt, mid, jnp.arange(60, STEPS),
                         jscn.slice_drivers(jdrv, 60, STEPS), keys[60:])
    mid_np = jax.tree.map(np.asarray, mid)
    carry = convert.carry_to_torch(mid_np, "cpu")
    assert isinstance(carry[0], tuple) and isinstance(carry[3], tuple)
    assert tuple(carry[1].shape) == (2, M)
    back = convert.carry_to_numpy(carry)
    for a, b in zip(jax.tree.leaves(mid_np), jax.tree.leaves(back)):
        np.testing.assert_array_equal(b, a)
    rtt_t = torch.tensor(np.asarray(rtt))
    _, port_chunk = ts.build_sim_chunks("qedgeproxy", tcfg, K, M,
                                        warmup_steps=WARM)
    tdrv = to_torch(jdrv)
    got, ys = port_chunk(rtt_t, carry, range(60, STEPS),
                         tscn.slice_drivers(tdrv, 60, STEPS),
                         convert.key_to_torch(np.asarray(keys[60:]), "cpu"))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(end[1]))
    assert_accs_match(end[3], got[3])
    np.testing.assert_array_equal(ys.issued.numpy(),
                                  np.asarray(want_ys.issued))
    np.testing.assert_array_equal(ys.succ.numpy(), np.asarray(want_ys.succ))
