"""The port's streaming simulator against the JAX package's, end to end.

* ``update_accumulator`` on the same inputs;
* one engine step from the same mid-run carry (carried across with
  ``repro_torch.convert``): every counting field and choice exact;
* the whole slice, ``run_sim_stream("qedgeproxy")`` at K=30 x M=10 for
  50 steps from ``PRNGKey(7)``: counting fields exact, regret to
  ``rtol=1e-4``;
* topology, stagger table, metric readouts, the main-path gates, and
  that the port imports neither JAX nor the JAX package.

Float tolerances: a step's regret is ``max mu - <w, mu>``, a difference
of two sums of at most M terms below 1. Their rounding is absolute, not
relative: XLA fuses the products into FMAs, its ``erf``/``log`` differ
from torch's by a few ULP, and the weights come from KDE estimates whose
64-term sums it reassociates. So regret-like sums match to ``rtol=1e-4``
plus ``M * eps32`` per step summed; ``prev_mu`` (one step's oracle) to
``rtol=1e-5``.
"""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.continuum import metrics as jm
from repro.continuum import scenarios as jscn
from repro.continuum import simulator as js
from repro.continuum.tenancy import TenancyConfig
from repro.continuum import topology as jtopo
from repro_torch import convert
from repro_torch.continuum import metrics as tm
from repro_torch.continuum import scenarios as tscn
from repro_torch.continuum import simulator as ts
from repro_torch.continuum import topology as ttopo
from repro_torch.core import prand
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_continuum_mesh
from repro_torch.obs import RecorderConfig

ROOT = Path(__file__).resolve().parents[1]
COUNTS = ("succ_kc", "n_kc", "arrivals_m", "choice_counts", "proc_hist",
          "steps_measured", "ev_succ", "ev_n", "att_k", "timeout_k",
          "drop_k", "open_km")
FLOATS = ("regret_k", "vb_k", "prev_mu")


def T(x) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(x), copy=True))


EPS32 = float(np.finfo(np.float32).eps)


def close(want, got, what, rtol=1e-4, steps=0, M=10):
    """``rtol`` plus the absolute rounding of ``steps`` regret sums."""
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=steps * M * EPS32, err_msg=what)


def exact(want, got, what):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


@pytest.fixture(scope="module")
def rtt30():
    topo = jtopo.make_topology(jax.random.PRNGKey(7), 30, 10)
    return np.asarray(topo.lb_instance_rtt())


# ---------------------------------------------------------------------------
# Accumulator.
# ---------------------------------------------------------------------------

def test_update_accumulator_parity():
    K, M, C = 12, 5, 8
    rng = np.random.default_rng(0)
    marks = np.full(jscn.MAX_MARKS, -1, np.int32)
    marks[:3] = [2, 5, 40]
    upd = jax.jit(lambda a, kw: jm.update_accumulator(
        a, **kw, warmup_steps=3, marks=jnp.asarray(marks), ev_pre_steps=2,
        ev_bucket_steps=2))
    ja = jm.init_accumulator(K, M, C, n_marks=jscn.MAX_MARKS, ev_buckets=4)
    ta = tm.init_accumulator(K, M, C, n_marks=tscn.MAX_MARKS, ev_buckets=4,
                             device="cpu")
    for t in range(8):
        kw = dict(rewards=(rng.uniform(size=(K, C)) < 0.8).astype(np.float32),
                  issued=rng.uniform(size=(K, C)) < 0.7,
                  choices=rng.integers(0, M, (K, C)).astype(np.int32),
                  procs=np.exp(rng.uniform(-9, 2, (K, C))).astype(np.float32),
                  arrivals=rng.integers(0, 9, M).astype(np.float32),
                  regret=rng.uniform(size=K).astype(np.float32),
                  mu=rng.uniform(size=(K, M)).astype(np.float32))
        kw["procs"][0, :2] = tm._PROC_EDGES[[0, 5]]        # on a bin edge
        ja = upd(ja, dict(kw, t_idx=jnp.int32(t)))
        ta = tm.update_accumulator(
            ta, **{k: T(v) for k, v in kw.items()}, t_idx=t, warmup_steps=3,
            marks=T(marks), ev_pre_steps=2, ev_bucket_steps=2)
    for f in COUNTS:
        exact(getattr(ja, f), getattr(ta, f).numpy(), f)
    for f in FLOATS:                     # plain sums of the same floats
        close(getattr(ja, f), getattr(ta, f).numpy(), f, rtol=1e-6)


# ---------------------------------------------------------------------------
# One step from the same carry.
# ---------------------------------------------------------------------------

STEP_K, STEP_M, STEP_T = 30, 10, 14


@pytest.fixture(scope="module")
def jax_run(rtt30):
    """The JAX engine's carries at steps STEP_T - 1 and STEP_T."""
    cfg = js.SimConfig(horizon=STEP_T * 0.1)
    init_fn, step_fn = js.build_sim_parts("qedgeproxy", cfg, STEP_K, STEP_M,
                                          trace=False, warmup_steps=3)
    drv = jscn.neutral_drivers(cfg, STEP_K, STEP_M)
    rtt = jnp.asarray(rtt30)
    carry, keys = init_fn(rtt, drv.active[0], jax.random.PRNGKey(7))
    step = jax.jit(lambda c, x: step_fn(rtt, drv.marks, c, x))
    xs_all = []
    for i in range(STEP_T):
        xs = (jnp.int32(i), *(getattr(drv, f)[i] for f in jscn.STEP_FIELDS),
              keys[i], carry[4][i % cfg.maint_every])
        xs_all.append(xs)
        prev = carry
        carry, ys = step(carry, xs)
    as_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return cfg, as_np(prev), as_np(xs_all[-1]), as_np(carry), as_np(ys)


def test_convert_round_trip_of_a_mid_run_carry(jax_run):
    _, carry, _, _, _ = jax_run
    back = convert.carry_to_numpy(convert.carry_to_torch(carry, "cpu"))
    leaves_a = jax.tree.leaves(carry)
    leaves_b = jax.tree.leaves(back)
    assert len(leaves_a) == len(leaves_b)
    for a, b in zip(leaves_a, leaves_b):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert back[6:] == (None, None, None)
    key = np.asarray(jax.random.key_data(jax.random.key(3)))
    assert np.array_equal(convert.key_to_numpy(convert.key_to_torch(key, "cpu")),
                          key)


def test_one_step_from_the_same_carry(jax_run, rtt30):
    cfg, carry, xs, want, want_ys = jax_run
    tcfg = ts.SimConfig(horizon=cfg.horizon)
    _, step_fn = ts.build_sim_parts("qedgeproxy", tcfg, STEP_K, STEP_M,
                                    trace=False, warmup_steps=3)
    t_idx, *fields, key, group = xs
    txs = (int(t_idx), *(T(f) for f in fields),
           convert.key_to_torch(key, "cpu"), T(group))
    marks = T(np.full(tscn.MAX_MARKS, -1, np.int32))
    got, ys = step_fn(T(rtt30), marks, convert.carry_to_torch(carry, "cpu"),
                      txs, False)
    got = convert.carry_to_numpy(got)
    (ws, wq, wact, wacc, *_), (gs, gq, gact, gacc, *_) = want, got
    for f in ws._fields:
        a, b = getattr(ws, f), getattr(gs, f)
        if a.dtype.kind in "biu" or f in ("lat_buf", "ts_buf", "r_buf",
                                          "rts_buf", "cooldown_until"):
            exact(a, b, f)           # counters, selections, ring contents
        else:
            close(a, b, f, rtol=1e-5)
    exact(wq, gq, "queue")
    exact(wact, gact, "active")
    for f in COUNTS:
        exact(getattr(wacc, f), getattr(gacc, f), f)
    close(wacc.regret_k, gacc.regret_k, "regret_k", steps=STEP_T)
    close(wacc.vb_k, gacc.vb_k, "vb_k", steps=STEP_T)
    close(wacc.prev_mu, gacc.prev_mu, "prev_mu", rtol=1e-5)
    exact(want_ys.succ, ys.succ.numpy(), "succ")
    exact(want_ys.issued, ys.issued.numpy(), "issued")
    close(want_ys.regret, ys.regret.numpy(), "regret", steps=1,
          M=STEP_K * STEP_M)


# ---------------------------------------------------------------------------
# The whole slice.
# ---------------------------------------------------------------------------

def test_whole_slice_matches_the_reference(rtt30):
    cfg = js.SimConfig(horizon=5.0)
    want = js.run_sim_stream("qedgeproxy", jnp.asarray(rtt30), cfg,
                             jax.random.PRNGKey(7), warmup_steps=10)
    key = convert.key_to_torch(np.asarray(jax.random.PRNGKey(7)), "cpu")
    got = ts.run_sim_stream("qedgeproxy", rtt30, ts.SimConfig(horizon=5.0),
                            key, warmup_steps=10, device="cpu")
    for f in COUNTS:
        a, b = np.asarray(getattr(want.acc, f)), getattr(got.acc, f).numpy()
        if f == "proc_hist":
            # ROADMAP §C: KDE-mu ULPs reorder two SWRR picks of one
            # player within a step; every request still lands on the
            # same instance, so the per-instance totals are exact
            exact(a.sum(-1), b.sum(-1), "proc_hist totals")
            assert np.abs(a - b).sum() <= PROC_HIST_MOVED, np.abs(a - b).sum()
        else:
            exact(a, b, f)
    T_ = cfg.num_steps
    close(want.acc.regret_k, got.acc.regret_k.numpy(), "regret_k", steps=T_)
    close(want.acc.vb_k, got.acc.vb_k.numpy(), "vb_k", steps=T_)
    close(want.acc.prev_mu, got.acc.prev_mu.numpy(), "prev_mu", rtol=1e-5)
    exact(want.series.succ, got.series.succ.numpy(), "series.succ")
    exact(want.series.issued, got.series.issued.numpy(), "series.issued")
    exact(want.series.attempts, got.series.attempts.numpy(), "attempts")
    close(want.series.regret, got.series.regret.numpy(), "series.regret",
          steps=1, M=30 * 10)
    for jfn, tfn, args in (
            (jm.client_qos_satisfaction_stream,
             tm.client_qos_satisfaction_stream, (cfg.rho,)),
            (jm.jain_fairness_stream, tm.jain_fairness_stream, ()),
            (jm.request_rate_per_instance_stream,
             tm.request_rate_per_instance_stream, (cfg.dt,))):
        np.testing.assert_array_equal(tfn(got.acc, *args),
                                      jfn(want.acc, *args))
    np.testing.assert_array_equal(tm.rolling_qos_series(got.series, 20),
                                  jm.rolling_qos_series(want.series, 20))


# The one counting field that moved at this seed (ROADMAP §C): requests
# whose processing latency changed bin when their order flipped.
PROC_HIST_MOVED = 8


def test_whole_slice_with_placement_events(rtt30):
    # instances leave and return (Alg 3/4 through the host-side change
    # flags) under a varying client count, handed over as JAX drivers
    cfg = js.SimConfig(horizon=3.0)
    T_, K, M = cfg.num_steps, 30, 10
    rng = np.random.default_rng(0)
    active = np.ones((T_, M), bool)
    active[8:20, 3] = False
    active[12:, 7] = False
    nc = rng.integers(0, 9, (T_, K)).astype(np.int32)
    drv = jscn.neutral_drivers(cfg, K, M, jnp.asarray(nc), jnp.asarray(active))
    want = js.run_sim_stream("qedgeproxy", jnp.asarray(rtt30), cfg,
                             jax.random.PRNGKey(3), drivers=drv,
                             warmup_steps=5)
    got = ts.run_sim_stream(
        "qedgeproxy", rtt30, ts.SimConfig(horizon=3.0), 3,
        drivers=convert.drivers_to_torch(jax.tree.map(np.asarray, drv), "cpu"),
        warmup_steps=5, device="cpu")
    for f in COUNTS:
        exact(getattr(want.acc, f), getattr(got.acc, f).numpy(), f)
    close(want.acc.regret_k, got.acc.regret_k.numpy(), "regret_k", steps=T_)
    close(want.acc.vb_k, got.acc.vb_k.numpy(), "vb_k", steps=T_)
    exact(want.series.succ, got.series.succ.numpy(), "series.succ")


def test_proc_latency_quantile_readout():
    rng = np.random.default_rng(1)
    hist = rng.integers(0, 5, (4, tm.PROC_HIST_BINS)).astype(np.float32)
    hist[2] = 0.0
    ja = jm.init_accumulator(3, 4, 2, n_marks=1, ev_buckets=1)._replace(
        proc_hist=jnp.asarray(hist))
    ta = tm.init_accumulator(3, 4, 2, n_marks=1, ev_buckets=1,
                             device="cpu")._replace(proc_hist=T(hist))
    for q in (0.5, 0.9):
        np.testing.assert_array_equal(tm.proc_latency_quantile_stream(ta, q),
                                      jm.proc_latency_quantile_stream(ja, q))


# ---------------------------------------------------------------------------
# Topology, stagger table, gates.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [1, 7])
def test_topology_matches(seed):
    want = jtopo.make_topology(jax.random.PRNGKey(seed), 30, 10)
    got = ttopo.make_topology(seed, 30, 10, device="cpu")
    exact(want.instance_nodes, got.instance_nodes.numpy(), "placement")
    # distances are square roots of FMA-contracted sums in XLA
    np.testing.assert_allclose(got.rtt.numpy(), np.asarray(want.rtt),
                               rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("K", [30, 37])
def test_stagger_groups_exact(K):
    k = jax.random.PRNGKey(K)
    want = js._stagger_groups(k, K, 10, -(-K // 10), 0, K)
    got = ts._stagger_groups(prand.prng_key(K), K, 10, -(-K // 10), 0, K)
    exact(want, got.numpy(), "groups")


@pytest.mark.parametrize("change", [
    dict(recorder=RecorderConfig(capacity=8)),
    dict(tenancy=TenancyConfig(taus=(0.08, 0.2))),
    dict(max_retries=1)])
def test_off_path_settings_raise(change, rtt30):
    # the flight recorder and tenancy stream and refuse trace mode (a
    # tenant run returns one accumulator a tenant); retries without a
    # timeout are refused in either mode, as the reference refuses them
    cfg = ts.SimConfig(horizon=0.5, **change)
    if "recorder" in change:
        assert ts.run_sim_stream("qedgeproxy", rtt30, cfg, 7,
                                 device="cpu").rec is not None
        with pytest.raises(ValueError, match="streaming-only"):
            ts.run_sim("dec_sarsa", rtt30, cfg, 7, device="cpu")
        return
    if "tenancy" in change:
        out = ts.run_sim_stream("qedgeproxy", rtt30, cfg, 7, device="cpu")
        assert isinstance(out.acc, tuple) and len(out.acc) == 2
        assert tuple(out.series.succ.shape) == (cfg.num_steps, 2)
        with pytest.raises(ValueError, match="streaming-only"):
            ts.run_sim("dec_sarsa", rtt30, cfg, 7, device="cpu")
        return
    with pytest.raises(ValueError, match="attempt_timeout"):
        ts.run_sim_stream("qedgeproxy", rtt30, cfg, 7, device="cpu")
    with pytest.raises(ValueError, match="attempt_timeout"):
        ts.run_sim("dec_sarsa", rtt30, cfg, 7, device="cpu")


def test_other_entry_options_raise(rtt30, tmp_path):
    cfg = ts.SimConfig(horizon=0.5)
    # a player mesh does not compose with chunks; player sharding is
    # streaming-only and needs K to split evenly (the reference's errors)
    mesh = make_continuum_mesh(players=2, devices=2)
    with pytest.raises(ValueError, match="chunk_steps"):
        ts.run_sim_stream("proxy_mity", rtt30, cfg, 7, mesh=mesh,
                          chunk_steps=2, device="cpu")
    with pytest.raises(ValueError, match="streaming"):
        ts.build_sim_parts("dec_sarsa", cfg, 30, 10,
                           pshard=ts.PlayerSharding(None, 2))
    with pytest.raises(ValueError, match="multiple"):
        ts.build_sim_parts("dec_sarsa", cfg, 30, 10, trace=False,
                           pshard=ts.PlayerSharding(None, 4))
    # chunks run (tests/test_torch_checkpoint.py holds them against whole
    # runs); checkpoints need the chunked loop
    whole = ts.run_sim_stream("qedgeproxy", rtt30, cfg, 7, device="cpu")
    chunked = ts.run_sim_stream("qedgeproxy", rtt30, cfg, 7, chunk_steps=2,
                                device="cpu")
    assert torch.equal(whole.acc.choice_counts, chunked.acc.choice_counts)
    with pytest.raises(ValueError, match="chunked loop"):
        ts.run_sim_stream("qedgeproxy", rtt30, cfg, 7,
                          checkpoint_dir=str(tmp_path / "ckpt"),
                          device="cpu")
    assert not (tmp_path / "ckpt").exists()


def test_device_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)
