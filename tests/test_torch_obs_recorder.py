"""The port's flight recorder against the JAX package's, live JAX calls
on the CPU.

* ``record_step`` on seeded random inputs (K=7 players, M=5 arms, 3
  marks; capacity 8, which wraps and overflows inside one step's
  batch, and 64; with and without breakers, control deltas, retry
  drops and sheds), over several steps: every ring array equal, the
  values bit for bit.
* Whole ``run_sim_stream`` runs with the recorder on, on the
  ``retry_storm`` lifecycle config (the graceful-degradation lane's
  ``bounded`` and ``naive`` policies) and on a closed-loop config that
  scales, migrates and sheds (every kind of event), at the sizes where
  ``test_torch_resilience.py`` and ``test_torch_control.py`` hold every
  count exact: the decoded events equal the reference's.
* Lanes: each lane's ring equals its run alone. Chunked runs equal the
  unchunked one, a checkpointed and resumed run the uninterrupted one,
  bit for bit. The recorder leaves every accumulator field as it is
  with the recorder off. ``trace=True`` raises. A converted reference
  carry with a ring steps on to the reference's ring.
"""
import dataclasses
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
from repro.obs import recorder as jrec
from repro_torch import convert
from repro_torch.continuum import control as tc
from repro_torch.continuum import library as tlib
from repro_torch.continuum import metrics as tm
from repro_torch.continuum import scenarios as tscn
from repro_torch.continuum import simulator as ts
from repro_torch.continuum import topology as ttopo
from repro_torch.core import prand
from repro_torch.obs import recorder as trec

C, R = 4, 16
WARM = 10


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors: one intra-op thread is faster than many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(x) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(x), copy=True))


def assert_same_ring(want, got, what=""):
    for f in want._fields:
        a, b = np.asarray(getattr(want, f)), trec._np(getattr(got, f))
        assert a.dtype == b.dtype and a.shape == b.shape, (what, f)
        np.testing.assert_array_equal(b, a, err_msg=f"{what} rec.{f}")


# ---------------------------------------------------------------------------
# record_step on seeded inputs.
# ---------------------------------------------------------------------------

KR, MR, ER = 7, 5, 3


def step_inputs(rng, t, breakers, control, drops, sheds):
    iss = rng.integers(0, 5, KR).astype(np.float32)
    miss = np.minimum(iss, rng.integers(0, 5, KR)).astype(np.float32)
    kw = dict(marks=np.array([t, t + 2, -1], np.int32)[rng.permutation(ER)]
              if rng.uniform() < 0.5 else np.array([1, 3, -1], np.int32),
              miss_k=miss, iss_k=iss)
    if breakers:
        kw["open_now"] = rng.uniform(size=(KR, MR)) < 0.3
    if control:
        kw["ctl_deltas"] = tuple(
            np.float32(rng.integers(0, 3) * (rng.uniform() < 0.5))
            for _ in range(3))
    if drops:
        kw["retry_drop_k"] = (rng.integers(0, 3, KR)
                              * (rng.uniform(size=KR) < 0.4)).astype(
            np.float32)
    if sheds:
        kw["shed_k"] = (rng.integers(0, 4, KR)
                        * (rng.uniform(size=KR) < 0.3)).astype(np.float32)
    return kw


def to_jax(kw):
    out = {}
    for k, v in kw.items():
        out[k] = (tuple(jnp.asarray(d) for d in v) if k == "ctl_deltas"
                  else jnp.asarray(v))
    return out


def to_torch(kw):
    out = {}
    for k, v in kw.items():
        out[k] = (tuple(torch.tensor(d) for d in v) if k == "ctl_deltas"
                  else T(v))
    return out


FLAGS = [dict(breakers=b, control=c, drops=d, sheds=s)
         for b, c, d, s in ((False, False, False, False),
                            (True, False, False, False),
                            (True, True, True, True),
                            (False, True, False, True),
                            (True, False, True, False))]


@pytest.mark.parametrize("cap", [8, 64])
@pytest.mark.parametrize("flags", FLAGS,
                         ids=["-".join(k for k, v in f.items() if v) or "base"
                              for f in FLAGS])
def test_record_step_matches_the_reference(cap, flags):
    rng = np.random.default_rng(cap * 31 + sum(v << i for i, v in
                                               enumerate(flags.values())))
    jcfg = jrec.RecorderConfig(capacity=cap, qos_spike=0.4)
    tcfg = trec.RecorderConfig(capacity=cap, qos_spike=0.4)
    jr = jrec.recorder_init(jcfg, KR, MR, flags["breakers"])
    tr = trec.recorder_init(tcfg, KR, MR, flags["breakers"], device="cpu")
    assert_same_ring(jr, tr, "init")
    jstep = jax.jit(jrec.record_step, static_argnums=0)
    pids = np.arange(KR, dtype=np.int32)
    for t in range(6):
        kw = step_inputs(rng, t, **flags)
        jr = jstep(jcfg, jr, t_idx=jnp.int32(t), pids=jnp.asarray(pids),
                   **to_jax(kw))
        tr = trec.record_step(tcfg, tr, t_idx=t, pids=T(pids),
                              **to_torch(kw))
        assert_same_ring(jr, tr, f"step {t}")
    assert trec.recorder_events(tr) == jrec.recorder_events(jr)
    assert trec.events_appended(tr) == jrec.events_appended(jr)
    assert trec.events_dropped(tr) == jrec.events_dropped(jr)
    if cap == 8:
        assert trec.events_dropped(tr) > 0      # the ring wrapped


def test_batch_larger_than_the_ring_keeps_its_newest_candidates():
    """One step's batch larger than the ring: only its last ``cap``
    candidates survive, in order, whatever the scatter order; a run
    without player 0 records no fleet event."""
    cfg = trec.RecorderConfig(capacity=4)
    rec = trec.recorder_init(cfg, 10, 4, False, device="cpu")
    miss = torch.where(torch.arange(10) < 7, 3.0, 0.0)
    rec = trec.record_step(cfg, rec, t_idx=0, pids=torch.arange(10),
                           marks=torch.tensor([0, -1]), miss_k=miss,
                           iss_k=miss)
    assert trec.events_appended(rec) == 8 and trec.events_dropped(rec) == 4
    assert [e.entity for e in trec.recorder_events(rec)] == [3, 4, 5, 6]
    other = trec.record_step(
        cfg, trec.recorder_init(cfg, 10, 4, False, device="cpu"), t_idx=0,
        pids=torch.arange(10) + 10, marks=torch.tensor([0, -1]),
        miss_k=torch.zeros(10), iss_k=torch.ones(10))
    assert trec.recorder_events(other) == []
    assert not trec.recorder_enabled(ts.SimConfig())
    assert not ts.SimConfig(recorder=trec.RecorderConfig(0)).recorder_on
    assert ts.SimConfig(recorder=trec.RecorderConfig(8)).recorder_on


# ---------------------------------------------------------------------------
# Whole runs against the reference.
# ---------------------------------------------------------------------------

KS, MS, HS = 6, 4, 5.0                  # test_torch_resilience's size
SMALL = dict(max_clients=C, ring=R, horizon=HS)
CAP = 4096


def storm_inputs(jcfg):
    sc = jlib.get_library(HS, KS, MS)["retry_storm"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jdrv = jscn.compile_scenario(sc, jcfg, jax.random.PRNGKey(600))
    rtt = jtopo.make_topology(jax.random.PRNGKey(1), KS, MS).lb_instance_rtt()
    return jdrv, rtt, jax.random.PRNGKey(5)


def port_args(jdrv, rtt, key):
    return (np.asarray(rtt), convert.key_to_torch(np.asarray(key), "cpu"),
            convert.drivers_to_torch(jax.tree.map(np.asarray, jdrv), "cpu"))


def events(rec):
    return [(e.step, e.kind, e.entity, e.value, e.shard, e.seq)
            for e in trec.recorder_events(rec)]


# the bounded lifecycle with breakers, and naive retries without a deadline
RECORDING = ("bounded", "naive")




def port_run(tcfg, jdrv, rtt, key, **kw):
    rtt_t, key_t, drv_t = port_args(jdrv, rtt, key)
    return ts.run_sim_stream("qedgeproxy", rtt_t, tcfg, key_t, drivers=drv_t,
                             warmup_steps=WARM, device="cpu", **kw)


def storm_configs(knobs, cap=CAP):
    return (js.SimConfig(tau=bsuite.DEGRADE_TAU, **SMALL, **knobs,
                         recorder=jrec.RecorderConfig(capacity=cap)),
            ts.SimConfig(tau=bsuite.DEGRADE_TAU, **SMALL, **knobs,
                         recorder=trec.RecorderConfig(capacity=cap)))


@pytest.mark.parametrize("label", RECORDING)
def test_storm_events_match_the_reference(label):
    knobs = dict(bsuite.DEGRADE_POLICIES)[label]
    jcfg, tcfg = storm_configs(knobs)
    jdrv, rtt, key = storm_inputs(jcfg)
    want = js.run_sim_stream("qedgeproxy", rtt, jcfg, key, drivers=jdrv,
                             warmup_steps=WARM)
    got = port_run(tcfg, jdrv, rtt, key)
    assert events(got.rec) == [tuple(e)
                               for e in jrec.recorder_events(want.rec)]
    assert_same_ring(want.rec, got.rec, label)
    kinds = {e.kind for e in trec.recorder_events(got.rec)}
    assert trec.KIND_MARK in kinds
    if knobs.get("breaker_threshold"):
        assert {trec.KIND_BREAKER_TRIP, trec.KIND_BREAKER_RESET} <= kinds


KC, MC, STANDBY, HC = 12, 4, 2, 6.0     # test_torch_control's size
MCT = MC + STANDBY
CTL = dict(managed=STANDBY, warmup=0.5, up_queue=2.0, down_queue=0.3,
           hold=0.3, action_cooldown=1.0, batch=1, admit=True,
           target_queue=3.0, admit_floor=0.3, regions=2, mig_threshold=2.0,
           mig_step=0.1)
CSMALL = dict(max_clients=C, ring=R, horizon=HC, **bsuite.CONTROL_RES)


def control_case(cap=CAP):
    jcfg = js.SimConfig(**CSMALL, control=jc.ControlConfig(**CTL),
                        recorder=jrec.RecorderConfig(capacity=cap))
    tcfg = ts.SimConfig(**CSMALL, control=tc.ControlConfig(**CTL),
                        recorder=trec.RecorderConfig(capacity=cap))
    sc = jscn.with_standby(jlib.get_library(HC, KC, MC)["retry_storm"],
                           STANDBY)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jdrv = jscn.compile_scenario(sc, jcfg, jax.random.PRNGKey(700))
    rtt = jtopo.make_topology(jax.random.PRNGKey(1), KC, MCT).lb_instance_rtt()
    return jcfg, tcfg, jdrv, rtt, jax.random.PRNGKey(5)


def test_closed_loop_events_match_the_reference():
    jcfg, tcfg, jdrv, rtt, key = control_case()
    want = js.run_sim_stream("qedgeproxy", rtt, jcfg, key, drivers=jdrv,
                             warmup_steps=WARM)
    got = port_run(tcfg, jdrv, rtt, key)
    assert events(got.rec) == [tuple(e)
                               for e in jrec.recorder_events(want.rec)]
    assert_same_ring(want.rec, got.rec, "closed loop")
    # every kind of event happened, and was recorded
    assert {e.kind for e in trec.recorder_events(got.rec)} == set(
        trec.KIND_NAMES)


def test_recorder_leaves_the_run_as_it_is():
    """Recorder on and off: every accumulator field, series value and
    control counter equal, on the closed loop over the lifecycle."""
    jcfg, tcfg, jdrv, rtt, key = control_case()
    on = port_run(tcfg, jdrv, rtt, key)
    off = port_run(dataclasses.replace(tcfg, recorder=None), jdrv, rtt, key)
    zero = port_run(dataclasses.replace(
        tcfg, recorder=trec.RecorderConfig(capacity=0)), jdrv, rtt, key)
    assert off.rec is None and zero.rec is None
    assert trec.events_appended(on.rec) > 0
    for other in (off, zero):
        for part in ("acc", "series", "ctrl"):
            for f in getattr(on, part)._fields:
                assert torch.equal(getattr(getattr(on, part), f),
                                   getattr(getattr(other, part), f)), \
                    (part, f)


def test_lanes_record_each_lane_as_it_runs_alone():
    """Three scenarios as the lanes of one run with the recorder on:
    ``metrics.lane`` hands back each lane's (cap,) ring and (1,) ptr,
    equal to its run alone, and the lane-batched ring decodes as one
    ring a lane. Capacity 8 wraps."""
    _, cfg = storm_configs(dict(bsuite.DEGRADE_POLICIES)["bounded"], cap=8)
    lib = tlib.get_library(HS, KS, MS)
    names = ("retry_storm", "metastable_overload", "cascade_failure")
    drivers = [tscn.compile_scenario(lib[n], cfg, 600 + i, device="cpu")
               for i, n in enumerate(names)]
    rtts = torch.stack([ttopo.make_topology(s, KS, MS, device="cpu")
                        .lb_instance_rtt() for s in (1, 2, 3)])
    keys = torch.stack([prand.prng_key(11 + s) for s in range(3)])
    out = ts.run_sim_grid("qedgeproxy", rtts, cfg, keys,
                          drivers=tscn.stack_drivers(drivers),
                          warmup_steps=WARM, device="cpu")
    assert out.rec.step.shape == (3, 8) and out.rec.ptr.shape == (3, 1)
    assert out.rec.prev_open.shape == (3, KS, MS)
    total = 0
    for s in range(3):
        one = ts.run_sim_stream("qedgeproxy", rtts[s], cfg, keys[s],
                                drivers=drivers[s], warmup_steps=WARM,
                                device="cpu")
        ln = tm.lane(out, s).rec
        assert ln.step.shape == (8,) and ln.ptr.shape == (1,)
        for f in one.rec._fields:
            assert torch.equal(getattr(ln, f), getattr(one.rec, f)), (s, f)
        total += trec.events_appended(one.rec)
    assert trec.events_appended(out.rec) == total
    assert trec.events_dropped(out.rec) > 0
    assert {e.shard for e in trec.recorder_events(out.rec)} == {0, 1, 2}


def test_chunked_and_resumed_rings_are_exact(tmp_path):
    """Chunks in order, and a run stopped into a checkpoint and resumed
    under another chunk length, end with the whole run's ring."""
    jcfg, cfg = storm_configs(dict(bsuite.DEGRADE_POLICIES)["bounded"],
                              cap=8)
    jdrv, rtt, key = storm_inputs(jcfg)
    full = port_run(cfg, jdrv, rtt, key)
    assert trec.events_dropped(full.rec) > 0
    chunked = port_run(cfg, jdrv, rtt, key, chunk_steps=20)
    d = str(tmp_path / "ck")
    port_run(cfg, jdrv, rtt, key, chunk_steps=20, checkpoint_dir=d,
             stop_at_step=30)
    resumed = port_run(cfg, jdrv, rtt, key, chunk_steps=15,
                       checkpoint_dir=d, resume=True)
    for other in (chunked, resumed):
        for f in full.rec._fields:
            assert torch.equal(getattr(full.rec, f),
                               getattr(other.rec, f)), f
        for f in full.acc._fields:
            assert torch.equal(getattr(full.acc, f),
                               getattr(other.acc, f)), f


def test_trace_mode_raises():
    _, cfg = storm_configs({})
    rtt = ttopo.make_topology(1, KS, MS, device="cpu").lb_instance_rtt()
    with pytest.raises(ValueError, match="streaming-only"):
        ts.run_sim("qedgeproxy", rtt, cfg, 5, device="cpu")
    with pytest.raises(ValueError, match="streaming-only"):
        ts.run_sim_batch("qedgeproxy", rtt[None], cfg, [5], device="cpu")


def test_converted_carry_steps_on_to_the_reference_ring():
    """The reference's carry after s steps (breaker, control and
    recorder slots), converted, stepped n more steps by the port: the
    same ring as the reference's n more steps, and back through
    ``carry_to_numpy``."""
    jcfg, tcfg, jdrv, rtt, key = control_case(cap=32)
    s, n = 25, 20
    jinit, jchunk = js.build_sim_chunks("qedgeproxy", jcfg, KC, MCT,
                                        warmup_steps=WARM)
    jchunk = jax.jit(jchunk)
    carry, keys = jax.jit(jinit)(rtt, jdrv.active[0], key)
    carry, _ = jchunk(rtt, carry, jnp.arange(s),
                      jscn.slice_drivers(jdrv, 0, s), keys[:s])
    start = jax.tree.map(np.asarray, carry)
    assert start[8] is not None and int(start[8].ptr[0]) > 0
    want, _ = jchunk(rtt, carry, jnp.arange(s, s + n),
                     jscn.slice_drivers(jdrv, s, s + n), keys[s:s + n])
    rtt_t, _, drv_t = port_args(jdrv, rtt, key)
    _, tchunk = ts.build_sim_chunks("qedgeproxy", tcfg, KC, MCT,
                                    warmup_steps=WARM)
    got, _ = tchunk(torch.tensor(rtt_t), convert.carry_to_torch(start, "cpu"),
                    range(s, s + n), tscn.slice_drivers(drv_t, s, s + n),
                    convert.key_to_torch(np.asarray(keys[s:s + n]), "cpu"))
    assert_same_ring(want[8], got[8], "stepped on")
    back = convert.carry_to_numpy(got)[8]
    assert isinstance(back, trec.RecorderState)
    for f in back._fields:
        np.testing.assert_array_equal(getattr(back, f),
                                      np.asarray(getattr(want[8], f)))
    assert int(want[8].ptr[0]) > int(start[8].ptr[0]) + 32   # wrapped
