"""The port's checkpointer and its chunked, checkpointed runs.

* ``Checkpointer``: a round trip of a nested tree (dicts, NamedTuples,
  tuples, ``None``, tensors of every carry dtype, numpy leaves), async
  saves, ``keep``, no ``.tmp`` left, a given step; ``CheckpointCorruptError``
  on a flipped byte, a truncated npz, an unreadable manifest and a
  foreign schema, before any leaf is parsed; ``config_hash`` equals the
  reference's ``obs.provenance.config_hash`` on the same config.
* ``run_sim_stream(chunk_steps=...)`` equals the unchunked run bit for
  bit for chunks of 7 (a remainder chunk) and 10 steps at T = 40, with
  the request lifecycle and the control plane on.
* A run stopped at ``stop_at_step`` and resumed from its checkpoints
  equals the uninterrupted run, its series as long as the horizon; an
  empty directory resumes as a cold start.
* A multi-tenant run (two tenants, the tuple of strategy states and of
  accumulators and the (NT, M) queue in the carry): chunked equals
  unchunked, and a run stopped at step 80 and resumed under another
  chunk length equals the uninterrupted one, bit for bit.
"""
import dataclasses
import json
import os
from typing import NamedTuple

import numpy as np
import pytest
import torch

from repro.continuum import simulator as js
from repro.obs import provenance as jprov
from repro_torch.bench import scenarios as tsuite
from repro_torch.checkpoint import (SCHEMA_VERSION, CheckpointCorruptError,
                                    Checkpointer, config_hash)
from repro_torch.continuum import library as tlib
from repro_torch.continuum import scenarios as tscn
from repro_torch.continuum import simulator as ts
from repro_torch.continuum import topology as ttopo
from repro_torch.continuum.control import ControlConfig
from repro_torch.continuum.tenancy import TenancyConfig

K, M, STANDBY = 12, 4, 2
CFG = ts.SimConfig(max_clients=4, ring=16, horizon=4.0, **tsuite.CONTROL_RES,
                   control=ControlConfig(
                       managed=STANDBY, warmup=0.5, up_queue=2.0,
                       down_queue=0.3, hold=0.3, action_cooldown=1.0,
                       admit=True, target_queue=3.0, regions=2,
                       mig_threshold=2.0))
WARM = 5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors: one intra-op thread is faster than many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Pair(NamedTuple):
    a: torch.Tensor
    b: object


@pytest.fixture
def tree():
    g = torch.Generator().manual_seed(0)
    return {"carry": (Pair(torch.rand(3, 4, generator=g),
                           torch.arange(5, dtype=torch.int32)),
                      torch.rand(2, generator=g) < 0.5, None,
                      Pair(torch.zeros(0), None)),
            "series": np.arange(7, dtype=np.float32)}


def assert_same_tree(a, b):
    if a is None:
        assert b is None
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_same_tree(a[k], b[k])
    elif isinstance(a, tuple):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_same_tree(x, y)
    elif isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype
        assert torch.equal(a, b)
    else:
        np.testing.assert_array_equal(b, a)
        assert np.asarray(b).dtype == np.asarray(a).dtype


def test_roundtrip_async_keep_and_steps(tmp_path, tree):
    ck = Checkpointer(str(tmp_path), keep=2)
    for step in (10, 20, 30):
        ck.save(step, tree, blocking=False, meta={"step": step})
    ck.wait()
    assert ck.all_steps() == [20, 30] and ck.latest_step() == 30
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]
    got, step = ck.restore(tree)
    assert step == 30
    assert_same_tree(tree, got)
    manifest = ck.verify(20)
    assert manifest["schema"] == SCHEMA_VERSION == 2
    assert manifest["checksum"].startswith("sha256:")
    assert manifest["meta"] == {"step": 20}
    assert manifest["keys"]["carry/0/a"] == {"shape": [3, 4],
                                             "dtype": "float32"}
    _, step = ck.restore(tree, step=20)
    assert step == 20
    # the snapshot is taken at save time: later writes do not leak in
    tree["carry"][0].a.add_(1.0)
    got, _ = ck.restore(tree)
    assert not torch.equal(got["carry"][0].a, tree["carry"][0].a)
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(tree)


def _npz(ck, step):
    return os.path.join(ck.dir, f"step_{step:08d}", "arrays.npz")


@pytest.mark.parametrize("damage", ["flip", "truncate", "manifest",
                                    "schema"])
def test_corrupt_checkpoints_are_refused(tmp_path, tree, damage):
    ck = Checkpointer(str(tmp_path))
    ck.save(5, tree)
    path = _npz(ck, 5)
    manifest = os.path.join(os.path.dirname(path), "manifest.json")
    if damage == "flip":
        data = bytearray(open(path, "rb").read())
        data[len(data) // 2] ^= 0x01
        open(path, "wb").write(bytes(data))
    elif damage == "truncate":
        data = open(path, "rb").read()
        open(path, "wb").write(data[:len(data) // 3])
    elif damage == "manifest":
        open(manifest, "w").write("{not json")
    else:
        m = json.load(open(manifest))
        m["schema"] = SCHEMA_VERSION + 1
        json.dump(m, open(manifest, "w"))
    with pytest.raises(CheckpointCorruptError):
        ck.restore(tree)


def test_config_hash_is_the_references():
    for tcfg, jcfg in ((ts.SimConfig(horizon=12.0, tau=0.15),
                        js.SimConfig(horizon=12.0, tau=0.15)),
                       ({"b": 2, "a": (1.5, None)},
                        {"b": 2, "a": (1.5, None)})):
        assert config_hash(tcfg) == jprov.config_hash(jcfg)
    assert config_hash(CFG) != config_hash(dataclasses.replace(CFG, tau=0.1))


# ---------------------------------------------------------------------------
# Chunked and resumed runs.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def run_inputs():
    sc = tscn.with_standby(tlib.get_library(CFG.horizon, K, M)["retry_storm"],
                           STANDBY)
    drv = tscn.compile_scenario(sc, CFG, 700, device="cpu")
    rtt = ttopo.make_topology(1, K, M + STANDBY, device="cpu").lb_instance_rtt()
    return rtt, drv


def run(run_inputs, **kw):
    rtt, drv = run_inputs
    return ts.run_sim_stream("qedgeproxy", rtt, CFG, 5, drivers=drv,
                             warmup_steps=WARM, device="cpu", **kw)


def assert_same_run(a, b):
    for part in ("acc", "series", "ctrl"):
        for f in getattr(a, part)._fields:
            assert torch.equal(getattr(getattr(a, part), f),
                               getattr(getattr(b, part), f)), (part, f)


@pytest.fixture(scope="module")
def whole(run_inputs):
    out = run(run_inputs)
    assert CFG.num_steps == 40
    # the run exercises the lifecycle and the controller
    assert out.acc.timeout_k.sum() > 0 and out.ctrl.steps > 0
    return out


@pytest.mark.parametrize("chunk", [7, 10])
def test_chunked_equals_unchunked(run_inputs, whole, chunk):
    assert_same_run(whole, run(run_inputs, chunk_steps=chunk))


def test_stop_and_resume_equals_the_uninterrupted_run(run_inputs, whole,
                                                      tmp_path):
    d = str(tmp_path / "ck")
    part = run(run_inputs, chunk_steps=7, checkpoint_dir=d, stop_at_step=20)
    assert part.series.succ.shape == (21,)          # stopped at step 21
    assert Checkpointer(d).latest_step() == 21
    resumed = run(run_inputs, chunk_steps=7, checkpoint_dir=d, resume=True)
    assert resumed.series.succ.shape == (40,)
    assert_same_run(whole, resumed)
    meta = Checkpointer(d).verify(35)["meta"]
    assert meta == {"config_hash": config_hash(CFG), "horizon_steps": 40}


def test_empty_directory_is_a_cold_start(run_inputs, whole, tmp_path):
    out = run(run_inputs, chunk_steps=10, checkpoint_dir=str(tmp_path / "new"),
              resume=True, checkpoint_every=2)
    assert_same_run(whole, out)
    assert Checkpointer(str(tmp_path / "new")).all_steps() == [20]
    with pytest.raises(ValueError, match="chunked"):
        run(run_inputs, checkpoint_dir=str(tmp_path / "x"))


def assert_same_tenant_run(a, b):
    assert isinstance(a.acc, tuple) and len(a.acc) == len(b.acc)
    for s, (x, y) in enumerate(zip(a.acc, b.acc)):
        for f in x._fields:
            assert torch.equal(getattr(x, f), getattr(y, f)), (s, f)
    for f in a.series._fields:
        assert torch.equal(getattr(a.series, f), getattr(b.series, f)), f


def test_tenant_chunks_and_resume(tmp_path):
    """Chunked = unchunked; stopped at step 80 and resumed under another
    chunk length = uninterrupted, the tenant carry in the checkpoint."""
    cfg = ts.SimConfig(horizon=12.0, tenancy=TenancyConfig(
        taus=(0.080, 0.150), interference=0.3))
    rtt = ttopo.make_topology(2, 10, 4, device="cpu").lb_instance_rtt()
    drv = tscn.tenant_neutral_drivers(cfg, 2, 10, 4, base_clients=1,
                                      device="cpu")
    kw = dict(drivers=drv, warmup_steps=30, device="cpu")
    full = ts.run_sim_stream("qedgeproxy", rtt, cfg, 5, **kw)
    assert tuple(full.series.succ.shape) == (120, 2)
    assert_same_tenant_run(full, ts.run_sim_stream(
        "qedgeproxy", rtt, cfg, 5, chunk_steps=40, **kw))
    d = str(tmp_path / "ck")
    part = ts.run_sim_stream("qedgeproxy", rtt, cfg, 5, chunk_steps=40,
                             checkpoint_dir=d, stop_at_step=80, **kw)
    assert tuple(part.series.succ.shape) == (80, 2)
    assert Checkpointer(d).latest_step() == 80
    res = ts.run_sim_stream("qedgeproxy", rtt, cfg, 5, chunk_steps=25,
                            checkpoint_dir=d, resume=True, **kw)
    assert_same_tenant_run(full, res)
