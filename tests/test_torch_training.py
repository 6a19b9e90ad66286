"""The port's training substrate on the CPU against the JAX package:
the schedule, global-norm clipping, one AdamW update, int8 gradient
compression, the synthetic batches and the shape cells (the reference's
``tests/test_training.py`` cases and the data and shapes they rest on).

Both packages get the same numpy-seeded inputs; the JAX side runs in
ops mode ``"ref"``, as the reference's own tests run it. Tolerances:
- exact: int8 compression (both divide, round half to even and scale in
  float32), the batches (the same numpy draws), the shape cells;
- float32 ``rtol=1e-6``: the schedule (torch's and XLA's float32 ``cos``
  may part by an ULP), the global norm (leaf sums added in another
  order), and one AdamW update (moments and parameters an ULP or two
  apart where XLA contracts ``b * m + (1 - b) * g`` into an FMA), with
  ``atol=1e-9`` for values near 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.kernels import ops as jops
from repro.training import adamw as jadamw
from repro.training import clip_by_global_norm as jclip
from repro.training import cosine_schedule as jcosine
from repro.training import global_norm as jglobal_norm
from repro.training import int8_compress as jint8
from repro.training import synthetic_batch as jbatch
from repro.training.optimizer import AdamWState as JAdamWState
from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.training import (AdamWState, adamw, clip_by_global_norm,
                                  cosine_schedule, global_norm, int8_compress,
                                  prefetch_iterator, synthetic_batch)

F32 = dict(rtol=1e-6, atol=1e-9)


@pytest.fixture(autouse=True)
def ref_kernels():
    with jops.mode("ref"):
        yield


def tree(seed: int, scale: float = 1.0) -> dict:
    """float32 leaves of three shapes, keys in sorted order (the
    reference's leaf order)."""
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.standard_normal(shape)).astype(np.float32)
            for k, shape in (("a", (7, 5)), ("b", (33,)), ("c", (4, 3, 2)))}


def to_torch(t: dict) -> dict:
    return {k: torch.from_numpy(v.copy()) for k, v in t.items()}


def to_jax(t: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in t.items()}


@pytest.mark.parametrize("base_lr,warmup,total", [(1e-3, 10, 100),
                                                  (3e-4, 20, 30)])
def test_cosine_schedule_every_step(base_lr, warmup, total):
    lr, jlr = cosine_schedule(base_lr, warmup, total), jcosine(base_lr, warmup,
                                                               total)
    got = np.array([float(lr(torch.tensor(s, dtype=torch.int32)))
                    for s in range(total + 5)], np.float32)
    want = np.array([float(jlr(jnp.int32(s))) for s in range(total + 5)],
                    np.float32)
    np.testing.assert_allclose(got, want, **F32)
    assert got[0] == 0.0 and got[warmup] == pytest.approx(base_lr)


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_global_norm_and_clip_by_global_norm(max_norm):
    t = tree(0, scale=2.0)
    norm = global_norm(to_torch(t))
    np.testing.assert_allclose(float(norm), float(jglobal_norm(to_jax(t))),
                               **F32)
    clipped, norm2 = clip_by_global_norm(to_torch(t), max_norm)
    jclipped, jnorm = jclip(to_jax(t), max_norm)
    assert float(norm2) == float(norm)
    for k in t:
        np.testing.assert_allclose(clipped[k].numpy(),
                                   np.asarray(jclipped[k]), **F32)
    assert float(global_norm(clipped)) == pytest.approx(
        min(max_norm, float(norm)), rel=1e-5)


@pytest.mark.parametrize("clip_norm", [1.0, None])
def test_one_adamw_update_matches_the_reference(clip_norm):
    params, grads = tree(1, 0.1), tree(2, 3.0)
    m = tree(3, 0.01)
    v = {k: np.abs(x) for k, x in tree(4, 1e-4).items()}
    kw = dict(clip_norm=clip_norm)
    opt = adamw(cosine_schedule(3e-4, 20, 30), **kw)
    jopt = jadamw(jcosine(3e-4, 20, 30), **kw)
    state = AdamWState(step=torch.tensor(4, dtype=torch.int32),
                       m=to_torch(m), v=to_torch(v))
    jstate = JAdamWState(step=jnp.int32(4), m=to_jax(m), v=to_jax(v))
    p = to_torch(params)
    new_p, new_state = opt.update(to_torch(grads), state, p)
    jp, jstate = jopt.update(to_jax(grads), jstate, to_jax(params))
    assert new_p is p and int(new_state.step) == int(jstate.step) == 5
    for k in params:
        np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]), **F32)
        np.testing.assert_allclose(new_state.m[k].numpy(),
                                   np.asarray(jstate.m[k]), **F32)
        np.testing.assert_allclose(new_state.v[k].numpy(),
                                   np.asarray(jstate.v[k]), **F32)
        assert not np.array_equal(p[k].numpy(), params[k])   # it moved


def test_adamw_reduces_quadratic():
    opt = adamw(1e-1, weight_decay=0.0, clip_norm=None)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt.init(params)
    for _ in range(200):
        params, state = opt.update({"w": 2 * params["w"]}, state, params)
    assert float(params["w"].abs().max()) < 1e-2


def test_int8_compress_is_the_references_bit_for_bit():
    rng = np.random.default_rng(0)
    g = {"w": rng.normal(0, 0.01, (256, 64)).astype(np.float32),
         "b": np.array([0.5, -1.5, 2.5, 127.0, -127.0, 0.0], np.float32),
         "z": np.zeros(5, np.float32)}
    got = int8_compress(to_torch(g))
    want = jint8(to_jax(g))
    for k in g:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    rel = float((got["w"] - torch.from_numpy(g["w"])).abs().max()
                / np.abs(g["w"]).max())
    assert rel < 1.0 / 127 + 1e-3


@pytest.mark.parametrize("arch", ["qwen3-4b", "internvl2-1b",
                                  "whisper-tiny"])
@pytest.mark.parametrize("step", [0, 5])
def test_synthetic_batch_equals_the_references(arch, step):
    cfg = configs.get_config(arch, reduced=True)
    jcfg = jconfigs.get_config(arch, reduced=True)
    got = synthetic_batch(cfg, ShapeConfig("t", "train", 64, 2), step, "cpu")
    want = jbatch(jcfg, JShapeConfig("t", "train", 64, 2), step)
    assert got.keys() == want.keys()
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == getattr(torch, str(w.dtype))
        np.testing.assert_array_equal(got[k].numpy(), w)


def test_prefetch_iterator_yields_the_steps_in_order():
    cfg = configs.get_config("qwen3-4b", reduced=True)
    shape = ShapeConfig("t", "train", 16, 2)
    it = prefetch_iterator(cfg, shape, "cpu")
    for step in range(3):
        got = next(it)
        want = synthetic_batch(cfg, shape, step, "cpu")
        assert all(torch.equal(got[k], want[k]) for k in want)
    it.close()


def test_shape_cells_equal_the_references():
    assert configs.SHAPES.keys() == jconfigs.SHAPES.keys()
    assert configs.LONG_CONTEXT_ARCHS == jconfigs.LONG_CONTEXT_ARCHS
    for name, shape in configs.SHAPES.items():
        jshape = jconfigs.SHAPES[name]
        for reduced in (False, True):
            a = configs.get_shape(name, reduced=reduced)
            b = jconfigs.get_shape(name, reduced=reduced)
            assert (a.name, a.kind, a.seq_len, a.global_batch) == (
                b.name, b.kind, b.seq_len, b.global_batch)
        for arch in configs.ARCH_NAMES:
            assert configs.shape_applicable(
                configs.get_config(arch), shape) == jconfigs.shape_applicable(
                    jconfigs.get_config(arch), jshape)
