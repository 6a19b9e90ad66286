"""The port's model loss, gradients and train step on the CPU against the
JAX package, and the training launcher's checkpoint and resume.

The port runs on ``device="cpu"`` (the kernels' plain versions, their
autograd PyTorch's); the JAX side in ops mode ``"ref"``, compiled with
``jax.jit``, weights carried across by ``convert.model_params_to_torch``
and back by ``convert.model_params_to_numpy`` / ``named_to_numpy``;
every family at its ``reduced()`` widths in float32, on the reference's
``synthetic_batch``. Tolerances (float32 sums in another order):
- the loss to ``rtol=1e-5`` (measured <= 2.4e-7 relative, every family);
- each gradient leaf to ``atol = 1e-5 x`` its largest element (measured
  <= 7.6e-7 x, remat on or off);
- the AdamW moments after a step to ``atol = 1e-5 x`` the leaf's largest
  (they carry the gradients' error); parameters after AdamW steps to
  ``rtol=1e-6`` plus ``atol = lr / 20`` of that step's learning rate
  (``LR_1`` the first's): an element whose gradient lies
  within a few float32 roundings of zero (~1e-8, AdamW's eps) takes a
  step anywhere between 0 and lr, so the two packages may part there by
  up to lr (measured: lr / 150).
"""
import dataclasses
import shutil

import jax
import numpy as np
import pytest
import torch

from repro import training as JT
from repro.configs import get_config as jax_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.kernels import ops as jops
from repro.models import build_model as jax_build
from repro_torch import training as TT
from repro_torch.configs import ARCH_NAMES, ModelConfig
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import (adamw_state_to_numpy, adamw_state_to_torch,
                                 model_params_to_numpy, model_params_to_torch,
                                 named_to_numpy)
from repro_torch.launch import train

LR, WARMUP = 3e-3, 5
LR_1 = LR / WARMUP             # the first step's learning rate


@pytest.fixture(autouse=True)
def ref_kernels():
    with jops.mode("ref"):
        yield


def pair(arch: str = "qwen3-4b"):
    """(JAX config, JAX model, its params, the port's trainable model with
    the same weights), the reduced config in float32."""
    jcfg = dataclasses.replace(jax_config(arch, reduced=True),
                               dtype="float32")
    jm = jax_build(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    tm = model_params_to_torch(jax.tree.map(np.asarray, params), cfg, "cpu")
    return jcfg, jm, params, tm.trainable()


def jbatch(jcfg, step: int, S: int = 32, B: int = 2) -> dict:
    return JT.synthetic_batch(jcfg, JShapeConfig("t", "train", S, B), step)


def tbatch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def leaves(tree: dict) -> dict:
    """``{"a/b": array}`` of a nested dict."""
    out = {}
    for path, x in jax.tree_util.tree_leaves_with_path(tree):
        out["/".join(p.key for p in path)] = np.asarray(x)
    return out


def assert_tree_close(got: dict, want: dict, atol_of, rtol: float = 0.0):
    got, want = leaves(got), leaves(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=atol_of(w),
                                   err_msg=k)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_loss_every_family_matches_the_reference(arch):
    jcfg, jm, params, tm = pair(arch)
    b = jbatch(jcfg, 3)
    want = float(jax.jit(lambda p, b: jm.loss(p, b, remat=True))(params, b))
    got = tm.loss(tbatch(b)).detach()
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)


@pytest.mark.parametrize("remat", [True, False])
def test_dense_gradients_match_jax_value_and_grad(remat):
    jcfg, jm, params, tm = pair()
    b = jbatch(jcfg, 3)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, b, remat=True)))(params)
    named = dict(tm.named_parameters())
    loss = tm.loss(tbatch(b), remat=remat)
    grads = torch.autograd.grad(loss, list(named.values()))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert_tree_close(named_to_numpy(dict(zip(named, grads))),
                      jax.tree.map(np.asarray, jgrads),
                      lambda w: 1e-5 * np.abs(w).max())


def test_remat_recomputes_the_same_gradients():
    _, _, _, tm = pair()
    b = tbatch(jbatch(jax_config("qwen3-4b", reduced=True), 1))
    named = list(tm.parameters())
    on = torch.autograd.grad(tm.loss(b, remat=True), named)
    off = torch.autograd.grad(tm.loss(b, remat=False), named)
    assert all(torch.equal(x, y) for x, y in zip(on, off))


def run_port(tm, jcfg, steps: int, accum: int = 1, B: int = 4) -> list:
    opt = TT.adamw(TT.cosine_schedule(LR, WARMUP, 10))
    step_fn = TT.make_train_step(tm, opt, accum_steps=accum)
    params = dict(tm.named_parameters())
    state = opt.init(params)
    losses = []
    for s in range(steps):
        params, state, m = step_fn(params, state,
                                   tbatch(jbatch(jcfg, s, B=B)))
        losses.append(float(m["loss"]))
    return losses


def test_train_step_matches_the_reference():
    # one reference step first, so that the port takes over non-zero
    # moments and a step count through convert; then one step each
    jcfg, jm, params, tm = pair()
    jopt = JT.adamw(JT.cosine_schedule(LR, WARMUP, 10))
    jstep = jax.jit(JT.make_train_step(jm, jopt))
    params, jstate, _ = jstep(params, jopt.init(params), jbatch(jcfg, 0, B=4))
    params, jstate = jax.tree.map(np.asarray, (params, jstate))
    tm = model_params_to_torch(params, tm.cfg, "cpu").trainable()
    state = adamw_state_to_torch(jstate, tm, "cpu")
    back = adamw_state_to_numpy(state)
    assert int(back.step) == int(jstate.step) == 1
    for got, want in ((back.m, jstate.m), (back.v, jstate.v)):
        assert_tree_close(got, want, lambda w: 0.0)          # bit for bit
    opt = TT.adamw(TT.cosine_schedule(LR, WARMUP, 10))
    _, state, m = TT.make_train_step(tm, opt)(
        dict(tm.named_parameters()), state, tbatch(jbatch(jcfg, 1, B=4)))
    params, jstate, jm_ = jstep(params, jstate, jbatch(jcfg, 1, B=4))
    np.testing.assert_allclose(float(m["loss"]), float(jm_["loss"]),
                               rtol=1e-5)
    assert_tree_close(model_params_to_numpy(tm),
                      jax.tree.map(np.asarray, params),
                      lambda w: 2 * LR_1 / 20, rtol=1e-6)   # lr_2 = 2 lr_1
    back, jstate = adamw_state_to_numpy(state), jax.tree.map(np.asarray,
                                                             jstate)
    assert int(back.step) == 2
    for got, want in ((back.m, jstate.m), (back.v, jstate.v)):
        assert_tree_close(got, want, lambda w: 1e-5 * np.abs(w).max())


def test_accumulation_over_two_microbatches_equals_one_batch():
    jcfg, _, _, tm = pair()
    _, _, _, tm2 = pair()
    one = run_port(tm, jcfg, 3, accum=1)
    two = run_port(tm2, jcfg, 3, accum=2)
    np.testing.assert_allclose(two, one, rtol=1e-5)
    assert_tree_close(model_params_to_numpy(tm2), model_params_to_numpy(tm),
                      lambda w: LR_1 / 20, rtol=1e-6)


def test_loss_falls_on_the_learnable_stream():
    jcfg, _, _, tm = pair()
    opt = TT.adamw(TT.cosine_schedule(LR, WARMUP, 25))
    step_fn = TT.make_train_step(tm, opt)
    params = dict(tm.named_parameters())
    state = opt.init(params)
    cfg = tm.cfg
    losses = []
    for s in range(25):
        batch = TT.synthetic_batch(cfg, ShapeConfig("t", "train", 64, 8), s,
                                   "cpu")
        params, state, m = step_fn(params, state, batch)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < losses[0] - 0.5, losses


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_every_family_takes_a_train_step(arch):
    # every weight gets a finite gradient (none unused) and moves
    _, _, _, tm = pair(arch)
    opt = TT.adamw(TT.cosine_schedule(LR, WARMUP, 10))
    params = dict(tm.named_parameters())
    before = {k: p.detach().clone() for k, p in params.items()}
    batch = TT.synthetic_batch(tm.cfg, ShapeConfig("t", "train", 32, 2), 0,
                               "cpu")
    grads = torch.autograd.grad(tm.loss(batch), list(params.values()))
    assert all(torch.isfinite(g).all() for g in grads)
    TT.make_train_step(tm, opt)(params, opt.init(params), batch)
    assert all(not torch.equal(p, before[k]) for k, p in params.items())


def test_launcher_resumes_bit_equal(tmp_path):
    argv = ["--smoke", "--device", "cpu", "--steps", "6", "--seq-len", "32",
            "--batch", "2", "--log-every", "1", "--ckpt-every", "3",
            "--ckpt-dir", str(tmp_path)]
    whole = train.main(argv)
    assert len(whole) == 6 and np.isfinite(whole).all()
    shutil.rmtree(tmp_path / "step_00000006")       # interrupted after 3
    resumed = train.main(argv + ["--resume"])
    assert resumed == whole[3:]


def test_train_100m_config_is_the_references():
    from repro.launch.train import train_100m_config as jax_100m
    got, want = train.train_100m_config(), jax_100m()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.head_dim == 80
