"""Training on a (data, model) mesh of ranks against one rank, and one
rank against the JAX package: the port's counterpart of the reference's
``test_sharding.py::test_spmd_train_step_8dev_matches_1dev``.

qwen3-4b and qwen3-moe-30b-a3b at ``reduced()`` in float32, the weights
drawn by the reference's ``init`` and carried across (``convert``),
``adamw(1e-3, clip_norm=1.0)``, 3 steps of ``synthetic_batch`` at seq
32 x batch 8. One spawn of 4 gloo CPU ranks (2 x 2: the batch and the
FSDP rows over ``data``; heads, FFN columns, experts and the vocabulary
over ``model``) trains both models, and runs the training launcher's
``--mesh 2x2`` path (the reduced qwen3-4b in its bfloat16).
Tolerances:
- 4 ranks against 1 in float32: ``rtol=1e-4, atol=1e-5``, the
  reference test's;
- 1 rank against the reference's jitted step: ``rtol=1e-5``, as
  ``test_torch_train_step.py`` holds the loss;
- the launcher, bfloat16: ``rtol=1e-3`` (its partial sums over the
  model axis round in bfloat16 in another order; measured 4.9e-5).
"""
import contextlib
import dataclasses
import functools
import io

import jax
import numpy as np
import pytest

from repro import training as JT
from repro.configs import get_config as jax_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.kernels import ops as jops
from repro.models import build_model as jax_build
from repro_torch.configs import ModelConfig
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import model_params_to_torch
from repro_torch.launch import train as launcher
from repro_torch.launch.mesh import make_test_mesh, spawn
from torch_mesh_ranks import call_all, train

ARCHS = ("qwen3-4b", "qwen3-moe-30b-a3b")
SEQ, BATCH, STEPS = 32, 8, 3
SHAPE = ShapeConfig("t", "train", SEQ, BATCH)
LAUNCH = ["--smoke", "--device", "cpu", "--steps", "3", "--seq-len", "32",
          "--batch", "8", "--log-every", "1"]


def jcfg(arch: str):
    return dataclasses.replace(jax_config(arch, reduced=True),
                               dtype="float32")


@functools.cache
def weights(arch: str):
    """(the reduced float32 config as the port's, the reference's initial
    weights as numpy, the port's state dict of them)."""
    cfg = ModelConfig(**dataclasses.asdict(jcfg(arch)))
    params = jax.tree.map(np.asarray,
                          jax_build(jcfg(arch)).init(jax.random.PRNGKey(0)))
    return cfg, params, model_params_to_torch(params, cfg, "cpu").state_dict()


def run(arch: str, mesh=None) -> list:
    cfg, _, state = weights(arch)
    return train(cfg, state, SHAPE, STEPS, mesh)["losses"]


@pytest.fixture(scope="module")
def sharded() -> dict:
    mesh = make_test_mesh(2, 2)
    calls = [(train, (weights(a)[0], weights(a)[2], SHAPE, STEPS, mesh), {})
             for a in ARCHS]
    calls.append((launcher.main, (LAUNCH + ["--mesh", "2x2"],), {}))
    *runs, launched = spawn(call_all, 4, calls, threads=1)
    return {**{a: r["losses"] for a, r in zip(ARCHS, runs)},
            "launcher": launched}


@pytest.mark.parametrize("arch", ARCHS)
def test_four_ranks_match_one_rank(sharded, arch):
    one = run(arch)
    assert np.isfinite(one).all() and one[-1] < one[0]
    np.testing.assert_allclose(sharded[arch], one, rtol=1e-4, atol=1e-5)


def test_the_launcher_on_a_mesh_matches_one_device(sharded):
    with contextlib.redirect_stdout(io.StringIO()):
        one = launcher.main(LAUNCH)
    assert len(one) == STEPS and np.isfinite(one).all()
    np.testing.assert_allclose(sharded["launcher"], one, rtol=1e-3)


def test_one_rank_matches_the_reference():
    _, params, _ = weights("qwen3-4b")
    opt = JT.adamw(1e-3, clip_norm=1.0)
    with jops.mode("ref"):
        jstep = jax.jit(JT.make_train_step(jax_build(jcfg("qwen3-4b")), opt))
        jp, js, want = params, opt.init(params), []
        for s in range(STEPS):
            batch = JT.synthetic_batch(jcfg("qwen3-4b"),
                                       JShapeConfig("t", "train", SEQ, BATCH),
                                       s)
            jp, js, m = jstep(jp, js, batch)
            want.append(float(m["loss"]))
    np.testing.assert_allclose(run("qwen3-4b"), want, rtol=1e-5)
