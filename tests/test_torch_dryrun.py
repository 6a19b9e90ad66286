"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's pure pieces, and traced cells on a fake process group.

- ``sharding.fit_spec`` and ``sharding.rules_for`` (every decode layout)
  equal the reference dry run's ``_fit_spec`` and ``_rules_for`` for
  every arch, shape and production mesh, and so do the
  per-rank bytes of the weights' blocks on the pod (the two-pod mesh
  adds a ``pod`` axis that no weight's rule names). The reference's functions are
  called with a JAX ``AbstractMesh``; its module is imported only after
  ``jax.devices()`` has fixed this process's device count (its import
  sets ``XLA_FLAGS`` for 512 host devices), and ``XLA_FLAGS`` is put
  back at once, so later processes do not inherit it.
- One cell of each shape kind, at ``reduced()`` on a fake group of 8
  ranks (2 x 4), traces with ``status: "ok"`` and positive terms; the
  secant extrapolation agrees with the traced count within 2 %.
"""
import functools
import os

import jax
import numpy as np
import pytest
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.sharding import logical_to_spec as jax_spec
from repro.sharding import rule_overrides as jax_rules
from repro_torch.configs import ARCH_NAMES, SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh
from repro_torch.sharding import fit_spec, rule_overrides, rules_for

MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
LAYOUTS = ("hybrid", "batchmodel", "plain")


@functools.cache
def jdry():
    """The reference's dry-run module, imported with ``XLA_FLAGS`` put
    back (the module docstring)."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as mod
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return mod


def meshes(name: str):
    shape, axes = MESHES[name]
    return (Mesh(np.arange(int(np.prod(shape))).reshape(shape), axes),
            AbstractMesh(shape, axes))


@functools.cache
def jax_params(arch: str):
    model = jax_build(jax_config(arch))
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    return shapes, model.param_axes()


def reference_param_bytes(arch, shape, jmesh) -> int:
    """The reference's per-device bytes of the weights (its
    ``_device_bytes`` of ``_sharded_sds``: float32 leaves served as
    bfloat16), from the fitted specs."""
    from repro.sharding.partitioning import is_axes_leaf
    mod = jdry()
    shapes, axes = jax_params(arch)
    with jax_rules(**mod._rules_for(jax_config(arch), shape, jmesh)):
        specs = jax.tree.map(
            lambda sds, ax: mod._fit_spec(sds.shape, jax_spec(ax, jmesh),
                                          jmesh),
            shapes, axes, is_leaf=is_axes_leaf)
    total = 0
    for sds, spec in zip(jax.tree.leaves(shapes), jax.tree.leaves(
            specs, is_leaf=lambda x: hasattr(x, "_partitions")
            or type(x).__name__ == "PartitionSpec")):
        item = sds.dtype.itemsize
        if shape.kind != "train" and sds.dtype == np.float32:
            item = 2
        n = 1
        for dim, entry in zip(sds.shape, tuple(spec) + (None,) * 8):
            axes_ = () if entry is None else (
                (entry,) if isinstance(entry, str) else entry)
            n *= dim // int(np.prod([jmesh.shape[a] for a in axes_]))
        total += n * item
    return total


@functools.cache
def port_model(arch: str):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models import build_model
    with FakeTensorMode(allow_non_fake_inputs=True):
        return build_model(get_config(arch), device="cpu")


def test_fit_spec_matches_the_reference():
    from jax.sharding import PartitionSpec as P
    mod = jdry()
    mesh, jmesh = meshes("pod2x16x16")
    cases = [((8, 128), (("data", "model"), None)),
             ((96, 40), ("model", ("pod", "data"))),
             ((3, 1024, 6), (None, ("pod", "data", "model"), "model")),
             ((64,), (("pod", "model"),))]
    for shape, spec in cases:
        want = tuple(mod._fit_spec(shape, P(*spec), jmesh))
        got = fit_spec(shape, spec, mesh)
        assert got == want + (None,) * (len(got) - len(want)), (shape, spec)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_rules_and_weight_bytes_match_the_reference(arch, monkeypatch):
    mod = jdry()
    cfg, jcfg = get_config(arch), jax_config(arch)
    model = port_model(arch)
    for name in MESHES:
        mesh, jmesh = meshes(name)
        for shape in SHAPES.values():
            for layout in LAYOUTS:
                monkeypatch.setenv("REPRO_DECODE_LAYOUT", layout)
                got = rules_for(cfg, shape, mesh)
                assert got == mod._rules_for(jcfg, shape, jmesh), \
                    (name, shape.name, layout)
        # the weights' specs follow embed_fsdp alone, their bytes the kind;
        # the pods' mesh splits them as the pod's
        for shape in ((SHAPES["train_4k"], SHAPES["decode_32k"])
                      if name == "pod16x16" else ()):
            with rule_overrides(**rules_for(cfg, shape, mesh)):
                got = dryrun.param_bytes_per_device(
                    model, mesh, 4 if shape.kind == "train" else 2)
            assert got == reference_param_bytes(arch, shape, jmesh), \
                (name, shape.name)


@pytest.fixture(scope="module")
def fake_group():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("shape", ("train_4k", "prefill_32k", "decode_32k"))
def test_a_traced_cell_of_each_kind(fake_group, shape):
    r = dryrun.run_cell("qwen3-4b", shape, False, mesh_shape=(2, 4),
                        reduced=True)
    assert r["status"] == "ok" and r["mesh"] == "mesh2x4"
    terms = r["roofline"]
    for k in ("compute_s", "memory_s", "collective_s", "bound_s",
              "useful_flops_ratio"):
        assert terms[k] > 0, k
    assert r["memory"]["static_arg_bytes_per_device"] > 0
    assert r["collectives"]["total_bytes"] > 0
    kernel = "decode_attention" if shape == "decode_32k" else "flash_attention"
    assert r["cost"]["kernel_calls"][kernel] > 0


def test_the_secant_count_agrees_with_the_traced_one(fake_group):
    r = dryrun.run_cell_secant("qwen3-4b", "decode_32k", False,
                               mesh_shape=(2, 4), reduced=True)
    assert abs(r["secant"]["flops_gap"]) < 0.02
    assert abs(r["secant"]["bytes_gap"]) < 0.02
