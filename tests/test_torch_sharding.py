"""The model rules of ``sharding/`` and the model meshes against the JAX
package, on meshes of ranks built from rank arrays (no process group is
needed to read a mesh's axes): the port's counterparts of
``tests/test_sharding.py``'s rule cases, and the ``Model``'s
``param_axes``, ``cache_axes`` and ``input_specs`` leaf for leaf against
the reference's for every config at ``reduced()``. The reference stacks
its layers on leading ``layers`` (and ``groups``) axes; the port keeps a
module a layer, so its weights' axes are the reference's without those
(``convert``'s mapping of the stacks)."""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from repro.configs import get_config as jax_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.models import build_model as jax_build
from repro.sharding import DEFAULT_RULES as JRULES
from repro.sharding import logical_to_spec as jax_spec
from repro.sharding.partitioning import is_axes_leaf as jax_is_axes_leaf
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import _STACKS
from repro_torch.launch.mesh import (Mesh, make_continuum_mesh,
                                     make_production_mesh, make_test_mesh)
from repro_torch.models import build_model
from repro_torch.sharding import (DEFAULT_RULES, Sharding, constrain,
                                  current_mesh, is_axes_leaf,
                                  logical_to_spec, rule_overrides,
                                  tree_shardings)
from repro_torch.training.optimizer import AdamWState

MESHES = {
    "data_model": (("data", "model"), (2, 2)),
    "pod_data_model": (("pod", "data", "model"), (2, 2, 2)),
    "continuum": (("data", "players"), (2, 2)),
}
# every logical name alone, then specs where names contend for a mesh axis
SPECS = [(name,) for name in JRULES] + [
    ("batch", "kv_batch", None), ("heads", "kv_heads"), ("vocab", "ffn"),
    ("experts", "embed_fsdp", None), ("batch", None, "vocab"),
    ("grid", "players", "arms"), ("ctx", "batch"), (None, "embed")]


def meshes(kind: str):
    """(the port's mesh of ranks, the reference's mesh of one device a
    axis) with the same axis names."""
    names, shape = MESHES[kind]
    devs = np.asarray(jax.devices()[:1]).reshape((1,) * len(names))
    return Mesh(np.arange(np.prod(shape)).reshape(shape), names), \
        JMesh(devs, names)


def test_the_rule_table_is_the_references():
    assert DEFAULT_RULES == JRULES


@pytest.mark.parametrize("kind", MESHES)
def test_logical_to_spec_is_the_references(kind):
    mesh, jmesh = meshes(kind)
    for spec in SPECS:
        assert logical_to_spec(spec, mesh) == tuple(jax_spec(spec, jmesh)), \
            spec
    assert logical_to_spec(("batch",), None) == (None,)


def test_pod_axis_dropped_on_single_pod_mesh():
    mesh = make_test_mesh(2, 2)
    assert logical_to_spec(("batch",), mesh) == ("data",)
    assert logical_to_spec(("batch",), make_test_mesh(2, 2, pod=2)) == (
        ("pod", "data"),)


def test_rule_overrides_scoped():
    mesh = make_test_mesh(1, 1)
    with rule_overrides(batch=()):
        assert logical_to_spec(("batch",), mesh) == (None,)
    assert logical_to_spec(("batch",), mesh) == ("data",)


def test_is_axes_leaf():
    cases = [("a", None), (), {"x": ("a",)}, (("a",), ("b",)),
             ["a"], ("a", 1)]
    for x in cases:
        assert is_axes_leaf(x) == jax_is_axes_leaf(x), x
    assert not is_axes_leaf(AdamWState(step=(), m={}, v={}))


def test_meshes_and_the_active_mesh():
    mesh = make_test_mesh(2, 4)
    assert mesh.shape == {"data": 2, "model": 4}
    assert make_test_mesh(2, 2, pod=2).shape == {"pod": 2, "data": 2,
                                                 "model": 2}
    assert make_continuum_mesh(2, devices=4).shape == {"data": 2,
                                                       "players": 2}
    with pytest.raises(ValueError, match="256 ranks"):
        make_production_mesh()                 # a world of one rank
    with pytest.raises(ValueError, match="512 ranks"):
        make_production_mesh(multi_pod=True)
    assert current_mesh() is None
    with mesh:
        assert current_mesh() is mesh
        with make_test_mesh(1, 1) as inner:
            assert current_mesh() is inner
        assert current_mesh() is mesh
    assert current_mesh() is None


def test_constrain_leaves_plain_tensors_and_tree_shardings_follow_axes():
    x = torch.ones(4, 4)
    assert constrain(x, "batch", None) is x                  # off a mesh
    mesh = make_test_mesh(2, 2)
    with mesh:
        assert constrain(x, "batch", "vocab") is x           # not placed
    axes = {"w": ("embed_fsdp", "heads"), "b": ("heads",), "n": (None,)}
    tree = tree_shardings(AdamWState(step=(), m=axes, v=axes), mesh)
    assert tree.step == Sharding(mesh, ())
    assert tree.m["w"] == Sharding(mesh, ("data", "model"))
    assert tree.v["n"].spec == (None,)
    assert tree.m["w"].local_shape((64, 8)) == (32, 4)
    with pytest.raises(ValueError, match="does not split"):
        tree.m["b"].local_shape((3,))
    with pytest.raises(ValueError, match="no active mesh"):
        tree_shardings(axes)


def _reference_leaves(tree) -> dict:
    """``{path without layer indices: axes without stacking axes}`` of
    the reference's axes tree."""
    out = {}
    flat = jax.tree_util.tree_flatten_with_path(tree,
                                                is_leaf=jax_is_axes_leaf)[0]
    for path, axes in flat:
        keys = tuple(p.key for p in path)
        out[keys] = tuple(axes)[_STACKS.get(keys[0], 0):]
    return out


def _spec_of(x) -> tuple:
    return tuple(x.shape), str(x.dtype)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_axes_and_specs_are_the_references(arch):
    jm = jax_build(jax_config(arch, reduced=True))
    m = build_model(get_config(arch, reduced=True), "cpu")
    got = {}
    for name, axes in m.param_axes().items():
        key = tuple(p for p in name.split(".")[1:] if not p.isdigit())
        assert got.setdefault(key, axes) == axes, name   # alike per layer
    assert got == _reference_leaves(jm.param_axes())
    assert set(m.param_axes()) == {n for n, _ in m.named_parameters()}
    want = jm.cache_axes()
    assert m.cache_axes() == (want if isinstance(want, dict)
                              else {"layers": want})      # Whisper's tuple
    for kind in ("train", "prefill", "decode"):
        specs, axes = m.input_specs(ShapeConfig("t", kind, 64, 4))
        jspecs, jaxes = jm.input_specs(JShapeConfig("t", kind, 64, 4))
        assert axes == jaxes
        assert {k: (tuple(s), str(d).removeprefix("torch."))
                for k, (s, d) in specs.items()} == {
            k: _spec_of(v) for k, v in jspecs.items()}
