"""Logical-axis partitioning: one rule table maps model-level axis names
to the mesh axes that split them; models name their dims logically and
stay mesh-agnostic.

Port of ``repro/sharding/partitioning.py``. Mesh axes
(``launch/mesh.py``):

  single pod : ("data", "model")            16 x 16 = 256 ranks
  multi-pod  : ("pod", "data", "model")     2 x 16 x 16 = 512 ranks
  continuum  : ("data", "players")          the simulator's meshes

Default rules:
  batch    -> ("pod", "data")   data parallel across pods and the data axis
  seq      -> None              (context parallelism opts in via "ctx")
  ctx      -> ("data",)         long-context KV sequence sharding
  heads    -> ("model",)        tensor parallel attention
  kv_heads -> ("model",)
  ffn      -> ("model",)        tensor parallel MLP
  experts  -> ("model",)        expert parallel MoE
  vocab    -> ("model",)        sharded embedding / unembedding
  embed    -> None | ("data",)  FSDP: weight d_model rows over data axis
  layers, conv, state, head_dim -> None
  players  -> ("players",)      the K load balancers of one simulation
  grid     -> ("data",)         the independent lanes of a grid

Rules are a context-managed global; mesh axes absent from a mesh are
dropped, so the same model code runs on every mesh.

A mesh here is a grid of ``torch.distributed`` ranks, each holding its
block of every tensor (the reference's arrays are global and GSPMD
places them). So a ``Sharding`` (the port's ``NamedSharding``) says
which block a rank holds, and a tensor placed by one carries it as its
``sharding`` attribute (``place``, ``sharding_of``): checkpoints gather
such tensors, the optimizer sums their norms across the axes that split
them, and the model gathers FSDP-split weights before use
(``sharding.collectives``). The model's activations are plain local
tensors whose collectives are explicit at the reference's ``constrain``
points (``sharding.collectives``), so ``constrain`` is the identity on
them; it moves a placed tensor to another spec.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

Rules = Dict[str, Tuple[str, ...]]

DEFAULT_RULES: Rules = {
    "batch": ("pod", "data"),
    "seq": (),
    "ctx": ("data",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "ffn": ("model",),
    "experts": ("model",),
    "expert_cap": (),
    "vocab": ("model",),
    "embed": (),
    "embed_fsdp": ("data",),
    "layers": (),
    "groups": (),
    "head_dim": (),
    "state": (),
    "conv": (),
    # player axis K inside one continuum simulation: bandit state
    # (rings, weights, KDE stats) splits over the mesh's players axis
    "players": ("players",),
    "arms": (),
    # evaluation-grid lanes: independent simulations over the data axis
    "grid": ("data",),
    # decode KV-cache batch axis: the activation batch's by default
    "kv_batch": ("pod", "data"),
}

_rules: Rules = dict(DEFAULT_RULES)
_meshes: list = []          # the ``with mesh:`` stack, innermost last


def set_rules(rules: Rules) -> None:
    global _rules
    _rules = dict(DEFAULT_RULES)
    _rules.update(rules)


def get_rules() -> Rules:
    return dict(_rules)


@contextlib.contextmanager
def rule_overrides(**overrides: Tuple[str, ...]):
    global _rules
    old = dict(_rules)
    _rules.update(overrides)
    try:
        yield
    finally:
        _rules = old


def push_mesh(mesh) -> None:
    """Make ``mesh`` the active mesh (``Mesh.__enter__``)."""
    _meshes.append(mesh)


def pop_mesh() -> None:
    _meshes.pop()


def current_mesh():
    """The mesh of the innermost ``with mesh:``, or None."""
    return _meshes[-1] if _meshes else None


def logical_to_spec(logical: Sequence[Optional[str]], mesh=None) -> tuple:
    """For each tensor dim, the mesh axis that splits it: ``None`` (not
    split), an axis name, or a tuple of names; ``mesh`` defaults to the
    active one. Logical names resolve through the rule table; mesh axes
    absent from the mesh are dropped, and a mesh axis splits at most one
    dim (the first to claim it)."""
    mesh = mesh if mesh is not None else current_mesh()
    names = set(mesh.axis_names) if mesh is not None else set()
    spec = []
    used: set = set()
    for ax in logical:
        if ax is None:
            spec.append(None)
            continue
        kept = tuple(a for a in _rules.get(ax, ())
                     if a in names and a not in used)
        used.update(kept)
        spec.append(None if not kept else kept[0] if len(kept) == 1
                    else kept)
    return tuple(spec)


def spec_axes(entry) -> tuple:
    """One spec entry's mesh axes as a tuple (``()`` for None)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def mesh_axes(logical: str, mesh=None) -> tuple:
    """The axes of ``mesh`` (default the active one) that split the
    logical axis ``logical``: ``()`` off a mesh."""
    return spec_axes(logical_to_spec((logical,), mesh)[0])


def fit_spec(shape: Sequence[int], spec: tuple, mesh) -> tuple:
    """``spec`` with, for each dim, the innermost mesh axes dropped until
    the rest divide the dim (the reference dry run's ``_fit_spec``)."""
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = list(spec_axes(entry))
        while axes and dim % mesh.ways(tuple(axes)):
            axes.pop()            # drop the innermost axis and retry
        out.append(None if not axes else axes[0] if len(axes) == 1
                   else tuple(axes))
    return tuple(out)


def rules_for(cfg, shape, mesh, layout: str | None = None) -> dict:
    """The logical-axis rule overrides of a (config, ``ShapeConfig``,
    mesh) cell, as the reference dry run's ``_rules_for``: FSDP rows over
    ``data`` where the config asks; the batch over the batch axes where
    it divides them, and then for a decode the layout ``layout``
    (default ``REPRO_DECODE_LAYOUT``, else ``hybrid``) places the KV
    cache's rows (``kv_batch``) and slots (``ctx``); a batch too small
    for them puts the slots over every axis (long context)."""
    over = {"embed_fsdp": ("data",) if cfg.fsdp else ()}
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    batch_ways = 1
    for a in batch_axes:
        batch_ways *= mesh.shape[a]
    if shape.global_batch % batch_ways == 0 and shape.global_batch >= batch_ways:
        layout = layout or os.environ.get("REPRO_DECODE_LAYOUT", "hybrid")
        if shape.kind == "decode" and layout == "batchmodel":
            # batch on the TP axis, cache seq on the data axis
            over["batch"] = ("model",)
            over["ctx"] = batch_axes
            over["kv_batch"] = ("model",)
        elif shape.kind == "decode" and layout == "hybrid":
            # projections stay TP (batch on data); the attention runs in
            # the cache's layout (cache batch on model, seq on data)
            over["batch"] = batch_axes
            over["kv_batch"] = ("model",)
            over["ctx"] = batch_axes
        else:
            over["batch"] = batch_axes
            over["kv_batch"] = batch_axes
            over["ctx"] = ("model",) if shape.kind == "decode" else ()
    else:
        # long-context mode: batch unshardable -> full context parallelism
        over["batch"] = ()
        over["ctx"] = batch_axes + ("model",)
    return over


class Sharding(NamedTuple):
    """The port's ``NamedSharding``: a mesh and, per tensor dim, the mesh
    axes that split it (``logical_to_spec``'s form). A rank holds the
    block of each split dim at its row-major index over that dim's
    axes. ``order`` (empty, or ``(dim, indices)``) puts the whole
    tensor's ``dim`` in that order before the blocks are cut (the module
    docstring)."""
    mesh: object
    spec: tuple
    order: tuple = ()

    def split_axes(self) -> tuple:
        """Every mesh axis that splits some dim, in spec order."""
        return tuple(a for entry in self.spec for a in spec_axes(entry))

    def block(self, shape: Sequence[int]) -> tuple:
        """The slices of a whole tensor of ``shape`` that this rank holds
        (one per dim; raises on an uneven split)."""
        out = []
        for n, local, entry in zip(shape, self.local_shape(shape),
                                   self.spec + (None,) * len(shape)):
            axes = spec_axes(entry)
            i = self.mesh.axis(axes).index if axes else 0
            out.append(slice(i * local, (i + 1) * local))
        return tuple(out)

    def local_shape(self, shape: Sequence[int]) -> tuple:
        out = []
        for n, entry in zip(shape, self.spec + (None,) * len(shape)):
            ways = self.mesh.ways(spec_axes(entry))
            if n % ways:
                raise ValueError(
                    f"a dim of {n} does not split {ways} ways over mesh "
                    f"axes {spec_axes(entry)} (spec {self.spec})")
            out.append(n // ways)
        return tuple(out)


def fitted(shape: Sequence[int], logical: Sequence[Optional[str]],
           mesh=None) -> Sharding:
    """The ``Sharding`` of a whole tensor of ``shape`` with logical axes
    ``logical`` on ``mesh`` (default the active one), each dim's axes
    fitted to its size (``fit_spec``)."""
    mesh = mesh if mesh is not None else current_mesh()
    return Sharding(mesh, fit_spec(shape, logical_to_spec(logical, mesh),
                                   mesh))


def ordered(x: torch.Tensor, sharding: Sharding,
            inverse: bool = False) -> torch.Tensor:
    """The whole tensor ``x`` in ``sharding``'s ``order`` (``inverse``:
    back from it); ``x`` itself without one."""
    if not sharding.order:
        return x
    dim, idx = sharding.order
    idx = torch.tensor(idx, device=x.device)
    if inverse:
        idx = torch.argsort(idx)
    return x.index_select(dim, idx)


def place(x: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` under ``sharding``, a
    new contiguous tensor tagged with it (``sharding_of``)."""
    block = ordered(x.detach(), sharding)[sharding.block(x.shape)]
    return tag(block.clone(memory_format=torch.contiguous_format), sharding)


def tag(x: torch.Tensor, sharding: Sharding | None) -> torch.Tensor:
    """``x`` marked as its rank's block under ``sharding`` (None: a
    whole tensor); returns ``x``."""
    x.sharding = sharding
    return x


def sharding_of(x) -> Sharding | None:
    """The ``Sharding`` whose block ``x`` is, or None for a whole tensor."""
    return getattr(x, "sharding", None)


def constrain(x, *logical: Optional[str]):
    """The reference's ``with_sharding_constraint`` by logical axis names.
    The identity off a mesh and on a plain tensor (a rank's activations,
    whose collectives the model makes explicitly); a tensor placed on
    the active mesh under another spec is gathered and placed again
    under this one (no gradient flows through the move)."""
    mesh, have = current_mesh(), sharding_of(x)
    if mesh is None or have is None:
        return x
    want = Sharding(mesh, logical_to_spec(logical, mesh))
    if have == want:
        return x
    if have.mesh is not mesh:
        raise ValueError("constrain moves a tensor within its mesh; "
                         "fault.reshard_state moves it to another")
    from repro_torch.sharding.collectives import gather_whole
    return place(gather_whole(x), want)


def is_axes_leaf(x) -> bool:
    """A logical-axes leaf: plain tuple of axis names / None (not a
    NamedTuple, not a tuple of sub-trees)."""
    return (type(x) is tuple
            and all(isinstance(t, (str, type(None))) for t in x))


def tree_map_axes(fn, tree):
    """``fn`` on every axes leaf of ``tree`` (dicts, NamedTuples, lists
    and tuples of sub-trees), the structure kept."""
    if is_axes_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map_axes(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_axes(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_axes(fn, v) for v in tree)
    raise TypeError(f"not a logical-axes tree: {type(tree)}")


def tree_shardings(logical_tree, mesh=None, shapes=None):
    """Map a tree of logical-axis tuples to ``Sharding``s on ``mesh``
    (default the active mesh); with ``shapes`` (a dict of the tree's
    keys to whole shapes, for a flat dict tree) each fitted to its
    tensor's shape (``fitted``)."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise ValueError("no active mesh")
    if shapes is not None:
        return {k: fitted(shapes[k], ax, mesh)
                for k, ax in logical_tree.items()}
    return tree_map_axes(
        lambda ax: Sharding(mesh, logical_to_spec(ax, mesh)), logical_tree)
