"""The collectives of a model split over a mesh of ranks, as autograd
functions.

The reference writes a model once over global arrays and GSPMD inserts
the collectives at its ``constrain`` points. Here each rank computes on
its own blocks and the model calls these at those points (Megatron's
tensor parallelism, plus FSDP's weight gathers):

* ``enter(x, axis)``: a tensor every rank of ``axis`` holds whole
  enters a computation split over ``axis`` (a column-parallel product,
  a rank's heads or experts): the identity forward, a sum of the
  partial gradients backward.
* ``reduce(x, axis)``: partial results summed over ``axis`` (a
  row-parallel product, a rank's share of the vocabulary or of the
  batch): a sum forward, the identity backward.
* ``gather(x, axis, dim)``: a weight split over ``axis`` gathered whole
  for a computation every rank of ``axis`` repeats (the MoE router):
  an all-gather forward, this rank's block of the gradient backward.
* ``gathered(module)``: a module's weights with their FSDP-split dims
  (those split over the batch's axes, ``embed_fsdp``) gathered, as the
  model reads them: an all-gather forward, a reduce-scatter (a sum over
  the batch's ranks) of the gradient backward.

``axis_of(logical)`` is the mesh axis the active mesh splits a logical
axis over, or None; every function here is the identity for None, so
off a mesh the model runs the plain program. ``gather_whole`` and
``gather_to_first`` gather placed state (not activations) whole, on
every rank or on the mesh's first.

All of them go through the raw collectives at the end of this module,
which the model, the trainer and the simulator call directly where no
autograd is involved: ``all_reduce`` (SUM, MAX), ``all_gather`` and
``reduce_scatter`` over a ``launch.mesh.MeshAxis``. Two ranks sharing
one card need gloo (NCCL refuses two ranks on one device); gloo runs
all three on CUDA tensors (PyTorch 2.11 on an H100), and a collective
that fails raises.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from repro_torch.sharding.partitioning import (current_mesh, mesh_axes,
                                               sharding_of, spec_axes)


def axis_of(logical: str):
    """The ``MeshAxis`` of the active mesh that splits ``logical``
    (several mesh axes taken together), or None: off a mesh, when the
    rules map it to no axis of the mesh, or to axes of size 1."""
    mesh = current_mesh()
    if mesh is None:
        return None
    axes = mesh_axes(logical, mesh)
    if not axes or mesh.ways(axes) == 1:
        return None
    return mesh.axis(axes)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axis.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce(x, axis.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, summed):
        ctx.args = (axis, dim, summed)
        return all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        axis, dim, summed = ctx.args
        if summed:
            return reduce_scatter(g, axis, dim), None, None, None
        n = g.shape[dim] // axis.size
        return g.narrow(dim, axis.index * n, n), None, None, None


def enter(x: torch.Tensor, axis) -> torch.Tensor:
    """Identity forward, the gradient summed over ``axis`` backward."""
    return x if axis is None else _Enter.apply(x, axis)


def reduce(x: torch.Tensor, axis) -> torch.Tensor:
    """``x`` summed over ``axis``; the gradient passes as it is."""
    return x if axis is None else _Reduce.apply(x, axis)


def reduce_max(x: torch.Tensor, axis) -> torch.Tensor:
    """The elementwise maximum over ``axis``, outside autograd."""
    return x if axis is None else all_reduce(x.detach(), axis.group, "max")


def gather(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """The blocks of ``axis`` concatenated on ``dim``, for a computation
    every rank repeats: the gradient's block comes back."""
    return x if axis is None else _Gather.apply(x, axis, dim, False)


def _gather_summed(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """The blocks of ``axis`` concatenated on ``dim``; the gradients of
    the ranks summed, this rank's block kept (FSDP)."""
    return x if axis is None else _Gather.apply(x, axis, dim, True)


def gather_whole(x: torch.Tensor) -> torch.Tensor:
    """The whole tensor of which ``x`` is this rank's block (``x`` if it
    is placed on no axis), outside autograd."""
    s = sharding_of(x)
    if s is None:
        return x
    out = x.detach()
    for dim, entry in enumerate(s.spec):
        axes = spec_axes(entry)
        if axes:
            out = all_gather(out, s.mesh.axis(axes), dim)
    return out


def gather_to_first(x: torch.Tensor):
    """The whole tensor of which ``x`` is this rank's block, on the host
    of the first rank of its mesh (None on the others), outside
    autograd: only the ranks holding the first rank's missing blocks send
    them (a gather along the axes that split ``x``, of host copies, as
    the checkpoint that takes them writes from the host). ``x`` itself
    where it is whole."""
    s = sharding_of(x)
    if s is None:
        return x
    mesh = s.mesh
    axes = tuple(a for a in s.split_axes() if mesh.axis_size(a) > 1)
    rank = dist.get_rank() if dist.is_initialized() else 0
    first = int(mesh.ranks.flat[0])
    if not axes:
        return x if rank == first else None
    ax = mesh.axis(axes)         # on every rank: all of them make its groups
    coords = np.argwhere(mesh.ranks == rank)[0]
    if any(c for a, c in zip(mesh.axis_names, coords) if a not in axes):
        return None                  # a rank of another group along axes
    x = x.detach().cpu().contiguous()
    blocks = [torch.empty_like(x) for _ in range(ax.size)] \
        if ax.index == 0 else None
    dist.gather(x, blocks, dst=first, group=ax.group)
    if blocks is None:
        return None
    blocks = in_axis_order(blocks, ax)
    whole = x.new_empty([n * mesh.ways(spec_axes(e)) for n, e in
                         zip(x.shape, s.spec + (None,) * x.ndim)])
    sizes = [mesh.axis_size(a) for a in axes]
    for k, blk in enumerate(blocks):
        at = dict(zip(axes, np.unravel_index(k, sizes)))
        index = []
        for n, entry in zip(x.shape, s.spec + (None,) * x.ndim):
            i = 0
            for a in spec_axes(entry):             # row-major over them
                i = i * mesh.axis_size(a) + int(at.get(a, 0))
            index.append(slice(i * n, (i + 1) * n))
        whole[tuple(index)] = blk
    return whole


def _fsdp_dims(p: torch.Tensor, batch: tuple) -> list:
    """``(dim, axes)`` of each dim of ``p`` split over the batch's axes."""
    s = sharding_of(p)
    if s is None:
        return []
    out = []
    for dim, entry in enumerate(s.spec):
        axes = spec_axes(entry)
        if axes and set(axes) <= set(batch):
            out.append((dim, axes))
        elif set(axes) & set(batch):
            raise ValueError(f"a dim split over {axes} mixes the batch's "
                             f"axes {batch} with others")
    return out


class _View:
    """A module's weights as read by the model code: attributes, and
    ``[]`` and ``in`` for a parameter dict."""

    def __init__(self, items: dict):
        self.__dict__.update(items)

    def __getitem__(self, key):
        return self.__dict__[key]

    def __contains__(self, key) -> bool:
        return key in self.__dict__


def gathered(module: nn.Module):
    """``module`` with each weight split over the batch's axes (FSDP)
    gathered whole on those dims; the module itself when none is (off a
    mesh, or no FSDP split). A ``ModuleList`` becomes a list, any other
    module an object with the same attribute (and key) names."""
    mesh = current_mesh()
    batch = mesh_axes("batch", mesh) if mesh is not None else ()
    if not batch or not any(_fsdp_dims(p, batch)
                            for p in module.parameters()):
        return module

    def leaf(p):
        for dim, axes in _fsdp_dims(p, batch):
            p = _gather_summed(p, mesh.axis(axes), dim)
        return p

    def view(mod):
        if isinstance(mod, nn.ModuleList):
            return [view(m) for m in mod]
        return _View({**{k: leaf(p) for k, p in mod._parameters.items()},
                      **mod._buffers,
                      **{k: view(m) for k, m in mod._modules.items()}})

    return view(module)


# PyTorch 2.13 renames reduce_scatter_tensor reduce_scatter_single (the
# old name warns)
REDUCE_SCATTER = ("reduce_scatter_single"
                  if hasattr(dist, "reduce_scatter_single")
                  else "reduce_scatter_tensor")


def in_axis_order(blocks: list, axis) -> list:
    """Blocks delivered in group-rank order, put in the axis's order
    (``MeshAxis.group_rank``)."""
    return [blocks[g] for g in axis.group_rank] if axis.group_rank \
        else list(blocks)


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``x`` reduced over ``group`` (SUM or MAX), a new tensor on
    ``x``'s device; ``group`` None is the identity. The simulator's one
    collective."""
    if group is None:
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM if op == "sum"
                    else dist.ReduceOp.MAX, group=group)
    return out


def all_gather(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """Every rank's ``x`` along ``axis`` (a ``MeshAxis``), concatenated
    on ``dim`` in the axis's order (exact: a copy)."""
    if axis.group is None:
        return x
    buf = torch.empty((axis.size * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(buf, x.contiguous(), group=axis.group)
    if dim == 0 and not axis.group_rank:
        return buf
    return torch.cat(in_axis_order(buf.view(axis.size, *x.shape).unbind(0),
                                   axis), dim=dim)


def reduce_scatter(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """This rank's block on ``dim`` of ``x`` summed over ``axis`` (a
    ``MeshAxis``): each rank receives only the sum of its own block."""
    if axis.group is None:
        return x
    n = x.shape[dim] // axis.size
    blocks = x.movedim(dim, 0).split(n)                 # in the axis's order
    if axis.group_rank:              # the group's k-th block to its rank k
        numbered = [None] * axis.size
        for i, g in enumerate(axis.group_rank):
            numbered[g] = blocks[i]
        blocks = numbered
    out = x.new_empty((n, *blocks[0].shape[1:]))
    getattr(dist, REDUCE_SCATTER)(out, torch.cat(blocks), group=axis.group)
    return out.movedim(0, dim)
