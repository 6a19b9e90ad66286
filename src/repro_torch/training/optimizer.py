"""AdamW and its schedule on tensors.

Port of ``repro/training/optimizer.py``. Parameters, gradients and the
two moments are dicts of tensors with the same keys (the trainer passes
``dict(model.named_parameters())``), the port's form of the reference's
pytrees; "leaf order" is the dicts' order. The arithmetic is the
reference's, in its order: gradients taken to float32, clipped by the
global norm, moments and the decoupled weight decay in float32, the new
parameter cast back to its dtype.

The update runs one parameter at a time and in place: the parameters
and moments are overwritten (the reference donates their buffers), and
the only float32 copies of a gradient are the few temporaries of the
parameter being updated, never a second float32 tree (16 GB at
qwen3-4b, on top of ~48 GB of bfloat16 parameters and gradients and
float32 moments). The schedule, the step count and the bias corrections
stay on the parameters' device, so an update reads nothing back to the
host.

On a mesh of ranks the parameters are this rank's blocks (each tagged
with its ``Sharding``, ``Model.shard``): the moments take the same
blocks and tags, the update is elementwise on them, and the clip's
global norm sums each leaf's squares over the ranks that split it, so
every rank clips by the whole model's norm.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch.sharding.collectives import all_reduce
from repro_torch.sharding.partitioning import sharding_of, tag


class AdamWState(NamedTuple):
    step: torch.Tensor          # () int32, updates taken
    m: dict                     # first moments, float32, the params' keys
    v: dict                     # second moments


class Optimizer(NamedTuple):
    init: Callable              # (params) -> AdamWState
    update: Callable            # (grads, state, params) -> (params, state)


def _leaves(tree) -> list:
    return list(tree.values()) if isinstance(tree, dict) else list(tree)


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> Callable:
    """step -> float32 learning rate: linear warm-up over ``warmup`` steps,
    then a cosine from ``base_lr`` down to ``min_frac * base_lr`` at
    ``total``."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5 *
                         (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return lr


def global_norm(tree, shardings=None) -> torch.Tensor:
    """The float32 L2 norm of every leaf together: the leaves' sums of
    squares added in leaf order, one leaf's float32 copy at a time.
    ``shardings`` (one per leaf, None for a whole one) makes a leaf's sum
    that of its blocks on every rank that splits it."""
    leaves = _leaves(tree)
    total = None
    for x, s in zip(leaves, shardings or [None] * len(leaves)):
        sq = torch.sum(torch.square(x.to(torch.float32)))
        if s is not None and s.split_axes():
            sq = all_reduce(sq, s.mesh.axis(s.split_axes()).group)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)


def clip_by_global_norm(tree, max_norm: float):
    """``(tree scaled so its global norm is at most max_norm, the norm
    before)``; a dict stays a dict, anything else becomes a list."""
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    if isinstance(tree, dict):
        return {k: x * scale for k, x in tree.items()}, norm
    return [x * scale for x in tree], norm


def adamw(
    lr: Callable | float,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: float | None = 1.0,
) -> Optimizer:
    lr_fn = lr if callable(lr) else (
        lambda step: torch.full((), lr, dtype=torch.float32,
                                device=step.device))

    def init(params: dict) -> AdamWState:
        dev = next(iter(params.values())).device

        def zeros():
            return {k: tag(torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device), sharding_of(p))
                    for k, p in params.items()}

        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                          m=zeros(), v=zeros())

    @torch.no_grad()
    def update(grads: dict, state: AdamWState, params: dict):
        scale = (_clip_scale(global_norm(
            [grads[k] for k in params],
            [sharding_of(p) for p in params.values()]), clip_norm)
            if clip_norm is not None else None)
        step = state.step + 1
        stepf = step.to(torch.float32)
        lr_t = lr_fn(step)
        bc1 = 1.0 - b1 ** stepf
        bc2 = 1.0 - b2 ** stepf
        for k, p in params.items():
            g = grads[k].to(torch.float32)
            if scale is not None:
                g = g * scale
            m, v = state.m[k], state.v[k]
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            pf = p.to(torch.float32)
            if weight_decay:
                delta = delta + weight_decay * pf
            p.copy_((pf - lr_t * delta).to(p.dtype))
        return params, AdamWState(step=step, m=state.m, v=state.v)

    return Optimizer(init=init, update=update)
