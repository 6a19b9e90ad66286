"""Training step factory: loss -> grads -> (optional compression) ->
AdamW, with microbatch gradient accumulation.

Port of ``repro/training/train_step.py``:
  * remat (activation checkpointing) per layer (``model.loss(batch,
    remat=True)``, ``models/transformer.py``).
  * microbatch accumulation (``accum_steps``): the batch split on its
    leading axis, the loss and float32 gradients summed over the
    microbatches in order and scaled by ``1 / accum_steps``, as the
    reference's scan sums them.
  * int8 gradient compression (``compress_grads``): per-tensor symmetric
    quantize -> dequantize, the wire format of a cross-pod all-reduce
    emulated end to end.
Parameters and moments are updated in place (the reference donates
their buffers).

On a mesh of ranks (``Model.shard``, run under ``with mesh:``) each rank
takes the loss of the whole batch (``model_zoo``) and the gradients of
its blocks; a weight's gradient is then summed over the batch's axes
that do not split it (the FSDP-split ones were summed by their
gather's backward), so every rank updates its blocks as one device
would. The int8 scale is the maximum over a gradient's every block.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.sharding.collectives import all_reduce
from repro_torch.sharding.partitioning import mesh_axes, sharding_of
from repro_torch.training.optimizer import AdamWState, Optimizer


def int8_compress(tree: dict, shardings: dict | None = None) -> dict:
    """Per-leaf symmetric int8 quantize -> dequantize (lossy), float32
    out; rounds half to even, as the reference does. ``shardings`` (by
    key) takes each split leaf's scale from all its blocks."""
    def q(g, s):
        gf = g.to(torch.float32)
        top = gf.abs().max()
        if s is not None and s.split_axes():
            top = all_reduce(top, s.mesh.axis(s.split_axes()).group, "max")
        scale = torch.clamp_min(top, 1e-12) / 127.0
        qi = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        return qi.to(torch.float32) * scale
    shardings = shardings or {}
    return {k: q(g, shardings.get(k)) for k, g in tree.items()}


def reduce_gradients(grads: dict, params: dict) -> dict:
    """Each gradient summed over the batch's mesh axes that do not split
    its weight (the identity for a whole weight, off a mesh)."""
    out = {}
    for k, g in grads.items():
        s = sharding_of(params[k])
        if s is not None:
            axes = tuple(a for a in mesh_axes("batch", s.mesh)
                         if a not in s.split_axes())
            g = all_reduce(g, s.mesh.axis(axes).group)
        out[k] = g
    return out


def make_train_step(model, optimizer: Optimizer, accum_steps: int = 1,
                    compress_grads: bool = False) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``: ``params`` is ``dict(model.named_parameters())``
    of a ``trainable()`` model, updated in place; ``metrics["loss"]`` the
    (microbatch-mean) loss, a float32 tensor on the device."""

    def value_and_grad(params: dict, batch: dict):
        loss = model.loss(batch, remat=True)
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), dict(zip(params, grads))

    def grads_of(params: dict, batch: dict):
        if accum_steps == 1:
            return value_and_grad(params, batch)
        micro = {k: x.reshape(accum_steps, x.shape[0] // accum_steps,
                              *x.shape[1:]) for k, x in batch.items()}
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=next(iter(params.values())).device)
        grad_sum = None
        for i in range(accum_steps):
            loss, grads = value_and_grad(params, {k: x[i] for k, x in
                                                  micro.items()})
            loss_sum = loss_sum + loss
            if grad_sum is None:
                grad_sum = {k: g.to(torch.float32) for k, g in grads.items()}
            else:
                for k, g in grads.items():
                    grad_sum[k].add_(g)
        scale = 1.0 / accum_steps
        return loss_sum * scale, {k: g.mul_(scale)
                                  for k, g in grad_sum.items()}

    def train_step(params: dict, opt_state: AdamWState, batch: dict):
        loss, grads = grads_of(params, batch)
        grads = reduce_gradients(grads, params)
        if compress_grads:
            grads = int8_compress(grads, {k: sharding_of(p)
                                          for k, p in params.items()})
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss}

    return train_step
