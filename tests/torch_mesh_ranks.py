"""Functions the port's mesh tests run on every rank of a
``launch.mesh.spawn``: kept apart from the test modules so that a rank
imports the port alone, not JAX."""
import contextlib

import torch
import torch.distributed as dist

from repro_torch import training as TT
from repro_torch.checkpoint import Checkpointer
from repro_torch.fault import build_mesh, reshard_state, shrink_mesh
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import build_model
from repro_torch.sharding import Sharding, place, sharding_of, tree_shardings
from repro_torch.sharding.collectives import (all_reduce, gather_whole,
                                              reduce_scatter)
from repro_torch.training.optimizer import AdamWState


def call_all(calls) -> list:
    """``[fn(*args, **kwargs) for fn, args, kwargs in calls]``: several
    runs in one ``spawn``, the ranks making each call together."""
    return [fn(*args, **kwargs) for fn, args, kwargs in calls]


def state_shardings(model, mesh) -> tuple:
    """The ``Sharding``s of ``(parameters, AdamWState)`` on ``mesh``."""
    ps = tree_shardings(model.param_axes(), mesh)
    return ps, AdamWState(step=Sharding(mesh, ()), m=ps, v=ps)


def state_axes(model) -> tuple:
    axes = model.param_axes()
    return axes, AdamWState(step=(), m=axes, v=axes)


def train(cfg, weights: dict, shape, steps: int, mesh=None, ckdir=None,
          resume: bool = False) -> dict:
    """``steps`` steps of ``adamw(1e-3, clip_norm=1.0)`` from ``weights``
    (a state dict of the whole model), on ``mesh`` (this rank's blocks)
    or on one rank: ``{"losses": [...]}``. ``ckdir``: save the state
    after the last step there and report on its writer whether the saved
    weights and moments are the ranks' blocks gathered whole
    (``"saved_equal"``); with ``resume``, first restore its latest step
    instead (with the mesh's shardings), and report whether
    ``fault.reshard_state`` of the whole restored state places the same
    blocks (``"reshard_equal"``)."""
    model = build_model(cfg, "cpu")
    model.load_state_dict(weights)
    model.trainable()
    opt = TT.adamw(1e-3, clip_norm=1.0)
    step = TT.make_train_step(model, opt)
    out = {}
    with mesh or contextlib.nullcontext():
        if mesh is not None:
            model.shard(mesh)
        p = dict(model.named_parameters())
        state = opt.init(p)
        first = 0
        if resume:
            ck = Checkpointer(ckdir)
            sh = state_shardings(model, mesh) if mesh is not None else None
            (saved, state), first = ck.restore((p, state), shardings=sh)
            if mesh is not None:
                whole, _ = ck.restore((p, state))
                moved = reshard_state(whole, state_axes(model), mesh)
                out["reshard_equal"] = all(
                    torch.equal(a, b) and sharding_of(a) == sharding_of(b)
                    for a, b in zip((*moved[0].values(), *moved[1].m.values()),
                                    (*saved.values(), *state.m.values())))
            with torch.no_grad():
                for k, w in p.items():
                    w.copy_(saved[k])
        losses = []
        for s in range(first, first + steps):
            batch = TT.synthetic_batch(cfg, shape, s, "cpu", mesh=mesh)
            p, state, m = step(p, state, batch)
            losses.append(float(m["loss"]))
        if ckdir is not None and not resume:
            ck = Checkpointer(ckdir)
            ck.save(first + steps, (p, state))
            whole = [gather_whole(t) for t in (*p.values(), *state.m.values())]
            if mesh is None or dist.get_rank() == 0:
                saved, back = ck.restore((p, state))[0]
                out["saved_equal"] = all(
                    torch.equal(a, b) for a, b in zip(
                        (*saved.values(), *back.m.values()), whole))
    out["losses"] = losses
    return out


def elastic(cfg, weights: dict, shape, ckdir: str, ports: tuple) -> dict:
    """The elastic restart on 4 ranks: 3 steps on ``build_mesh(4,
    model_axis=2)``, saved; then the last data row is lost, and the two
    survivors leave the group and form one of their own (on
    ``ports[0]``), restore onto the shrunk mesh and take 2 steps. The
    lost pair forms a group on ``ports[1]`` and meanwhile runs, each
    alone on no mesh, what the survivors are held against: one rank
    resumed from the checkpoint (``"alone"``) and 5 uninterrupted steps
    (``"uninterrupted"``). A survivor returns ``{"before": train's
    report, "after": train's report}``."""
    mesh = build_mesh(4, model_axis=2)
    before = train(cfg, weights, shape, 3, mesh, ckdir)
    small = shrink_mesh(mesh, 1)
    rank = dist.get_rank()
    survivor = rank in small.ranks
    dist.barrier()
    dist.destroy_process_group()
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{ports[not survivor]}",
        world_size=2, rank=rank % 2)
    if not survivor:
        if rank % 2 == 0:
            return {"alone": train(cfg, weights, shape, 2, None, ckdir, True)}
        return {"uninterrupted": train(cfg, weights, shape, 5)}
    return {"before": before,
            "after": train(cfg, weights, shape, 2, small, ckdir, True)}


# leaves of save_on_pod_mesh by their logical axes: rows over data (FSDP)
# and columns over model, rows over model, and a whole one
POD_LEAVES = {"fsdp_heads": ((8, 6), ("embed_fsdp", "heads")),
              "vocab": ((6, 3), ("vocab", None)),
              "whole": ((5,), (None,))}


def save_on_pod_mesh(ckdir: str) -> dict:
    """Place ``POD_LEAVES`` (drawn from seed 0, the same on every rank)
    on the (pod 2, data 2, model 2) mesh and save them, with no
    collective made on the mesh before; then sum a one over the batch's
    axes (pod, data), a group across the pods made after the save, as a
    training step's gradients make it. The writer reports whether the
    checkpoint holds the leaves whole (``"saved_equal"``) and the sum
    (``"batch_sum"``)."""
    mesh = make_test_mesh(2, 2, pod=2)
    gen = torch.Generator().manual_seed(0)
    whole = {k: torch.randn(shape, generator=gen)
             for k, (shape, _) in POD_LEAVES.items()}
    sh = tree_shardings({k: ax for k, (_, ax) in POD_LEAVES.items()}, mesh)
    ck = Checkpointer(ckdir)
    ck.save(1, {k: place(x, sh[k]) for k, x in whole.items()})
    total = all_reduce(torch.ones(()), mesh.axis(("pod", "data")).group)
    if dist.get_rank() != 0:
        return {}
    back, _ = ck.restore(whole)
    return {"saved_equal": all(torch.equal(back[k], x)
                               for k, x in whole.items()),
            "batch_sum": float(total)}


# (axes, dim) of reduce_scatter_cases: one axis, two together in the
# mesh's order and against it (a group the axis numbers otherwise than
# torch does), the batch's two across the pods
SCATTER_CASES = (("data", 0), (("data", "model"), 1), (("model", "data"), 0),
                 (("pod", "data"), 2))


def reduce_scatter_cases() -> list:
    """On the (pod 2, data 2, model 2) mesh, for each of
    ``SCATTER_CASES``: whether ``reduce_scatter`` of this rank's tensor
    (small integers, so every sum is exact) equals this rank's block of
    its all-reduce."""
    mesh = make_test_mesh(2, 2, pod=2)
    gen = torch.Generator().manual_seed(dist.get_rank())
    out = []
    for axes, dim in SCATTER_CASES:
        ax = mesh.axis(axes)
        x = torch.randint(-8, 8, (4, 8, 4), generator=gen).float()
        n = x.shape[dim] // ax.size
        want = all_reduce(x, ax.group).narrow(dim, ax.index * n, n)
        out.append(torch.equal(reduce_scatter(x, ax, dim), want))
    return out
