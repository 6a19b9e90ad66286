"""End-to-end training launcher.

Port of ``repro/launch/train.py``: a qwen3-family (or any) model trained
on the synthetic LM stream with remat, microbatch accumulation,
optional int8 gradient compression, and checkpoints with resume through
``repro_torch.checkpoint``. Unlike the reference launcher, the published
config runs unless ``--smoke`` (the reduced config) or ``--train-100m``
(~100M parameters) is given; ``--device`` defaults to the card.

``--mesh DATAxMODEL`` trains on a (``data``, ``model``) mesh of DATA x
MODEL ranks, which it starts (``launch.mesh.spawn``: one process a
rank, gloo; on the card every rank shares the card ``r % count``): each
rank keeps its blocks of the weights and moments (``Model.shard``, by
``tree_shardings`` of ``param_axes``) and of each batch, and rank 0
prints and returns the losses, which are the whole batch's on every
rank. A checkpoint holds whole tensors, so a run may resume on another
mesh (``restore(..., shardings=)``; ``fault/elastic.py``). Run inside
an initialised process group without the flag, the launcher trains on
``small_mesh()`` of its ranks; with neither, on one device.

  python -m repro_torch.launch.train --arch qwen3-4b --steps 30  # the card
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 50 --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --mesh 2x2 --steps 20

Checkpoints hold ``(parameters, AdamWState)`` and are labelled by the
steps taken: a run resumed from step n takes step n next, so its losses
equal an uninterrupted run's. (The reference labels a checkpoint by the
step just taken and takes that step again on resume.)

On the card, ``--train-100m`` raises the flash kernel's ``ValueError``:
its head dim of 80 is not one the kernel takes (ROADMAP A11).

The last line of output is one JSON object: the config, the logged
steps, their losses and each logged interval's seconds a step (host
clock; logging reads the loss, which waits for the device).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import time

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import Mesh, _world, make_test_mesh, spawn
from repro_torch.models import build_model
from repro_torch.sharding import Sharding, tree_shardings
from repro_torch.training import (adamw, cosine_schedule, make_train_step,
                                  synthetic_batch)
from repro_torch.training.optimizer import AdamWState


def small_mesh() -> Mesh:
    """The ranks of the default group (one without a group) as a
    (``data``, ``model``) mesh: the model axis the first of 4, 2, 1 ranks
    that divides them."""
    n = _world()[0]
    model_ways = next(c for c in (4, 2, 1) if n % c == 0)
    return Mesh(np.arange(n).reshape(n // model_ways, model_ways),
                ("data", "model"))


def train_100m_config(base: str = "qwen3-4b"):
    """~100M-param member of the qwen3 family (train_100m example)."""
    cfg = get_config(base)
    return dataclasses.replace(
        cfg, name=base + "-100m", num_layers=8, d_model=640, num_heads=8,
        num_kv_heads=4, head_dim=80, d_ff=1536, vocab_size=32768,
        fsdp=False)


def _rank(argv) -> list:
    """One rank of ``--mesh``: ``main`` in the rank's process group, its
    output kept by rank 0 alone."""
    if torch.distributed.get_rank() == 0:
        return main(argv)
    with contextlib.redirect_stdout(io.StringIO()):
        return main(argv)


def _mesh_shape(text: str) -> tuple:
    data, model = (int(n) for n in text.lower().split("x"))
    return data, model


def main(argv=None) -> list:
    """Train; returns the logged losses (host floats)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b", choices=ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--train-100m", action="store_true",
                    help="~100M-param example config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--mesh", type=_mesh_shape, default=None,
                    metavar="DATAxMODEL",
                    help="train on a (data, model) mesh of ranks, started "
                         "here (gloo, one process a rank)")
    args = ap.parse_args(argv)
    world = _world()[0]
    if args.mesh is not None and world == 1:
        n = args.mesh[0] * args.mesh[1]
        return spawn(_rank, n, argv, timeout=86400.0,
                     threads=max(1, (os.cpu_count() or 1) // n))
    mesh = None
    if world > 1:
        mesh = make_test_mesh(*args.mesh) if args.mesh else small_mesh()

    if args.train_100m:
        cfg = train_100m_config(args.arch)
    else:
        cfg = get_config(args.arch, reduced=args.smoke)
    dev = resolve_device(args.device)
    shape = ShapeConfig("cli", "train", args.seq_len, args.batch)
    print(f"arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M "
          f"device={dev}" + (f" mesh={mesh.shape}" if mesh else ""))
    with mesh or contextlib.nullcontext():
        return _train(args, cfg, dev, shape, mesh)


def _train(args, cfg, dev, shape: ShapeConfig, mesh) -> list:
    model = build_model(cfg, device=dev, seed=0).trainable()
    if mesh is not None:
        model.shard(mesh)
    params = dict(model.named_parameters())
    opt = adamw(cosine_schedule(args.lr, 20, args.steps))
    step_fn = make_train_step(model, opt, accum_steps=args.accum_steps,
                              compress_grads=args.compress_grads)
    opt_state = opt.init(params)

    start = 0
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt and args.resume and ckpt.latest_step() is not None:
        shardings = None
        if mesh is not None:
            p_shard = tree_shardings(model.param_axes(), mesh)
            shardings = (p_shard, AdamWState(step=Sharding(mesh, ()),
                                             m=p_shard, v=p_shard))
        (saved, opt_state), start = ckpt.restore((params, opt_state),
                                                 shardings=shardings)
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(saved[name])
        print(f"resumed from step {start}")

    t0 = t_log = time.perf_counter()
    losses, logged, step_s = [], [], []
    for step in range(start, args.steps):
        batch = synthetic_batch(cfg, shape, step, dev, mesh=mesh)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % args.log_every == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            now = time.perf_counter()
            step_s.append((now - t_log) / (step + 1 - (logged[-1] + 1
                                                       if logged else start)))
            t_log = now
            losses.append(loss)
            logged.append(step)
            tok_s = (step - start + 1) * shape.global_batch \
                * shape.seq_len / max(now - t0, 1e-9)
            print(f"step {step:5d} loss {loss:8.4f} tok/s {tok_s:9.0f}")
        done = step + 1
        if ckpt and done % args.ckpt_every == 0 and done < args.steps:
            ckpt.save(done, (params, opt_state), blocking=False)
    if ckpt:
        ckpt.save(args.steps, (params, opt_state), blocking=True)
    if losses:
        print(f"done: first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")
    print(json.dumps(dict(arch=cfg.name, params=cfg.param_count(),
                          device=str(dev), start=start, steps=args.steps,
                          mesh=mesh.shape if mesh else None,
                          tokens_per_step=shape.global_batch * shape.seq_len,
                          logged_steps=logged, losses=losses,
                          step_s=step_s)))
    return losses


if __name__ == "__main__":
    main()
