"""Meshes of ranks, and a launcher that starts the ranks.

Port of the continuum meshes of ``repro/launch/mesh.py``. A JAX mesh
holds devices of one process; here each rank of the default
``torch.distributed`` process group is a process with one device, and a
``Mesh`` is a 2-D (``data``, ``players``) grid of ranks with a process
group along each axis:

* ``data`` carries independent grid lanes (scenario x seed, the logical
  ``grid`` axis);
* ``players`` splits the K load balancers inside each simulation (the
  logical ``players`` axis; only the per-round arrival sum crosses it).

Without an initialised process group, or with a world of one, a mesh has
one rank and every entry point runs the plain program. ``spawn`` starts
D ranks (one process each, a free TCP port on ``localhost``, rank r on
``cuda:(r % device_count)`` when there is a card) and returns rank 0's
result.

The collectives are all-reduce (SUM, MAX) only: gloo runs nothing else
on CUDA tensors, and two ranks sharing one card need gloo (NCCL refuses
two ranks on one device).
"""
from __future__ import annotations

import datetime
import io
import queue
import socket
import time
import traceback
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "players")


class MeshAxis(NamedTuple):
    """This rank's view of one mesh axis: the process group of the ranks
    along it (None for an axis of one), its size and this rank's index."""
    group: object
    size: int
    index: int


def _world() -> tuple[int, int]:
    """(world size, this rank) of the default group, (1, 0) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Mesh:
    """A (data, players) grid of ranks of the default process group.

    The axis groups are made on first use, by every rank at the same
    point (each entry point asks for them before its first collective),
    and are not pickled: a mesh made before the ranks start (``spawn``'s
    arguments) makes its groups in each rank."""

    axis_names = AXES

    def __init__(self, ranks: np.ndarray):
        self.ranks = np.asarray(ranks, dtype=np.int64).reshape(
            -1, np.asarray(ranks).shape[-1])
        self._axes = None

    def __getstate__(self):
        return {"ranks": self.ranks}

    def __setstate__(self, state):
        self.ranks, self._axes = state["ranks"], None

    @property
    def shape(self) -> dict:
        return dict(zip(AXES, self.ranks.shape))

    def size(self) -> int:
        return int(self.ranks.size)

    def axis_size(self, name: str) -> int:
        return int(self.shape.get(name, 1))

    def axis(self, name: str) -> MeshAxis:
        """This rank's ``MeshAxis`` along ``name``."""
        if self._axes is None:
            self._axes = self._make_axes()
        return self._axes[name]

    def _make_axes(self) -> dict:
        world, rank = _world()
        if self.size() == 1:
            return {a: MeshAxis(None, 1, 0) for a in AXES}
        if world != self.size() or sorted(self.ranks.ravel()) != list(
                range(world)):
            raise ValueError(
                f"a mesh over ranks {self.ranks.ravel().tolist()} needs a "
                f"default process group of exactly those ranks (world "
                f"{world}; start them with launch.mesh.spawn)")
        d, p = map(int, np.argwhere(self.ranks == rank)[0])
        out = {}
        # every rank makes every group of an axis, in the same order
        for name, rows, index in (("players", self.ranks, p),
                                  ("data", self.ranks.T, d)):
            if rows.shape[1] == 1:
                out[name] = MeshAxis(None, 1, 0)
                continue
            group, _ = dist.new_subgroups_by_enumeration(
                [r.tolist() for r in rows])
            out[name] = MeshAxis(group, int(rows.shape[1]), index)
        return out


def _ranks(devices) -> list[int]:
    """Ranks from ``devices``: a count, a sequence of ranks, or None
    (every rank of the default group)."""
    if devices is None:
        return list(range(_world()[0]))
    if isinstance(devices, int):
        return list(range(devices))
    return [int(r) for r in devices]


def make_grid_mesh(devices=None) -> Mesh:
    """Every rank on the ``data`` axis: the evaluation-grid mesh (its
    ``players`` axis is 1)."""
    return Mesh(np.asarray(_ranks(devices)).reshape(-1, 1))


def make_continuum_mesh(players: int | None = None, devices=None) -> Mesh:
    """The (``data``, ``players``) continuum mesh: ``players=None`` puts
    every rank on the player axis (one giant-fleet simulation),
    ``players=1`` gives a pure grid mesh, anything between splits the
    ranks ``(D // players, players)``."""
    devs = _ranks(devices)
    n = len(devs)
    p = n if players is None else players
    if p <= 0 or n % p:
        raise ValueError(
            f"players={p} must positively divide the device count {n}")
    return Mesh(np.asarray(devs).reshape(n // p, p))


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``x`` reduced over ``group`` (SUM or MAX), a new tensor on
    ``x``'s device; ``group`` None is the identity. The one place the
    simulator's collectives go through."""
    if group is None:
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM if op == "sum"
                    else dist.ReduceOp.MAX, group=group)
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def tree_map(f, x):
    """``f`` on every tensor of ``x``: a tensor, or lists, tuples,
    NamedTuples and dicts of them (anything else, None too, as is)."""
    if isinstance(x, torch.Tensor):
        return f(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(tree_map(f, v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(tree_map(f, v) for v in x)
    if isinstance(x, dict):
        return {k: tree_map(f, v) for k, v in x.items()}
    return x


def to_host(x):
    """``x`` with every tensor moved to the host (``tree_map``)."""
    return tree_map(lambda t: t.detach().cpu(), x)


def _rank_main(rank, world, port, threads, timeout, fn, args, kwargs,
               results, send):
    """One rank: join the group, run ``fn``, report its result (or the
    traceback) before leaving the group."""
    try:
        if threads:
            torch.set_num_threads(threads)
        if torch.cuda.is_available():
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{port}",
            world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout))
        out = fn(*args, **kwargs)
        dist.barrier()
        payload = None
        if send:
            buf = io.BytesIO()
            torch.save(to_host(out), buf)
            payload = buf.getvalue()
        results.put((rank, True, payload))
    except Exception:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world_size: int, *args, threads: int | None = None,
          every_rank: bool = False, timeout: float = 900.0, **kwargs):
    """Run ``fn(*args, **kwargs)`` on ``world_size`` new ranks, each a
    process of a new default process group (gloo, a free TCP port on
    ``localhost``), and return rank 0's result (``every_rank``:
    the list of every rank's), moved to the host.

    ``fn`` and the arguments are pickled into each rank, so ``fn`` is a
    module-level function; a ``Mesh`` among the arguments makes its
    groups there. ``threads`` sets each rank's intra-op threads. A rank
    that raises ends the run: its traceback is raised here, and the
    other ranks are stopped."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(
        r, world_size, port, threads, timeout, fn, args, kwargs, results,
        every_rank or r == 0)) for r in range(world_size)]
    for p in procs:
        p.start()
    got: dict = {}
    deadline = time.monotonic() + timeout + 60.0
    try:
        while len(got) < world_size:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode} before reporting")
                if time.monotonic() > deadline:
                    late = sorted(set(range(world_size)) - set(got))
                    raise TimeoutError(f"ranks {late} did not finish in "
                                       f"{timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            got[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=10.0)
            if p.is_alive():
                p.kill()
                p.join()

    def load(b):
        return torch.load(io.BytesIO(b), weights_only=False)

    if every_rank:
        return [load(got[r]) for r in range(world_size)]
    return load(got[0])
