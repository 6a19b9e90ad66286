"""Meshes of ranks, and a launcher that starts the ranks.

Port of ``repro/launch/mesh.py``. A JAX mesh holds devices of one
process; here each rank of the default ``torch.distributed`` process
group is a process with one device, and a ``Mesh`` is a grid of ranks
with named axes and a process group along each axis (and along each
set of axes a computation asks for, such as the batch's (``pod``,
``data``)):

* the model meshes, (``data``, ``model``) and (``pod``, ``data``,
  ``model``) (``make_test_mesh``, ``make_production_mesh``): ``data``
  and ``pod`` split the batch (data parallel) and the weights' d_model
  rows (FSDP), ``model`` splits heads, FFN columns, experts and the
  vocabulary (tensor and expert parallel), as ``sharding``'s rules say;
* the continuum meshes, (``data``, ``players``) (``make_grid_mesh``,
  ``make_continuum_mesh``): ``data`` carries independent grid lanes
  (scenario x seed, the logical ``grid`` axis), ``players`` splits the K
  load balancers inside each simulation (the logical ``players`` axis;
  only the per-round arrival sum crosses it).

``with mesh:`` makes a mesh the active one (``sharding.current_mesh``).
Without an initialised process group, or with a world of one, a mesh
has one rank and every entry point runs the plain program. ``spawn``
starts D ranks (one process each, a free TCP port on ``localhost``,
rank r on ``cuda:(r % device_count)`` when there is a card) and returns
rank 0's result.

The ranks join gloo (NCCL refuses two ranks on one device); the
collectives over a mesh's axes live in ``sharding.collectives``.
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

from repro_torch.sharding.partitioning import pop_mesh, push_mesh

AXES = ("data", "players")               # the continuum meshes' axes


class MeshAxis(NamedTuple):
    """This rank's view of one mesh axis: the process group of the ranks
    along it (None for an axis of one), its size and this rank's index.
    ``group_rank[i]`` is the group's number for the rank at index i
    (torch numbers a group's ranks in ascending global rank; empty where
    that is i), the order in which a gather delivers the blocks."""
    group: object
    size: int
    index: int
    group_rank: tuple = ()


def _world() -> tuple[int, int]:
    """(world size, this rank) of the default group, (1, 0) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Mesh:
    """A grid of ranks of the default process group with named axes
    (default the continuum meshes' (``data``, ``players``)).

    The axis groups are made on first use, by every rank at the same
    point (each entry point asks for them before its first collective),
    and are not pickled: a mesh made before the ranks start (``spawn``'s
    arguments) makes its groups in each rank."""

    def __init__(self, ranks: np.ndarray, axis_names: tuple = AXES):
        ranks = np.asarray(ranks, dtype=np.int64)
        if axis_names == AXES:
            ranks = ranks.reshape(-1, ranks.shape[-1])
        if ranks.ndim != len(axis_names):
            raise ValueError(f"ranks of shape {ranks.shape} for axes "
                             f"{axis_names}")
        self.ranks, self.axis_names = ranks, tuple(axis_names)
        self._axes: dict | None = None

    def __getstate__(self):
        return {"ranks": self.ranks, "axis_names": self.axis_names}

    def __setstate__(self, state):
        self.__init__(state["ranks"], state["axis_names"])

    def __enter__(self) -> "Mesh":
        push_mesh(self)
        return self

    def __exit__(self, *exc) -> None:
        pop_mesh()

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.ranks.shape))

    def size(self) -> int:
        return int(self.ranks.size)

    def axis_size(self, name: str) -> int:
        return int(self.shape.get(name, 1))

    def ways(self, names) -> int:
        """How many blocks the axes ``names`` (a name or a tuple) split a
        dim into: the product of their sizes."""
        names = (names,) if isinstance(names, str) else names
        return int(np.prod([self.axis_size(n) for n in names], dtype=int))

    def axis(self, names) -> MeshAxis:
        """This rank's ``MeshAxis`` along ``names``: one axis, or a tuple
        of axes taken together (this rank's index row-major over them)."""
        key = (names,) if isinstance(names, str) else tuple(names)
        if self._axes is None:
            self._axes = {}
            for name in reversed(self.axis_names):
                self._make_axis((name,))
        if key not in self._axes:
            self._make_axis(key)
        return self._axes[key]

    def _make_axis(self, key: tuple) -> None:
        if self.ways(key) == 1:
            self._axes[key] = MeshAxis(None, 1, 0)
            return
        world, rank = _world()
        if world != self.size() or sorted(self.ranks.ravel()) != list(
                range(world)):
            raise ValueError(
                f"a mesh over ranks {self.ranks.ravel().tolist()} needs a "
                f"default process group of exactly those ranks (world "
                f"{world}; start them with launch.mesh.spawn)")
        # the ranks of each group: the axes of ``key`` last, in its order,
        # so that a rank's index in its group is row-major over them
        dims = [self.axis_names.index(a) for a in key]
        rest = [d for d in range(self.ranks.ndim) if d not in dims]
        rows = self.ranks.transpose(rest + dims).reshape(-1, self.ways(key))
        # every rank makes every group of the axes, in the same order
        group, _ = dist.new_subgroups_by_enumeration(
            [r.tolist() for r in rows])
        row, index = map(int, np.argwhere(rows == rank)[0])
        order = np.argsort(np.argsort(rows[row]))          # rank -> number
        self._axes[key] = MeshAxis(
            group, int(rows.shape[1]), index,
            () if (order == np.arange(order.size)).all() else
            tuple(int(g) for g in order))


def _ranks(devices) -> list[int]:
    """Ranks from ``devices``: a count, a sequence of ranks, or None
    (every rank of the default group)."""
    if devices is None:
        return list(range(_world()[0]))
    if isinstance(devices, int):
        return list(range(devices))
    return [int(r) for r in devices]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16 x 16 = 256 ranks (``data``, ``model``); 2 pods = 512 ranks
    (``pod``, ``data``, ``model``). Raises, as ``jax.make_mesh`` does,
    unless the default group has exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = _world()[0]
    if world != int(np.prod(shape)):
        raise ValueError(f"the mesh {shape} needs {int(np.prod(shape))} "
                         f"ranks; the default group has {world}")
    return Mesh(np.arange(world).reshape(shape), axes)


def make_test_mesh(data: int = 2, model: int = 2,
                   pod: int | None = None) -> Mesh:
    """A small (``data``, ``model``) mesh, or (``pod``, ``data``,
    ``model``) with ``pod``, over the first ranks."""
    if pod:
        return Mesh(np.arange(pod * data * model).reshape(pod, data, model),
                    ("pod", "data", "model"))
    return Mesh(np.arange(data * model).reshape(data, model),
                ("data", "model"))


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
