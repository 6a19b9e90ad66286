"""Checkpointing with atomic commits, async writes and content integrity.

Port of ``repro/checkpoint/checkpointer.py`` for the port's state: trees
of dicts, NamedTuples, tuples, lists and ``None`` with tensor (or numpy)
leaves. Layout per step::

    <dir>/step_<n>.tmp/   -> written, fsync'd, then os.replace ->
    <dir>/step_<n>/
        manifest.json     # schema, step, leaf shapes and dtypes, checksum
        arrays.npz        # the leaves, keyed by their path in the tree

The manifest carries a ``schema`` version and the SHA-256 of
``arrays.npz``; ``restore`` checks both before it parses any leaf and
raises ``CheckpointCorruptError`` on a truncated, bit-flipped or
foreign-version checkpoint. ``save`` snapshots every leaf to numpy on
the caller's thread, so an async write never races the caller's next
step; ``keep`` bounds the steps kept on disk. The payload is written in
one pass, hashed as it is written (``_Hashed``: ``np.savez`` streams
into a file it cannot seek), and ``restore`` reads each member in place
(a memmap of its bytes) and copies only the blocks it keeps. numpy has
no bfloat16: a bfloat16 leaf is stored as its int16 bits and restored
into the template's bfloat16.

Sharded state. A leaf that is a rank's block (``sharding.place``, a
``Model.shard`` weight or its moments) is saved whole: every rank of its
mesh calls ``save`` with its blocks, the blocks are gathered, and rank 0
of the process group writes, so a checkpoint does not depend on the
mesh. ``restore(..., shardings=)`` places each leaf on the mesh of its
``Sharding`` (a new mesh after an elastic shrink, ``fault.elastic``).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import struct
import threading
import zipfile
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.obs.provenance import config_hash  # noqa: F401  (re-export)
from repro_torch.sharding.collectives import gather_to_first
from repro_torch.sharding.partitioning import Sharding, sharding_of, tag

_SEP = "/"

# Bump on any incompatible change to the on-disk layout; a manifest
# without the field is version 1 (no checksum).
SCHEMA_VERSION = 2


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed its integrity check: a payload whose checksum
    does not match, an unreadable manifest, or a schema version this
    code does not understand. Do not resume from it."""


def _children(tree):
    """``(name, child)`` pairs of an inner node, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _flatten(tree, path: str = "", out: dict | None = None,
             keep: bool = True) -> dict:
    """Every leaf as a numpy copy, keyed by its path (``None`` has no
    leaf); a rank's block is gathered whole onto the first rank of its
    mesh (the writer) first. Without ``keep`` the leaves are sent and
    dropped (a rank that does not write)."""
    out = {} if out is None else out
    if tree is None:
        return out
    kids = _children(tree)
    if kids is None:
        if isinstance(tree, torch.Tensor):
            t = gather_to_first(tree)
            if not keep:
                return out
            t = t.detach().cpu()
            leaf = (t.view(torch.int16) if t.dtype == torch.bfloat16
                    else t).numpy()
        else:
            leaf = np.asarray(tree)
        out[path] = np.array(leaf, copy=True)
        return out
    for name, child in kids:
        _flatten(child, f"{path}{_SEP}{name}" if path else name, out, keep)
    return out


def _unflatten(template, data, path: str = "", shardings=None):
    """``template``'s structure with its leaves from ``data``: a tensor
    leaf becomes a tensor on the template's device, any other a numpy
    array. ``shardings`` (the template's structure, ``Sharding`` leaves
    or None) makes a leaf this rank's block of it, cut on the host."""
    if template is None:
        return None
    kids = _children(template)
    if kids is None:
        arr = data[path]
        if isinstance(template, torch.Tensor):
            sh = shardings if isinstance(shardings, Sharding) else None
            if sh is not None:
                arr = arr[sh.block(arr.shape)]
            t = torch.from_numpy(np.array(arr, copy=True))
            if template.dtype == torch.bfloat16:
                t = t.view(torch.bfloat16)
            return tag(t.to(template.device), sh)
        return np.array(arr, copy=True)
    subs = ([None] * len(kids) if shardings is None
            else [sub for _, sub in _children(shardings)])
    vals = [_unflatten(child, data, f"{path}{_SEP}{name}" if path else name,
                       sub) for (name, child), sub in zip(kids, subs)]
    if isinstance(template, dict):
        return dict(zip(template.keys(), vals))
    if hasattr(template, "_fields"):
        return type(template)(*vals)
    return type(template)(vals)


def _members(path: str) -> dict:
    """The arrays of the ``np.savez`` file ``path`` by name, each a
    read-only memmap of its bytes in the file (its members are stored,
    not compressed), so a restore copies only the blocks it keeps; the
    file's integrity is the manifest's checksum, checked first. A member
    with no elements to map (0-d or empty) is read."""
    out = {}
    with zipfile.ZipFile(path) as z, open(path, "rb") as f:
        for info in z.infolist():
            name = info.filename.removesuffix(".npy")
            f.seek(info.header_offset + 26)       # the local header's lengths
            name_len, extra_len = struct.unpack("<HH", f.read(4))
            f.seek(info.header_offset + 30 + name_len + extra_len)
            major, _ = np.lib.format.read_magic(f)
            read_header = (np.lib.format.read_array_header_1_0 if major == 1
                           else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read_header(f)
            if not shape or 0 in shape:
                out[name] = np.load(z.open(info))
            else:
                out[name] = np.memmap(f, dtype=dtype, mode="r",
                                      offset=f.tell(), shape=shape,
                                      order="F" if fortran else "C")
    return out


def _is_sharded(tree) -> bool:
    kids = _children(tree)
    if kids is None:
        return sharding_of(tree) is not None
    return any(_is_sharded(child) for _, child in kids)


def _writes() -> bool:
    """Whether this rank writes a sharded tree: rank 0 of the group."""
    return not (torch.distributed.is_available()
                and torch.distributed.is_initialized()
                and torch.distributed.get_rank() != 0)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


class _Hashed:
    """A file to write once, front to back, that takes the SHA-256 of
    what is written (in a thread, beside the writes). It cannot seek, so
    ``np.savez`` streams its zip in one pass (each member's sizes after
    its data) and the hash is the file's."""

    def __init__(self, f):
        self.f, self.h, self.n = f, hashlib.sha256(), 0
        self.pool = ThreadPoolExecutor(1)
        self.pending = None

    def write(self, b) -> int:
        b = bytes(b)
        if self.pending is not None:
            self.pending.result()
        self.pending = self.pool.submit(self.h.update, b)
        self.n += len(b)
        return self.f.write(b)

    def tell(self) -> int:
        return self.n

    def read(self, *args):            # np.savez takes a file that has one
        raise OSError("a checkpoint's payload is written, not read here")

    def flush(self) -> None:
        self.f.flush()

    def hexdigest(self) -> str:
        if self.pending is not None:
            self.pending.result()
        self.pool.shutdown()
        return self.h.hexdigest()


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    # -- save ---------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = True,
             meta: Optional[dict] = None) -> str:
        """Snapshot on the caller's thread, write (optionally) async.
        ``meta`` is stored verbatim in the manifest; restore ignores
        it. A tree with ranks' blocks is gathered (every rank calls) and
        written by rank 0 alone."""
        final = self._path(step)
        writes = _writes() or not _is_sharded(tree)
        arrays = _flatten(tree, keep=writes)
        if not writes:
            return final
        manifest = {
            "schema": SCHEMA_VERSION,
            "step": int(step),
            "keys": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                     for k, v in arrays.items()},
        }
        if meta is not None:
            manifest["meta"] = meta

        def write():
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
                out = _Hashed(f)
                np.savez(out, **arrays)
                # checksum the bytes as they were written, in one pass
                manifest["checksum"] = "sha256:" + out.hexdigest()
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)          # atomic commit
            self._gc()

        self.wait()
        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        return final

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(self._path(s), ignore_errors=True)

    # -- restore ------------------------------------------------------
    def all_steps(self) -> list:
        return sorted(int(name.split("_")[1]) for name in os.listdir(self.dir)
                      if name.startswith("step_")
                      and not name.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def verify(self, step: int) -> dict:
        """Integrity-check one step's files and return its manifest;
        raises ``CheckpointCorruptError`` on an unreadable manifest, a
        newer schema, or an ``arrays.npz`` whose SHA-256 differs from
        the recorded one."""
        path = self._path(step)
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise CheckpointCorruptError(
                f"checkpoint {path}: unreadable manifest ({e}); delete "
                f"the step directory and resume from an earlier step"
            ) from e
        schema = manifest.get("schema", 1)
        if not isinstance(schema, int) or schema > SCHEMA_VERSION:
            raise CheckpointCorruptError(
                f"checkpoint {path}: schema version {schema!r} is newer "
                f"than this code understands (<= {SCHEMA_VERSION})")
        recorded = manifest.get("checksum")
        if recorded is not None:
            try:
                actual = "sha256:" + _sha256(os.path.join(path, "arrays.npz"))
            except OSError as e:
                raise CheckpointCorruptError(
                    f"checkpoint {path}: cannot read arrays.npz ({e})"
                ) from e
            if actual != recorded:
                raise CheckpointCorruptError(
                    f"checkpoint {path}: arrays.npz checksum mismatch "
                    f"(manifest {recorded}, file {actual}): the payload "
                    f"is truncated or bit-flipped")
        return manifest

    def restore(self, template: Any, step: Optional[int] = None,
                shardings: Any = None):
        """``(tree, step)``: ``template``'s structure rebuilt from the
        step's arrays (default the latest), after ``verify``.
        ``shardings`` (the template's structure, ``Sharding`` leaves or
        None) places each leaf on its mesh: pass the new mesh's for an
        elastic restore."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        self.verify(step)
        tree = _unflatten(template, _members(
            os.path.join(self._path(step), "arrays.npz")), shardings=shardings)
        return tree, step
