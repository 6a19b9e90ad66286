"""Build the port's CUDA kernels and bind them with ctypes.

Every ``csrc/*.cu`` source is compiled for ``sm_90a`` by its own
``nvcc``, all started together, and the objects are linked into
``build/repro_torch/libreprotorch.so`` at the root of the checkout;
each source exports plain C launch functions, which the kernel modules
bind through ``function``. The build happens at the first launch in a
process (and again whenever a source is newer than the library), so
running ``chip_smoke.py`` alone builds everything.

``--fmad=false`` is part of the contract, not a tuning flag: the
kernels must round ``a * b + c`` as two operations, as the plain
PyTorch versions do, or a latency moves across tau and a choice across
a tie. ``--ptxas-options=-v`` keeps each kernel's register and shared-memory
use in ``BUILD_DIR / "build.log"``.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIBRARY = BUILD_DIR / "libreprotorch.so"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH, "-std=c++17", "-O3", "--fmad=false",
                 "-Xcompiler", "-fPIC", "--ptxas-options=-v")

_lib: ctypes.CDLL | None = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME`` or
    ``/usr/local/cuda``; raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of repro_torch cannot be built on this machine")


def _run(cmds: list[list[str]]) -> str:
    """Run the commands in parallel; raise with the compiler's output
    if any fails, else return the output of all."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    logs, failed = [], []
    for cmd, p in procs:
        out = p.communicate()[0]
        logs.append(f"$ {' '.join(cmd)}\n{out}")
        if p.returncode != 0:
            failed.append(f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n"
                          f"{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(logs)


def build() -> float:
    """Compile every source (one ``nvcc`` each, in parallel) and link
    ``LIBRARY``; returns the seconds taken. Raises with the compiler's
    output when a step fails."""
    nv = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    objs = [BUILD_DIR / f"{src.stem}.o" for src in sources()]
    log = _run([[nv, *COMPILE_FLAGS, "-c", str(src), "-o", str(obj)]
                for src, obj in zip(sources(), objs)])
    tmp = LIBRARY.with_suffix(f".{os.getpid()}.tmp")
    log += _run([[nv, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]])
    os.replace(tmp, LIBRARY)
    (BUILD_DIR / "build.log").write_text(log)
    return time.perf_counter() - t0


def _stale() -> bool:
    if not LIBRARY.is_file():
        return True
    built = LIBRARY.stat().st_mtime
    return any(src.stat().st_mtime > built for src in CSRC.iterdir())


def load() -> ctypes.CDLL:
    """The kernel library, built first if it is missing or stale."""
    global _lib
    if _lib is None:
        if _stale():
            build()
        _lib = ctypes.CDLL(str(LIBRARY))
    return _lib


def function(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """A launch function of the library with its C signature declared;
    every launch function returns the ``cudaError_t`` of its launch."""
    fn = getattr(load(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(err: int, name: str) -> None:
    """Raise when a launch function reports a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def refuse_grad(name: str, *tensors) -> None:
    """Raise where autograd would need a backward this kernel does not
    have: grad mode on and a floating-point input that requires grad.
    Without this the kernel's output, a fresh tensor with no
    ``grad_fn``, would cut the graph and lose the gradient in silence.
    On the CPU the plain versions keep their autograd."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in tensors
            if isinstance(t, torch.Tensor) and t.is_floating_point()):
        raise RuntimeError(f"{name}: the CUDA kernel has no backward; an "
                           f"input requires grad (run it under "
                           f"torch.no_grad(), or train on the CPU)")
