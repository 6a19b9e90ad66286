"""QEdgeProxy in PyTorch for NVIDIA Hopper.

A module-for-module port of the JAX package ``repro``: each file here
sits at the same relative path as its reference (``bench/`` mirrors
the repo's ``benchmarks/``). Plain tensor code is
PyTorch; the TPU kernels on the simulator's main path are CUDA C++ for
``sm_90a`` (``kernels/csrc``), with plain PyTorch versions beside them
that the CPU runs. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"`` (``repro_torch.device.resolve_device``).
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
