"""The port's kernels: CUDA C++ for ``sm_90a`` in ``csrc/``, bound with
ctypes (``_build.py``), one wrapper module per TPU kernel file it
replaces (``kde.py``, ``round_fused.py``, ``flash_attention.py``,
``decode_attention.py``, ``ssd.py``), their plain PyTorch versions in
``ref.py``, and the device dispatch in ``ops.py``. Nothing here builds
or loads the CUDA library at import time.
"""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
