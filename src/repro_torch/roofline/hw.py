"""NVIDIA H100 SXM roofs for the roofline model (per card).

Port of ``repro/roofline/hw.py``, whose table is the TPU v5e's. Every
figure here is from NVIDIA's H100 data sheet for the "NVIDIA H100 80GB
HBM3" SXM part at its 700 W limit; none is a measurement. A card set
below 700 W runs slower under load (``nvidia-smi``'s ``power.limit``).
"""
import torch

CARD = "NVIDIA H100 80GB HBM3, 700 W (data sheet)"

PEAK_FLOPS_BF16 = 989e12        # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12                # bytes/s, HBM3
NVLINK_LINKS = 18               # NVLink 4 links a card
NVLINK_BW = 900e9               # bytes/s a card, both directions, all links
NVLINK_BW_PER_LINK = NVLINK_BW / NVLINK_LINKS   # 50 GB/s a link

# bytes an element, by torch dtype
BYTES = {
    torch.bool: 1, torch.int8: 1, torch.uint8: 1, torch.int16: 2,
    torch.bfloat16: 2, torch.float16: 2, torch.int32: 4, torch.float32: 4,
    torch.int64: 8, torch.float64: 8, torch.complex64: 8,
    torch.complex128: 16,
}
