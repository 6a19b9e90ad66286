"""Roofline analysis of traced dry-run cells, with the H100's roofs."""
from repro_torch.roofline.analysis import (
    collective_bytes,
    collective_trace,
    model_flops,
    roofline_terms,
)
from repro_torch.roofline import hw

__all__ = ["collective_bytes", "collective_trace", "roofline_terms",
           "model_flops", "hw"]
