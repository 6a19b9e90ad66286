"""Serving runtime of the port: engines, generation, QEdgeProxy replica
routing."""
from repro_torch.serving.engine import ServingEngine, generate
from repro_torch.serving.router import QEdgeRouter

__all__ = ["ServingEngine", "generate", "QEdgeRouter"]
