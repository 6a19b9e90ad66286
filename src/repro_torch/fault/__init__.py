"""Fault tolerance: elastic re-meshing + router-driven failover."""
from repro_torch.fault.elastic import (
    build_mesh,
    reshard_state,
    shrink_mesh,
    surviving_replicas,
)

__all__ = ["build_mesh", "shrink_mesh", "reshard_state",
           "surviving_replicas"]
