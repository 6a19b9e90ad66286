"""CC topology emulation (paper §VII-A1).

Port of ``repro/continuum/topology.py``: a synthetic European RTT matrix
from a distance model (cities clustered in a 2400×1800 km box, RTT =
3 ms base + 0.014 ms/km + mild symmetric jitter) and the paper's greedy
k-center placement. Draws go through ``core.prand`` from the same key
as the reference, so the placement matches it exactly and the RTTs to
float32 rounding (the distance is a square root of a sum).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import fmath, prand
from repro_torch.device import resolve_device


class Topology(NamedTuple):
    rtt: torch.Tensor              # (N, N) seconds, symmetric, zero diagonal
    instance_nodes: torch.Tensor   # (M,) node index hosting each instance

    @property
    def num_nodes(self) -> int:
        return self.rtt.shape[0]

    @property
    def num_instances(self) -> int:
        return self.instance_nodes.shape[0]

    def lb_instance_rtt(self) -> torch.Tensor:
        """(N, M) RTT from every LB (one per node) to every instance."""
        return self.rtt[:, self.instance_nodes]


def european_rtt_matrix(
    key: torch.Tensor,
    n_nodes: int = 30,
    base_ms: float = 3.0,
    ms_per_km: float = 0.014,
    jitter_ms: float = 2.0,
    box_km=(2400.0, 1800.0),
    n_clusters: int = 6,
    cluster_sigma_km: float = 140.0,
) -> torch.Tensor:
    """Synthetic but realistically-ranged European RTT matrix [seconds],
    on ``key``'s device. Nodes cluster around metro areas whose
    popularity is Zipf-skewed (what makes several nodes share one
    nearest instance, the proxy-mity overload mode)."""
    kp, kj, kc, ka = prand.split(key, 4).unbind(0)
    box = torch.tensor(box_km, dtype=torch.float32, device=key.device)
    centers = prand.uniform(kc, (n_clusters, 2)) * box
    pop = 1.0 / (1.0 + torch.arange(n_clusters, dtype=torch.float32,
                                    device=key.device))
    assign = prand.categorical(ka, fmath.log(pop)[None, :].repeat(n_nodes, 1))
    pos = centers[assign] + cluster_sigma_km * prand.normal(kp, (n_nodes, 2))
    d = torch.linalg.norm(pos[:, None, :] - pos[None, :, :], dim=-1)
    jit = prand.uniform(kj, (n_nodes, n_nodes)) * jitter_ms
    jit = (jit + jit.T) / 2.0
    rtt_ms = base_ms + ms_per_km * d + jit
    rtt_ms = rtt_ms * (1.0 - torch.eye(n_nodes, device=key.device))
    return rtt_ms / 1e3


def k_center_placement(rtt: np.ndarray, n_instances: int) -> np.ndarray:
    """Greedy k-center (paper §VII-A3): iteratively pick the node
    farthest (in network distance) from the chosen centers."""
    rtt = np.asarray(rtt)
    centers = [int(np.argmin(rtt.sum(1)))]          # start at the medoid
    while len(centers) < n_instances:
        d = rtt[:, centers].min(axis=1)
        d[centers] = -1.0
        centers.append(int(np.argmax(d)))
    return np.asarray(sorted(centers), dtype=np.int32)


def make_topology(key: torch.Tensor | int, n_nodes: int = 30,
                  n_instances: int = 10, device=None) -> Topology:
    """Topology from a key (or an integer seed, as ``PRNGKey(seed)``);
    the tensors live on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    if isinstance(key, int):
        key = prand.prng_key(key, dev)
    rtt = european_rtt_matrix(key.to(dev), n_nodes)
    placement = k_center_placement(rtt.cpu().numpy(), n_instances)
    return Topology(rtt=rtt, instance_nodes=torch.as_tensor(
        placement, dtype=torch.int64, device=dev))
