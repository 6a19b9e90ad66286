"""QEdgeProxy replica router: the paper's technique as the serving
framework's request scheduler.

Port of ``repro/serving/router.py``. *Players* are front-end request
shards (one per ingress), *arms* are model replicas. Rewards stay
heterogeneous (front-end <-> replica distance, per-replica load) and
collisions stay implicit (two front-ends picking the same replica
lengthen its batch queue), as in the paper's MP-MAB.

The bandit state lives on the router's device and goes through the
port's ``core.bandit``: on the card, ``maintenance`` runs the CUDA
maintenance kernel. Every membership change lands in ``self.events``
as ``(t_seconds, kind, entity, value)``, and ``export_trace`` writes it
as a Chrome trace.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import bandit as qb
from repro_torch.core import prand
from repro_torch.device import resolve_device


class QEdgeRouter:
    """Routes request microbatches from K front-ends to M replicas."""

    def __init__(
        self,
        num_frontends: int,
        num_replicas: int,
        params: Optional[qb.BanditParams] = None,
        rtt: Optional[np.ndarray] = None,   # (K, M) static distance [s]
        ring: int = 64,
        seed: int = 0,
        device=None,
    ):
        self.K, self.M = num_frontends, num_replicas
        self.device = resolve_device(device)
        self.params = params or qb.BanditParams()
        self.rtt = torch.as_tensor(
            rtt if rtt is not None else np.zeros((self.K, self.M)),
            dtype=torch.float32).to(self.device)
        self.state = qb.init_state(
            self.K, self.M, self.params, ring=ring,
            key=prand.prng_key(seed, self.device), device=self.device)
        self.t0 = time.monotonic()
        self.events: List[tuple] = []

    def _now(self) -> float:
        return time.monotonic() - self.t0

    def _log(self, kind: str, entity: int, value: float):
        self.events.append((self._now(), kind, int(entity), float(value)))

    # -- request path -------------------------------------------------
    def route(self) -> np.ndarray:
        """Pick a replica for each front-end's next microbatch. (K,)"""
        choice, self.state, _ = qb.select(self.state)
        return choice.cpu().numpy()

    def feedback(self, choice: Sequence[int], latency: Sequence[float],
                 mask: Optional[Sequence[bool]] = None):
        """Report measured per-microbatch latencies (seconds)."""
        dev = self.device
        m = (torch.ones(self.K, dtype=torch.bool, device=dev) if mask is None
             else torch.as_tensor(np.asarray(mask, bool)).to(dev))
        self.state = qb.record(
            self.state, self.params,
            torch.as_tensor(np.asarray(choice, np.int32)).to(dev),
            torch.as_tensor(np.asarray(latency, np.float32)).to(dev),
            self._now(), m)

    def maintenance(self):
        self.state = qb.maintenance(self.state, self.params, self.rtt,
                                    self._now())

    # -- elastic / fault hooks (paper Alg 3/4) ------------------------
    def replicas_changed(self, active: Sequence[bool]):
        act = np.asarray(active, bool)
        self._log("replicas_changed", -1, float(act.sum()))
        self.state = qb.sync_active(self.state, self.params,
                                    torch.as_tensor(act).to(self.device))

    def replica_failed(self, idx: int):
        self._log("replica_failed", idx, 0.0)
        act = self.state.active.cpu().numpy().copy()
        act[idx] = False
        self.replicas_changed(act)

    def replica_joined(self, idx: int):
        self._log("replica_joined", idx, 1.0)
        act = self.state.active.cpu().numpy().copy()
        act[idx] = True
        self.replicas_changed(act)

    def mesh_resized(self, surviving_rows: int):
        """Elastic re-mesh hook (``fault/elastic.py`` step 3): after the
        runtime shrinks the data axis, mask every replica beyond the
        surviving rows so no microbatch routes to a dead replica group:
        Alg 4 at once, not after the error-count cooldown trips.
        Growing back to ``M`` rows re-enters replicas through the Alg 3
        zero-weight ramp."""
        from repro_torch.fault.elastic import surviving_replicas
        self._log("mesh_resized", -1, float(surviving_rows))
        self.replicas_changed(surviving_replicas(self.M, surviving_rows))

    def export_trace(self, path: str) -> dict:
        """Write the membership log as a Chrome trace (one ``router``
        process lane, one thread an event kind, instants at the log's
        host wall time); it loads in Perfetto beside a simulator trace
        of the same run."""
        from repro_torch.obs import trace as obs_trace
        pid, named, evs = 2, set(), []
        kinds = []
        for _, kind, _, _ in self.events:
            if kind not in kinds:
                kinds.append(kind)
        for t, kind, entity, value in self.events:
            tid = kinds.index(kind) + 1
            if not named:
                evs.append(obs_trace.meta_event(pid, 0, "process_name",
                                                "router"))
                named.add(None)
            if kind not in named:
                evs.append(obs_trace.meta_event(pid, tid, "thread_name",
                                                kind))
                named.add(kind)
            evs.append({"ph": "i", "s": "t", "pid": pid, "tid": tid,
                        "name": kind, "cat": "router", "ts": t * 1e6,
                        "args": {"entity": entity, "value": value}})
        return obs_trace.write_chrome_trace(path, evs)

    # -- introspection -------------------------------------------------
    @property
    def weights(self) -> np.ndarray:
        return self.state.weights.cpu().numpy()

    @property
    def qos_estimates(self) -> np.ndarray:
        return self.state.mu_hat.cpu().numpy()

    def in_cooldown(self) -> np.ndarray:
        return (self.state.cooldown_until > self._now()).cpu().numpy()
