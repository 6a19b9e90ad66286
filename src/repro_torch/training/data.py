"""Synthetic LM data: deterministic per-step batches, and a prefetcher.

Port of ``repro/training/data.py``. A step's batch comes from a numpy
generator seeded by the step, draw for draw as the reference draws it
(the LCG token stream, the VLM's patch embeddings, the audio frames),
so the two packages train on equal arrays; the arrays become tensors on
the device last. With a ``mesh``, a rank keeps its block of each array
under the training batch's axes (``model_zoo.input_specs``: rows split
over the batch's axes), as the reference builds each host's shard. A
background thread prefetches the next batch while a step runs.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import TRAIN, ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models.model_zoo import input_specs
from repro_torch.sharding.partitioning import (Sharding, logical_to_spec,
                                               place)


def synthetic_batch(cfg: ModelConfig, shape: ShapeConfig, step: int,
                    device=None, mesh=None) -> dict:
    """One deterministic batch in the model's layout (``model_zoo``'s
    module docstring) with its ``"targets"``: int32 tokens and targets,
    float32 patches or frames, on ``device`` (default ``cuda``); with
    ``mesh``, this rank's block of each."""
    B, S = shape.global_batch, shape.seq_len
    rng = np.random.default_rng(np.uint64(0x9E3779B9) * np.uint64(step + 1))

    def lm_pair(b, s):
        """Learnable stream: an LCG next-token function (so example
        training shows real convergence, unlike pure-noise targets)."""
        v = min(cfg.vocab_size, 4093)
        toks = np.empty((b, s + 1), np.int64)
        toks[:, 0] = rng.integers(0, v, b)
        for i in range(s):
            toks[:, i + 1] = (toks[:, i] * 5 + 7) % v
        return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)

    def normal(shape_):
        return rng.standard_normal(shape_, dtype=np.float32)

    if cfg.family == "vlm":
        toks, tgts = lm_pair(B, S - cfg.num_patches)
        batch = {"patches": normal((B, cfg.num_patches, cfg.d_model)),
                 "tokens": toks, "targets": tgts}
    elif cfg.family == "audio":
        toks, tgts = lm_pair(B, min(cfg.max_decode_len, S))
        batch = {"frames": normal((B, S // 2, cfg.d_model)),
                 "tokens": toks, "targets": tgts}
    else:
        toks, tgts = lm_pair(B, S)
        batch = {"tokens": toks, "targets": tgts}
    dev = resolve_device(device)
    if mesh is None:
        return {k: torch.from_numpy(a).to(dev) for k, a in batch.items()}
    axes = input_specs(cfg, dataclasses.replace(shape, kind=TRAIN))[1]
    return {k: place(torch.from_numpy(a), Sharding(
        mesh, logical_to_spec(axes[k], mesh))).to(dev)
        for k, a in batch.items()}


def prefetch_iterator(cfg: ModelConfig, shape: ShapeConfig, device=None,
                      depth: int = 2) -> Iterator[dict]:
    """Background-thread prefetch of ``synthetic_batch`` for steps 0, 1,
    ..., ``depth`` batches ahead."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    dev = resolve_device(device)

    def worker():
        step = 0
        while not stop.is_set():
            try:
                q.put(synthetic_batch(cfg, shape, step, dev), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()
