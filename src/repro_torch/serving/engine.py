"""Serving engine: prefill/decode with replica-routed batches.

Port of ``repro/serving/engine.py``. ``ServingEngine`` owns one model
replica's executor; the ``QEdgeRouter`` (router.py) distributes
microbatches across engines and consumes their measured latencies as
bandit feedback. The reference takes ``(model, params)``; the port's
``Model`` holds its weights, so the engine takes the model alone.
"""
from __future__ import annotations

import time

import torch

from repro_torch.models import Model


def _sync(x: torch.Tensor) -> None:
    """Wait for the card (the counterpart of ``block_until_ready``)."""
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


class ServingEngine:
    """Single-replica prefill/decode executor with timing."""

    def __init__(self, model: Model, max_len: int,
                 extra_latency: float = 0.0):
        self.model = model
        self.max_len = max_len
        self.extra_latency = extra_latency    # emulated network distance

    def prefill(self, batch):
        t0 = time.monotonic()
        logits, cache = self.model.prefill(batch, max_len=self.max_len)
        _sync(logits)
        return logits, cache, time.monotonic() - t0 + self.extra_latency

    def decode(self, cache, token, pos):
        t0 = time.monotonic()
        logits, cache = self.model.decode(cache, {"token": token, "pos": pos})
        _sync(logits)
        return logits, cache, time.monotonic() - t0 + self.extra_latency


def generate(model: Model, prompt: torch.Tensor, steps: int,
             max_len: int | None = None, greedy: bool = True,
             generator: torch.Generator | None = None) -> torch.Tensor:
    """Simple generation loop (prefill + ``steps`` decode steps) ->
    (B, steps) int32 tokens. Greedy takes the argmax; otherwise tokens
    are sampled from the softmax with ``generator``."""
    B, S = prompt.shape
    max_len = max_len or (S + steps)
    logits, cache = model.prefill({"tokens": prompt}, max_len=max_len)

    def pick(lg, sample: bool):
        if not sample:
            return lg[:, -1].argmax(-1)[:, None].to(torch.int32)
        probs = torch.softmax(lg[:, -1].float(), dim=-1)
        return torch.multinomial(probs, 1, generator=generator).to(torch.int32)

    out = []
    tok = pick(logits, False)
    for i in range(steps):
        out.append(tok)
        logits, cache = model.decode(cache, {"token": tok, "pos": S + i})
        tok = pick(logits, not greedy and generator is not None)
    return torch.cat(out, dim=1)
