"""Model API: ``build_model(cfg)`` -> ``Model``, an ``nn.Module`` with
``forward`` / ``prefill`` / ``decode`` / ``init_cache``.

Port of the dense path of ``repro/models/model_zoo.py``. The reference's
``Model`` is a tuple of pure functions over a separate params pytree;
here the module holds its weights (``model.params``), in ``cfg.dtype``
on its device, norm weights in float32.

Batches: ``{"tokens": (B, S)}`` for ``forward`` and ``prefill``;
``{"token": (B, 1), "pos": int}`` plus the cache for ``decode``. The
loss and the dry run's input specs wait for the training slice
(ROADMAP A11).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def _pad_seq(kv: tuple, max_len: int | None) -> tuple:
    """Grow a full (non-ring) KV cache's seq axis to max_len slots."""
    k, v = kv
    S = k.shape[-2]
    if max_len is None or max_len <= S:
        return kv
    pad = (0, 0, 0, max_len - S)
    return F.pad(k, pad), F.pad(v, pad)


class Model(nn.Module):
    """A dense decoder LM with its weights."""

    def __init__(self, cfg: ModelConfig, params: T.Params):
        super().__init__()
        self.cfg = cfg
        self.params = params

    def forward(self, batch: dict):
        """tokens (B, S) -> (logits (B, S, V), aux)."""
        x = L.embed_tokens(self.params.embed, batch["tokens"])
        h, aux, _ = T.forward(self.params, self.cfg, x)
        return T.logits_from_hidden(self.params, self.cfg, h), aux

    def prefill(self, batch: dict, max_len: int | None = None):
        """tokens (B, S) -> (last position's logits (B, 1, V), caches with
        ``max_len`` slots, the first S filled)."""
        x = L.embed_tokens(self.params.embed, batch["tokens"])
        h, _, caches = T.forward(self.params, self.cfg, x, collect_cache=True)
        logits = T.logits_from_hidden(self.params, self.cfg, h[:, -1:])
        return logits, {"layers": _pad_seq(caches["layers"], max_len)}

    def decode(self, cache: dict, batch: dict):
        """One token per row at ``batch["pos"]`` -> (logits (B, 1, V),
        cache), the cache updated in place."""
        return T.decode_step(self.params, self.cfg, cache, batch["token"],
                             int(batch["pos"]))

    def init_cache(self, B: int, S: int) -> dict:
        cfg = self.cfg
        shape = (cfg.num_layers, B, cfg.num_kv_heads, S, cfg.head_dim)
        dev = self.params.final_norm.device
        dtype = T.compute_dtype(cfg)
        return {"layers": (torch.zeros(shape, dtype=dtype, device=dev),
                           torch.zeros(shape, dtype=dtype, device=dev))}


def build_model(cfg: ModelConfig, device=None, seed: int = 0) -> Model:
    """The model with random weights at the reference's scales, drawn on
    ``device`` (default ``cuda``) from a generator seeded with ``seed``."""
    T.require_dense(cfg)
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    return Model(cfg, T.init_params(gen, cfg))
