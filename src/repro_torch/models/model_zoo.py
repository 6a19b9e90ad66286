"""Model API: ``build_model(cfg)`` -> ``Model``, an ``nn.Module`` with
``forward`` / ``prefill`` / ``decode`` / ``init_cache``.

Port of the dense and SSM paths of ``repro/models/model_zoo.py``. The
reference's ``Model`` is a tuple of pure functions over a separate
params pytree; here the module holds its weights (``model.params``), in
``cfg.dtype`` on its device, norm weights (and the SSM's ``A_log`` and
``dt_bias``) in float32.

Batches: ``{"tokens": (B, S)}`` for ``forward`` and ``prefill``;
``{"token": (B, 1), "pos": int}`` plus the cache for ``decode``. The
loss and the dry run's input specs wait for the training slice
(ROADMAP A11).

An SSM stack's decode step on a CUDA device replays a CUDA graph (one
per batch size), which issues its ~2,000 small kernels in one host
call; the step runs no kernel wrapper of the port (the state update is
plain PyTorch, as in the reference), so the replay skips no launch
count. The dense decode step calls ``decode_attention``'s wrapper,
whose count a replay would skip, and stays eager.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import SSM, ModelConfig
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


class _DecodeGraph:
    """One SSM decode step captured as a CUDA graph over static copies
    of the caches and the token. A call copies the caller's caches and
    token in, replays, and copies the caches back out, so the caller's
    caches are updated in place as by the eager step."""

    def __init__(self, params: T.Params, cfg: ModelConfig, cache: dict,
                 token: torch.Tensor):
        self.cache = {"layers": tuple(t.clone() for t in cache["layers"])}
        self.token = token.clone()
        side = torch.cuda.Stream(token.device)
        side.wait_stream(torch.cuda.current_stream(token.device))
        with torch.cuda.stream(side):                 # warm-up off capture
            T.decode_step(params, cfg, self.cache, self.token, 0)
        torch.cuda.current_stream(token.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.logits, _ = T.decode_step(params, cfg, self.cache,
                                           self.token, 0)

    def __call__(self, cache: dict, token: torch.Tensor):
        for static, given in zip(self.cache["layers"], cache["layers"]):
            static.copy_(given)
        self.token.copy_(token)
        self.graph.replay()
        for static, given in zip(self.cache["layers"], cache["layers"]):
            given.copy_(static)
        return self.logits.clone(), cache


class Model(nn.Module):
    """A dense or SSM decoder LM with its weights. ``decode_graphs``
    (default on): replay the SSM decode step as a CUDA graph on a CUDA
    device; off, every step runs eagerly."""

    def __init__(self, cfg: ModelConfig, params: T.Params):
        super().__init__()
        self.cfg = cfg
        self.params = params
        self.decode_graphs = True
        self._graphs: dict = {}

    def forward(self, batch: dict):
        """tokens (B, S) -> (logits (B, S, V), aux)."""
        x = L.embed_tokens(self.params.embed, batch["tokens"])
        h, aux, _ = T.forward(self.params, self.cfg, x)
        return T.logits_from_hidden(self.params, self.cfg, h), aux

    def prefill(self, batch: dict, max_len: int | None = None):
        """tokens (B, S) -> (last position's logits (B, 1, V), caches):
        KV caches with ``max_len`` slots, the first S filled; SSM states
        as they are (O(1) in S, nothing to pad)."""
        x = L.embed_tokens(self.params.embed, batch["tokens"])
        h, _, caches = T.forward(self.params, self.cfg, x, collect_cache=True)
        logits = T.logits_from_hidden(self.params, self.cfg, h[:, -1:])
        if self.cfg.family == SSM:
            return logits, caches
        return logits, {"layers": _pad_seq(caches["layers"], max_len)}

    def decode(self, cache: dict, batch: dict):
        """One token per row at ``batch["pos"]`` -> (logits (B, 1, V),
        cache), the cache updated in place."""
        token = batch["token"]
        if self.cfg.family == SSM and token.is_cuda and self.decode_graphs:
            # the SSM step reads no position: one graph serves every pos
            key = (tuple(token.shape), token.dtype)
            if key not in self._graphs:
                self._graphs[key] = _DecodeGraph(self.params, self.cfg,
                                                 cache, token)
            return self._graphs[key](cache, token)
        return T.decode_step(self.params, self.cfg, cache, token,
                             int(batch["pos"]))

    def init_cache(self, B: int, S: int) -> dict:
        """Zero caches for B rows: KV caches of S slots, or the SSM conv
        (compute dtype) and state (float32) caches."""
        cfg = self.cfg
        dev = self.params.final_norm.device
        dtype = T.compute_dtype(cfg)
        if cfg.family == SSM:
            conv_dim = cfg.ssm_inner + 2 * cfg.ssm_state
            conv = torch.zeros((cfg.num_layers, B, cfg.ssm_conv - 1, conv_dim),
                               dtype=dtype, device=dev)
            h = torch.zeros((cfg.num_layers, B, cfg.ssm_heads, cfg.ssm_state,
                             cfg.ssm_head_dim), dtype=torch.float32, device=dev)
            return {"layers": (conv, h)}
        shape = (cfg.num_layers, B, cfg.num_kv_heads, S, cfg.head_dim)
        return {"layers": (torch.zeros(shape, dtype=dtype, device=dev),
                           torch.zeros(shape, dtype=dtype, device=dev))}


def build_model(cfg: ModelConfig, device=None, seed: int = 0) -> Model:
    """The model with random weights at the reference's scales, drawn on
    ``device`` (default ``cuda``) from a generator seeded with ``seed``."""
    T.require_ported(cfg)
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    return Model(cfg, T.init_params(gen, cfg))
