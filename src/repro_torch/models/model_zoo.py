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

On a CUDA device ``decode`` replays the decode step as a CUDA graph
(one per batch, cache shape and dtype; ``decode_graphs`` off runs every
step eagerly). A graph issues the step's kernels (~1,600 for the dense
stack, ~2,000 for the SSM stack) in one host call. It runs over static
copies of the caches, the token and the position: the dense step reads
its position from a device tensor (``transformer.decode_step``), so one
graph serves every position.

The caller's cache. ``decode`` returns the cache it was given, updated
in place as by the eager step; a caller may read it, pass it to the
next ``decode`` or drop it. The graph keeps its own copy and copies the
caller's cache in only when it does not already hold it: when the
caller passes another cache object (a new microbatch after its prefill,
or two microbatches in turn) or changed this one since the last call
(any in-place PyTorch write bumps a tensor's version counter). A step
then moves only what it writes: one slot of every layer's K and V back
into the caller's cache for a dense stack (~0.6 MB at qwen3-4b's batch
4), the whole state for an SSM stack (every element changes). A caller
must not write into the cache other than through PyTorch (a kernel of
its own through ``data_ptr()``), or the graph misses the change.

Launch counts. A capture records kernels and runs none, so the launches
the kernel wrappers count while the step is captured are taken back,
and added again on every replay: ``decode_attention``'s count stays one
per layer per decode call. The first call of a graph runs the step
eagerly (the warm-up a capture needs), and its answer is that call's.
"""
from __future__ import annotations

import weakref

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import SSM, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
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
    """One decode step captured as a CUDA graph over static copies of the
    caches, the token and the position (the module docstring says what a
    caller may do with its cache)."""

    def __init__(self, params: T.Params, cfg: ModelConfig, cache: dict,
                 token: torch.Tensor):
        self.params, self.cfg = params, cfg
        self.cache = {"layers": tuple(torch.empty_like(t)
                                      for t in cache["layers"])}
        self.token = torch.empty_like(token)
        self.pos = torch.zeros(1, dtype=torch.int64, device=token.device)
        self.held: list | None = None      # (weakref, version) of each held
        self.graph: torch.cuda.CUDAGraph | None = None
        self.replay_launches: list[int] = []

    def _step(self) -> torch.Tensor:
        return T.decode_step(self.params, self.cfg, self.cache, self.token,
                             self.pos)[0]

    def _capture(self) -> torch.Tensor:
        """Run the step eagerly on a side stream (the warm-up), then capture
        it; returns the eager step's logits."""
        dev = self.token.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            logits = self._step()
        torch.cuda.current_stream(dev).wait_stream(side)
        logits.record_stream(torch.cuda.current_stream(dev))
        before = [fn.launches for fn in ops.WRAPPERS]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.logits = self._step()
        self.graph = graph
        self.replay_launches = [fn.launches - n
                                for fn, n in zip(ops.WRAPPERS, before)]
        for fn, n in zip(ops.WRAPPERS, self.replay_launches):
            fn.launches -= n                  # the capture launched nothing
        return logits

    def _holds(self, given: tuple) -> bool:
        return self.held is not None and all(
            ref() is t and t._version == version
            for (ref, version), t in zip(self.held, given))

    def __call__(self, cache: dict, token: torch.Tensor, pos: int):
        given = cache["layers"]
        if not self._holds(given):
            for static, t in zip(self.cache["layers"], given):
                static.copy_(t)
        self.token.copy_(token)
        self.pos.fill_(pos)
        if self.graph is None:
            logits = self._capture()
        else:
            self.graph.replay()
            for fn, n in zip(ops.WRAPPERS, self.replay_launches):
                fn.launches += n
            logits = self.logits.clone()
        for static, t in zip(self.cache["layers"], given):
            if self.cfg.family == SSM:
                t.copy_(static)
            else:                             # (L, B, Hkv, S, D): slot pos
                t[:, :, :, pos].copy_(static[:, :, :, pos])
        self.held = [(weakref.ref(t), t._version) for t in given]
        return logits, cache


class Model(nn.Module):
    """A dense or SSM decoder LM with its weights. ``decode_graphs``
    (default on): replay the decode step as a CUDA graph on a CUDA
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
        cache), the cache updated in place. A dense cache must have a slot
        at pos."""
        token, pos = batch["token"], int(batch["pos"])
        first = cache["layers"][0]
        if self.cfg.family != SSM and not 0 <= pos < first.shape[3]:
            raise IndexError(f"position {pos} outside the cache's "
                             f"{first.shape[3]} slots")
        if token.is_cuda and self.decode_graphs:
            key = (tuple(token.shape), token.dtype, tuple(first.shape),
                   first.dtype)
            if key not in self._graphs:
                self._graphs[key] = _DecodeGraph(self.params, self.cfg,
                                                 cache, token)
            return self._graphs[key](cache, token, pos)
        return T.decode_step(self.params, self.cfg, cache, token, pos)

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
