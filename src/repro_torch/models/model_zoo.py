"""Model API: ``build_model(cfg)`` -> ``Model``, an ``nn.Module`` with
``forward`` / ``loss`` / ``prefill`` / ``decode`` / ``init_cache``.

Port of ``repro/models/model_zoo.py`` for every family: the decoders
(dense, MoE, SSM, hybrid, gemma3 local/global), the VLM (a decoder whose
input is a patch-embedding prefix before the tokens) and the Whisper
encoder-decoder (``whisper.py``). The reference's ``Model`` is a tuple
of pure functions over a separate params pytree; here the module holds
its weights (``model.params``), in ``cfg.dtype`` on its device, norm
weights (and the SSM's ``A_log`` and ``dt_bias``, the MoE router) in
float32.

Batches for ``forward`` and ``prefill``: ``{"tokens": (B, S)}``; the
VLM adds ``"patches"`` (B, P, d), cast to the compute dtype and put
before the token embeddings (decode positions then start at P + S);
Whisper takes ``{"frames": (B, Se, d), "tokens": (B, Sd)}``. ``decode``
takes ``{"token": (B, 1), "pos": int}`` plus the cache. ``loss(batch,
remat=True)`` adds ``"targets"`` (the tokens' shape) to a forward batch:
the mean token cross-entropy of the float32 logits (the VLM scores its
text positions only; the MoE adds ``MOE_AUX_WEIGHT`` times its balance
loss), with ``remat`` checkpointing each layer (``transformer``).

Sharding. ``param_axes()`` gives every weight's logical axes keyed by
its parameter name (the reference's tree without its stacking axes),
``cache_axes()`` the caches' (stacked, as the reference's), and
``input_specs(shape)`` the batch's ``(shape, dtype)`` and axes.
``shard(mesh)`` keeps this rank's block of every weight under
``sharding``'s rules (``tree_shardings`` of ``param_axes``, each weight
tagged with its ``Sharding``); under ``with mesh:`` the model then
computes on its blocks: the batch split over ``data`` (and ``pod``),
heads, FFN columns, experts and the vocabulary over ``model``, the
weights' d_model rows over ``data`` (FSDP, gathered per layer). ``loss``
is then the whole batch's, equal on every rank: each rank's token
losses are summed over the batch's ranks, and the vocabulary's share
of each log-sum-exp over the vocabulary's. ``forward``'s logits are the
rank's share of the vocabulary. A dim that its mesh axes do not divide
stays whole (``fit_spec``, as the reference's dry run fits its specs);
the SSM's packed columns split by head group (``ssm.head_order``).

Serving on a mesh. ``prefill`` and ``decode`` take the rank's rows of
the batch (``shard_batch``) and return their logits gathered over the
vocabulary, so every rank of a row's group picks the same token. The
caches are laid out by ``cache_axes`` under the active rules
(``tree_shardings``, fitted), each tagged with its ``Sharding``:
prefill computes its rows' K/V on its heads and re-lays them so
(``collectives.relay``), and decode attends in that layout, over a
slice of the slots where the rules split them (``ctx``; the reference
dry run's decode layouts, ``attention.decode_attend``). Its
collectives go through gloo on the host, so a sharded model's decode
runs eagerly, never as a CUDA graph.

Training. Every weight is made with ``requires_grad`` off, so serving
builds no autograd graph and its times and memory are what they were
before the model could train; ``trainable()`` switches a whole model's
weights on, which the trainer (``launch/train.py``) calls and serving
never does.

Caches (``transformer``'s module docstring has their layout): a layer
with a sliding window keeps a ring of ``window`` slots (prefill fills
it through ``_to_ring``; decode writes slot ``pos % W``), a layer
without one a full cache of ``max_len`` slots (decode writes slot
``pos``), an SSM layer its conv and SSM states (decode rewrites them
whole). Whisper's cache is ``{"layers": (k_self, v_self, k_cross,
v_cross)}`` (the reference returns the bare tuple): the self K/V a ring
of ``max_decode_len`` slots, the cross K/V the encoder's, which decode
reads and never writes. A model's ``layout`` names which is which
(``transformer.cache_layout``, ``whisper.CACHE_LAYOUT``).

On a CUDA device ``decode`` replays the decode step as a CUDA graph
(one per batch and cache shapes and dtypes; ``decode_graphs`` off runs
every step eagerly). A graph issues the step's kernels (~1,600 for the
dense stack, ~2,000 for the SSM stack) in one host call. It runs over
static copies of the caches, the token and the position: the step reads
its position from a device tensor (``transformer.decode_step``; a
ring's slot ``pos % W`` too), so one graph serves every position.

The caller's cache. ``decode`` returns the cache it was given, updated
in place as by the eager step; a caller may read it, pass it to the
next ``decode`` or drop it. The graph keeps its own copy and copies the
caller's cache in only when it does not already hold it: when the
caller passes another cache object (a new microbatch after its prefill,
or two microbatches in turn) or changed this one since the last call
(any in-place PyTorch write bumps a tensor's version counter). A step
then moves only what it writes: one slot of every layer's K and V
(slot ``pos`` of a full cache, ``pos % W`` of a ring) back into the
caller's cache (~0.6 MB at qwen3-4b's batch 4), and every SSM state
whole (every element changes); a read-only cache (Whisper's cross K/V)
is never copied back. A caller must not write into the cache
other than through PyTorch (a kernel of its own through
``data_ptr()``), or the graph misses the change.

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

from repro_torch.configs.base import (AUDIO, HYBRID, SSM, VLM, ModelConfig,
                                      ShapeConfig)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models import whisper
from repro_torch.models import attention as A
from repro_torch.models import ssm as M
from repro_torch.sharding.collectives import (all_gather, axis_of,
                                              batch_axes, gathers, reduce,
                                              reduce_max, relay)
from repro_torch.sharding.partitioning import (Sharding, fitted,
                                               place, spec_axes, tag,
                                               tree_shardings)

MOE_AUX_WEIGHT = 0.01


def _xent(logits: torch.Tensor, targets: torch.Tensor,
          vocab=None) -> torch.Tensor:
    """Mean token cross-entropy of the logits taken to float32. On a mesh
    the logits are this rank's share of the vocabulary (split over the
    mesh axis ``vocab``) and the tokens its share of the batch; the mean
    is the whole batch's (the module docstring)."""
    lf = logits.float()
    batch = axis_of("batch")
    if vocab is None:
        logz = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, targets[..., None].long())[..., 0]
    else:
        top = reduce_max(lf.amax(-1), vocab)
        logz = top + torch.log(reduce(
            torch.exp(lf - top[..., None]).sum(-1), vocab))
        local = targets.long() - vocab.index * lf.shape[-1]
        inside = (local >= 0) & (local < lf.shape[-1])
        gold = torch.gather(lf, -1, torch.where(inside, local, 0)[..., None])
        gold = reduce(gold[..., 0] * inside, vocab)
    if batch is None:
        return (logz - gold).mean()
    return reduce((logz - gold).sum(), batch) / (targets.numel() * batch.size)


def input_specs(cfg: ModelConfig, shape: ShapeConfig):
    """``(specs, axes)`` of a batch of ``shape``: each input's ``(shape,
    dtype)`` and logical axes, as the reference's ``input_specs``."""
    B, S = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    if shape.kind not in ("train", "prefill"):
        return ({"token": ((B, 1), i32), "pos": ((), i32)},
                {"token": ("batch", None), "pos": ()})
    if cfg.family == AUDIO:
        St = min(cfg.max_decode_len, S)
        specs = {"frames": ((B, S // 2, cfg.d_model), bf16)}
        axes = {"frames": ("batch", None, None)}
    elif cfg.family == VLM:
        St = S - cfg.num_patches
        specs = {"patches": ((B, cfg.num_patches, cfg.d_model), bf16)}
        axes = {"patches": ("batch", None, None)}
    else:
        St, specs, axes = S, {}, {}
    specs["tokens"], axes["tokens"] = ((B, St), i32), ("batch", None)
    if shape.kind == "train":
        specs["targets"], axes["targets"] = ((B, St), i32), ("batch", None)
    return specs, axes


def _cache_len(cfg: ModelConfig, S: int) -> int:
    if cfg.sliding_window is not None and cfg.local_global_pattern is None:
        return min(S, cfg.sliding_window)
    return S


def _to_ring(kv: tuple, W: int) -> tuple:
    """(..., S, D) full caches -> (..., W, D) rings with position t in slot
    t % W: padded when S <= W, else the last W positions rotated into
    their slots."""
    k, v = kv
    S = k.shape[-2]
    if S <= W:
        pad = (0, 0, 0, W - S)
        return F.pad(k, pad), F.pad(v, pad)
    # position S - W + i goes to slot (S - W + i) % W: a rotation by S % W
    return tuple(torch.roll(t[..., S - W:, :], S % W, dims=-2) for t in kv)


def _pad_seq(kv: tuple, max_len: int | None) -> tuple:
    """Grow a full (non-ring) KV cache's seq axis to max_len slots."""
    k, v = kv
    S = k.shape[-2]
    if max_len is None or max_len <= S:
        return kv
    pad = (0, 0, 0, max_len - S)
    return F.pad(k, pad), F.pad(v, pad)


def _flat(cache: dict, layout: dict) -> list:
    """The cache's tensors in ``layout`` order."""
    return [t for key in layout for t in cache[key]]


class _DecodeGraph:
    """One decode step captured as a CUDA graph over static copies of the
    caches, the token and the position (the module docstring says what a
    caller may do with its cache); ``step`` and ``layout`` are the
    model's."""

    def __init__(self, params, cfg: ModelConfig, cache: dict,
                 token: torch.Tensor, step, layout: dict):
        self.params, self.cfg, self.step = params, cfg, step
        self.layout = layout
        self.kinds = [kind for key in self.layout for kind in self.layout[key]]
        self.cache = {key: tuple(torch.empty_like(t) for t in cache[key])
                      for key in self.layout}
        self.token = torch.empty_like(token)
        self.pos = torch.zeros(1, dtype=torch.int64, device=token.device)
        self.held: list | None = None      # (weakref, version) of each held
        self.graph: torch.cuda.CUDAGraph | None = None
        self.replay_launches: list[int] = []

    def _step(self) -> torch.Tensor:
        return self.step(self.params, self.cfg, self.cache, self.token,
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
        given = _flat(cache, self.layout)
        static = _flat(self.cache, self.layout)
        if not self._holds(given):
            for s, t in zip(static, given):
                s.copy_(t)
        self.token.copy_(token)
        self.pos.fill_(pos)
        if self.graph is None:
            logits = self._capture()
        else:
            self.graph.replay()
            for fn, n in zip(ops.WRAPPERS, self.replay_launches):
                fn.launches += n
            logits = self.logits.clone()
        for s, t, kind in zip(static, given, self.kinds):
            if kind == T.STATE:
                t.copy_(s)
            elif kind in (T.RING, T.FULL):  # (..., slots, D): the slot written
                i = pos % t.shape[-2] if kind == T.RING else pos
                t.select(-2, i).copy_(s.select(-2, i))
        self.held = [(weakref.ref(t), t._version) for t in given]
        return logits, cache


class Model(nn.Module):
    """A decoder of any family with its weights (``WhisperModel`` is the
    encoder-decoder). ``decode_graphs`` (default on): replay the decode
    step as a CUDA graph on a CUDA device; off, every step runs
    eagerly."""

    step = staticmethod(T.decode_step)
    _axes = staticmethod(T.param_axes)
    _cache_axes = staticmethod(T.cache_axes)

    def __init__(self, cfg: ModelConfig, params: T.Params | whisper.Params):
        super().__init__()
        self.cfg = cfg
        self.params = params
        self.layout = self._layout(cfg)
        self.decode_graphs = True
        self._graphs: dict = {}
        self.mesh = None

    def param_axes(self) -> dict:
        """``{parameter name: logical axes}`` for every weight (the module
        docstring)."""
        tree, out = self._axes(self.cfg), {}
        for name, _ in self.named_parameters():
            node = tree
            for part in name.split(".")[1:]:
                if not part.isdigit():           # a layer's index
                    node = node[part]
            out[name] = node
        return out

    def cache_axes(self) -> dict:
        """The caches' logical axes, laid out as ``init_cache``'s dict."""
        return self._cache_axes(self.cfg)

    def input_specs(self, shape: ShapeConfig):
        """``(specs, axes)`` of a batch of ``shape`` (``input_specs``)."""
        return input_specs(self.cfg, shape)

    def shard(self, mesh) -> "Model":
        """Keep this rank's block of every weight on ``mesh`` under the
        active rules, each weight tagged with its ``Sharding``; returns
        the model, which then runs under ``with mesh:`` (the module
        docstring)."""
        if self.mesh is not None:
            raise ValueError("the model is sharded already")
        shardings = self.param_shardings(mesh)
        for name, p in self.named_parameters():
            p.data = place(p.data, shardings[name])
            tag(p, shardings[name])
        self.mesh = mesh
        return self

    def param_shardings(self, mesh) -> dict:
        """``{parameter name: Sharding}`` of every weight on ``mesh`` under
        the active rules, each fitted to its shape (``fitted``); the SSM's
        packed columns in ``ssm.head_order`` where its heads split so
        (else as fitted, and gathered whole at use: ``ssm.usable``)."""
        shapes = {n: tuple(p.shape) for n, p in self.named_parameters()}
        out = tree_shardings(self.param_axes(), mesh, shapes=shapes)
        packed = {"in_proj": (1, "in_proj"), "conv_w": (1, "conv"),
                  "conv_b": (0, "conv")}
        for name, s in out.items():
            parts = name.split(".")
            if "ssm" not in parts or parts[-1] not in packed:
                continue
            dim, kind = packed[parts[-1]]
            ways = mesh.ways(spec_axes(s.spec[dim]))
            if ways > 1 and M.can_split(self.cfg, ways):
                out[name] = s._replace(order=(dim, M.head_order(
                    self.cfg, ways, kind)))
        return out

    def shard_batch(self, batch: dict) -> dict:
        """This rank's rows of a whole batch (``prefill``'s or
        ``decode``'s) on the active mesh: each input placed by its
        ``input_specs`` axes; ``pos`` as it is."""
        axes = {"tokens": ("batch", None), "token": ("batch", None),
                "patches": ("batch", None, None),
                "frames": ("batch", None, None)}
        return {k: place(v, fitted(v.shape, axes[k])) if k in axes else v
                for k, v in batch.items()}

    def _serve_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """The rank's logits gathered over the vocabulary (the module
        docstring)."""
        ax = L.vocab_axis(self.params.embed)
        return logits if ax is None else all_gather(logits, ax, -1)

    def _place_caches(self, caches: dict) -> dict:
        """The rank's caches as prefill leaves them (``_cache_src``)
        re-laid into ``cache_axes``' layout and tagged; the identity off
        a mesh. The SSM's states stay as its weights hold them."""
        if self.mesh is None:
            return caches
        out = {}
        for key, tensors in caches.items():
            placed = []
            for i, t in enumerate(tensors):
                src = self._cache_src(key, i)
                whole = [n * self.mesh.ways(spec_axes(e))
                         for n, e in zip(t.shape, src.spec)]
                dst = src if self.layout[key][i] == T.STATE else fitted(
                    whole, self.cache_axes()[key][i])
                placed.append(tag(relay(t, src.spec, dst.spec), dst))
            out[key] = tuple(placed)
        return out

    def _cache_src(self, key: str, i: int) -> Sharding:
        """The layout of the rank's cache tensor ``i`` under ``key`` as
        prefill computes it: its rows split by the batch's axes, its
        heads as its weights split them (the attention's KV heads where
        they are whole heads, ``attention.Heads``; the SSM's heads and
        conv columns, in ``ssm.head_order``)."""
        ax, kind = self.cache_axes()[key][i], self.layout[key][i]
        names = [n for n, _ in self.named_parameters()]
        if kind == T.STATE:
            w = self.get_parameter(next(n for n in names
                                        if n.endswith("ssm.in_proj")))
            split = spec_axes(w.sharding.spec[1])
            if gathers(w, 1) or not M.can_split(self.cfg,
                                                self.mesh.ways(split)):
                split = ()
        else:
            wq, wk = (self.get_parameter(next(n for n in names
                                              if n.endswith(leaf)))
                      for leaf in (".wq", ".wk"))
            hd = A.heads_of({"wq": wq, "wk": wk}, self.cfg)
            split = hd.names if not gathers(wk, 1) and hd.kv_local else ()
        rows = batch_axes()
        spec = tuple((rows or None) if name in ("batch", "kv_batch")
                     else (split or None) if name in ("heads", "kv_heads")
                     else None for name in ax)
        order = ()
        if kind == T.STATE and split and ax[-1] == "heads":   # conv state
            order = (len(ax) - 1, M.head_order(
                self.cfg, self.mesh.ways(split), "conv"))
        return Sharding(self.mesh, spec, order)

    def _embed_inputs(self, batch: dict) -> torch.Tensor:
        """The token embeddings, after the VLM's patches (cast to the
        compute dtype)."""
        x = L.embed_tokens(self.params.embed, batch["tokens"])
        if self.cfg.family == VLM:
            x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
        return x

    @staticmethod
    def _layout(cfg: ModelConfig) -> dict:
        return T.cache_layout(cfg)

    def forward(self, batch: dict, remat: bool = False):
        """The batch (the module docstring) -> (logits (B, S, V), aux):
        S counts the VLM's patches; on a mesh, the rank's rows and share
        of V."""
        h, aux, _ = T.forward(self.params, self.cfg,
                              self._embed_inputs(batch), remat=remat)
        return T.logits_from_hidden(self.params, self.cfg, h), aux

    def loss(self, batch: dict, remat: bool = True) -> torch.Tensor:
        """The training loss of a batch with ``"targets"`` (the module
        docstring), a float32 scalar."""
        logits, aux = self.forward(batch, remat=remat)
        if self.cfg.family == VLM:       # only text positions carry labels
            logits = logits[:, self.cfg.num_patches:]
        loss = _xent(logits, batch["targets"], L.vocab_axis(self.params.embed))
        if self.cfg.is_moe:
            loss = loss + MOE_AUX_WEIGHT * aux
        return loss

    def trainable(self) -> "Model":
        """Every weight set to require grad; returns the model. The
        trainer's switch (the module docstring)."""
        return self.requires_grad_(True)

    def prefill(self, batch: dict, max_len: int | None = None):
        """The batch -> (last position's logits (B, 1, V), caches):
        full KV caches with ``max_len`` slots (the VLM's count its
        patches), the first S filled; ring caches of the window's slots
        (fixed at the window size), position t in slot t % W; SSM states
        as they are (O(1) in S)."""
        cfg = self.cfg
        h, _, caches = T.forward(self.params, cfg, self._embed_inputs(batch),
                                 collect_cache=True)
        logits = self._serve_logits(T.logits_from_hidden(self.params, cfg,
                                                         h[:, -1:]))
        W = cfg.sliding_window
        if cfg.local_global_pattern is not None:
            caches = {key: (_pad_seq(kv, max_len) if key == "group_global"
                            else _to_ring(kv, W))
                      for key, kv in caches.items()}
        elif cfg.family != SSM:
            c = caches["layers"]
            kv = _to_ring(c[:2], W) if W is not None else _pad_seq(c[:2],
                                                                   max_len)
            caches = {"layers": kv + c[2:]}
        return logits, self._place_caches(caches)

    def decode(self, cache: dict, batch: dict):
        """One token per row at ``batch["pos"]`` -> (logits (B, 1, V),
        cache), the cache updated in place. A full cache must have a slot
        at pos; a ring takes any pos >= 0. On a mesh, the rank's rows
        and caches, eagerly (the module docstring)."""
        token, pos = batch["token"], int(batch["pos"])
        for key, kinds in self.layout.items():
            for t, kind in zip(cache[key], kinds):
                slots = t.shape[-2]
                lay = A.kv_layout(t) if kind != T.STATE else None
                if lay is not None and lay.slots:
                    slots *= self.mesh.ways(lay.slots)
                if kind in (T.RING, T.FULL) and (pos < 0 or kind == T.FULL
                                                 and pos >= slots):
                    raise IndexError(f"position {pos} outside the {key} "
                                     f"cache's {slots} slots")
        if self.mesh is not None:
            logits, cache = self.step(self.params, self.cfg, cache, token,
                                      pos)
            return self._serve_logits(logits), cache
        if token.is_cuda and self.decode_graphs:
            key = (tuple(token.shape), token.dtype,
                   *((tuple(t.shape), t.dtype)
                     for t in _flat(cache, self.layout)))
            if key not in self._graphs:
                self._graphs[key] = _DecodeGraph(self.params, self.cfg,
                                                 cache, token, self.step,
                                                 self.layout)
            return self._graphs[key](cache, token, pos)
        return self.step(self.params, self.cfg, cache, token, pos)

    def init_cache(self, B: int, S: int) -> dict:
        """Zero caches for B rows, as the reference's ``init_cache(B, S)``:
        KV caches of S slots (``min(S, window)`` for a ring), the SSM conv
        (compute dtype) and state (float32) caches. On a mesh, the rank's
        blocks of them in ``cache_axes``' layout, tagged (``prefill``'s)."""
        whole = self._init_cache(B, S)
        if self.mesh is None:
            return whole
        return self._place_caches(
            {k: tuple(place(t, self._cache_src(k, i))
                      for i, t in enumerate(ts)) for k, ts in whole.items()})

    def _init_cache(self, B: int, S: int) -> dict:
        cfg = self.cfg

        def kv(stack: tuple, slots: int) -> tuple:
            return self._zero_kv(stack, B, slots)

        if cfg.local_global_pattern is not None:
            n_groups, n_local, n_tail = T.groups(cfg)
            Wd = min(S, cfg.sliding_window)
            c = {"group_local": kv((n_groups, n_local), Wd),
                 "group_global": kv((n_groups,), S)}
            if n_tail:
                c["tail_local"] = kv((n_tail,), Wd)
            return c
        Ln = cfg.num_layers
        states = ()
        dev, dtype = self.params.final_norm.device, T.compute_dtype(cfg)
        if cfg.family in (SSM, HYBRID):
            conv_dim = cfg.ssm_inner + 2 * cfg.ssm_state
            states = (torch.zeros((Ln, B, cfg.ssm_conv - 1, conv_dim),
                                  dtype=dtype, device=dev),
                      torch.zeros((Ln, B, cfg.ssm_heads, cfg.ssm_state,
                                   cfg.ssm_head_dim), dtype=torch.float32,
                                  device=dev))
        if cfg.family == SSM:
            return {"layers": states}
        return {"layers": kv((Ln,), _cache_len(cfg, S)) + states}

    def _zero_kv(self, stack: tuple, B: int, slots: int) -> tuple:
        """Zero (K, V) caches of shape (*stack, B, Hkv, slots, D)."""
        cfg = self.cfg
        shape = (*stack, B, cfg.num_kv_heads, slots, cfg.head_dim)
        dev, dtype = self.params.final_norm.device, T.compute_dtype(cfg)
        return (torch.zeros(shape, dtype=dtype, device=dev),
                torch.zeros(shape, dtype=dtype, device=dev))


class WhisperModel(Model):
    """The Whisper encoder-decoder with its weights (``whisper.py``):
    batches ``{"frames": (B, Se, d), "tokens": (B, Sd)}``, caches
    ``{"layers": (k_self, v_self, k_cross, v_cross)}``."""

    step = staticmethod(whisper.decode_step)
    _axes = staticmethod(whisper.param_axes)
    _cache_axes = staticmethod(whisper.cache_axes)

    @staticmethod
    def _layout(cfg: ModelConfig) -> dict:
        return whisper.CACHE_LAYOUT

    def forward(self, batch: dict, remat: bool = False):
        """The batch -> (the decoder's logits (B, Sd, V), aux 0.0);
        ``remat`` is ignored, as the reference ignores it."""
        enc = whisper.encode(self.params, self.cfg, batch["frames"])
        return whisper.decode_full(self.params, self.cfg, batch["tokens"],
                                   enc)[0], 0.0

    def loss(self, batch: dict, remat: bool = True) -> torch.Tensor:
        """The decoder's token cross-entropy (the module docstring)."""
        return _xent(self.forward(batch)[0], batch["targets"],
                     L.vocab_axis(self.params.embed))

    def prefill(self, batch: dict, max_len: int | None = None):
        """The batch -> (last position's logits (B, 1, V), caches): the
        self K/V a ring of ``max_decode_len`` slots, the cross K/V the
        encoder's ``Se``. ``max_len`` is ignored, as the reference
        ignores it."""
        cfg = self.cfg
        enc = whisper.encode(self.params, cfg, batch["frames"])
        logits, (k, v, k_x, v_x) = whisper.decode_full(
            self.params, cfg, batch["tokens"], enc, collect_cache=True)
        return self._serve_logits(logits[:, -1:]), self._place_caches({
            "layers": _to_ring((k, v), cfg.max_decode_len) + (k_x, v_x)})

    def _init_cache(self, B: int, S: int) -> dict:
        """Zero caches for B rows, as the reference's ``init_cache(B, S)``:
        a self ring of ``min(S, max_decode_len)`` slots, cross K/V of
        ``cross_kv_len``."""
        cfg, stack = self.cfg, (self.cfg.num_layers,)
        return {"layers": self._zero_kv(stack, B, min(S, cfg.max_decode_len))
                + self._zero_kv(stack, B, cfg.cross_kv_len)}


def build_model(cfg: ModelConfig, device=None, seed: int = 0) -> Model:
    """The model with random weights at the reference's scales, drawn on
    ``device`` (default ``cuda``) from a generator seeded with ``seed``."""
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    if cfg.family == AUDIO:
        return WhisperModel(cfg, whisper.init_params(gen, cfg))
    return Model(cfg, T.init_params(gen, cfg))
