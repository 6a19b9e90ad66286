"""The dense decode step a CUDA graph captures, on the CPU.

``transformer.decode_step`` reads its position from a device tensor: the
rotary tables, the lengths (min(pos + 1, cache slots)) and the K/V slot
written (``index_copy_``) all come from it, so that one captured graph
serves every position (``model_zoo.Model.decode``). Here that step, given
the position as a tensor, is held bit for bit against the step as it was
written with a Python int (rotary tables from ``arange``, lengths from
``full``, the slot written by indexing), replayed below, at the reduced
qwen3-4b config in float32 and bfloat16 over every position of a cache
up to its last slot, where pos + 1 reaches the slots. The graph itself
runs only on the card (``chip_smoke.py``'s ``decode_graph`` phase holds
it exactly equal to the eager step). The parity of the step against the
JAX package's ``decode_step`` is ``tests/test_torch_models.py``'s.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import attention as A
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

PROMPT, SLOTS = 10, 16


def int_pos_step(params, cfg, caches, token, pos: int):
    """The dense decode step with a Python int position, as the step was
    before it read the position from a tensor; the caches are written in
    place. Returns the logits."""
    x = L.embed_tokens(params.embed, token)
    first, second = caches["layers"]
    rope_cs = L.rope_tables(torch.arange(pos, pos + 1), cfg.head_dim,
                            cfg.rope_theta)
    lengths = torch.full((x.shape[0],), min(pos + 1, first.shape[3]),
                         dtype=torch.int32)
    for l, lp in enumerate(params.layers):
        h = L.rms_norm(x, lp.ln1, cfg.rms_eps)
        q, k, v = A._project_qkv(lp.attn, cfg, h, rope_cs)
        first[l][:, :, pos] = k[:, :, 0]
        second[l][:, :, pos] = v[:, :, 0]
        o = ops.decode_attention(q[:, :, 0], first[l], second[l], lengths)
        x = x + (o.reshape(x.shape[0], cfg.q_dim) @ lp.attn["wo"])[:, None]
        if cfg.d_ff > 0:
            x = x + L.mlp(lp.mlp, L.rms_norm(x, lp.ln2, cfg.rms_eps))
    x = L.rms_norm(x, params.final_norm, cfg.rms_eps)
    return T.logits_from_hidden(params, cfg, x)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).view(torch.uint8),
                            b.reshape(-1).view(torch.uint8)))


def prefilled(dtype: str, seed: int = 5):
    cfg = dataclasses.replace(get_config("qwen3-4b", reduced=True),
                              dtype=dtype)
    model = build_model(cfg, device="cpu", seed=seed)
    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (2, PROMPT + SLOTS), generator=gen)
    _, cache = model.prefill({"tokens": toks[:, :PROMPT]}, max_len=SLOTS)
    return model, cache, toks


def clone(cache: dict) -> dict:
    return {"layers": tuple(t.clone() for t in cache["layers"])}


@pytest.mark.parametrize("pos_as", ["tensor", "0-d tensor", "int"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_device_position_step_matches_the_int_step(dtype, pos_as):
    model, cache, toks = prefilled(dtype)
    cfg, params = model.cfg, model.params
    want_cache, got_cache = clone(cache), clone(cache)
    for pos in range(PROMPT, SLOTS):               # the last: pos + 1 == SLOTS
        token = toks[:, pos:pos + 1].to(torch.int32)
        want = int_pos_step(params, cfg, want_cache, token, pos)
        arg = {"tensor": torch.tensor([pos]), "0-d tensor": torch.tensor(pos),
               "int": pos}[pos_as]
        got, out = T.decode_step(params, cfg, got_cache, token, arg)
        assert out is got_cache
        assert same_bits(got, want), pos
    for a, b in zip(got_cache["layers"], want_cache["layers"]):
        assert same_bits(a, b)
    # every slot was written, the prompt's untouched
    for a, b in zip(got_cache["layers"], cache["layers"]):
        assert same_bits(a[:, :, :, :PROMPT], b[:, :, :, :PROMPT])
        assert not torch.equal(a[:, :, :, PROMPT:], b[:, :, :, PROMPT:])


def test_model_decode_takes_the_same_step():
    model, cache, toks = prefilled("float32", seed=6)
    want_cache, got_cache = clone(cache), clone(cache)
    for pos in (PROMPT, PROMPT + 1):
        token = toks[:, pos:pos + 1]
        want = int_pos_step(model.params, model.cfg, want_cache, token, pos)
        got, out = model.decode(got_cache, {"token": token, "pos": pos})
        assert out is got_cache and same_bits(got, want)


@pytest.mark.parametrize("pos", [SLOTS, SLOTS + 3, -1])
def test_model_decode_refuses_a_position_past_the_cache(pos):
    model, cache, toks = prefilled("float32", seed=7)
    with pytest.raises(IndexError, match="slots"):
        model.decode(cache, {"token": toks[:, :1], "pos": pos})


def test_decode_step_lengths_and_slot_come_from_the_device_position():
    # the step's lengths and slot follow the tensor it is given: a position
    # tensor changed in place between two calls moves both, as a graph's
    # static position does between replays
    model, cache, toks = prefilled("float32", seed=8)
    pos_t = torch.tensor([PROMPT])
    c1, c2 = clone(cache), clone(cache)
    T.decode_step(model.params, model.cfg, c1, toks[:, :1], pos_t)
    pos_t.fill_(PROMPT + 2)
    T.decode_step(model.params, model.cfg, c1, toks[:, 1:2], pos_t)
    int_pos_step(model.params, model.cfg, c2, toks[:, :1], PROMPT)
    int_pos_step(model.params, model.cfg, c2, toks[:, 1:2], PROMPT + 2)
    for a, b in zip(c1["layers"], c2["layers"]):
        assert same_bits(a, b)
        assert not a[:, :, :, PROMPT + 1].any()    # the slot skipped: still 0
