"""The port's gemma3 local:global stack on the CPU against the JAX
package, with the JAX package's weights carried across by
``repro_torch.convert.model_params_to_torch``.

Two layouts: the reduced gemma3-1b (2 layers, pattern (1, 1): one group
of a local and a global layer) and a variant with 5 layers and pattern
(2, 1) (one group of two local layers and a global one, then two
trailing local layers: ``tail_local``). Local layers attend over a
window of 8 and keep ring caches; global layers attend over everything
and keep full caches of ``max_len`` slots. Prefill at 12 positions
(past the window), then decode on. Floats to
``tests/test_torch_models.py``'s tolerances (float32 ``rtol=atol=2e-4``,
bfloat16 ``rtol=2e-2, atol=0.0625``, the bfloat16 reference compiled
without excess precision: ``test_torch_moe.strict``); the JAX decode
runs the naive path (``REPRO_DECODE_IMPL``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.models import transformer as T
from test_torch_hybrid import assert_caches
from test_torch_models import BF16, F32, f32, naive_decode, tokens
from test_torch_moe import pair, strict

__all__ = ["naive_decode"]          # the autouse fixture, imported
LAYOUTS = {"groups": {}, "tail": dict(num_layers=5,
                                      local_global_pattern=(2, 1))}
S, STEPS = 12, 6


@pytest.mark.parametrize("layout", LAYOUTS)
def test_groups_and_caches_follow_the_layer_kinds(layout):
    _, params, tm = pair("gemma3-1b", **LAYOUTS[layout])
    cfg = tm.cfg
    G, nl, tail = T.groups(cfg)
    assert (G, nl, tail) == {"groups": (1, 1, 0), "tail": (1, 2, 2)}[layout]
    kinds = ["local"] * nl + ["global"]
    assert list(cfg.layer_kinds()) == kinds * G + ["local"] * tail
    assert set(params) - {"embed", "final_norm"} == set(T.cache_layout(cfg))
    c = tm.init_cache(2, 20)
    assert c["group_local"][0].shape == (G, nl, 2, cfg.num_kv_heads, 8,
                                         cfg.head_dim)
    assert c["group_global"][0].shape == (G, 2, cfg.num_kv_heads, 20,
                                          cfg.head_dim)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_local_global_forward_prefill_decode_float32(layout):
    jm, params, tm = pair("gemma3-1b", **LAYOUTS[layout])
    toks = tokens(tm.cfg, S=S + STEPS, seed=7)
    want, _ = jm.forward(params, {"tokens": jnp.asarray(toks)})
    got, _ = tm({"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(f32(got), f32(want), **F32)

    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :S])},
                        max_len=S + STEPS)
    tl, tc = tm.prefill({"tokens": torch.from_numpy(toks[:, :S]).long()},
                        max_len=S + STEPS)
    np.testing.assert_allclose(f32(tl), f32(jl), **F32)
    assert set(tc) == set(T.cache_layout(tm.cfg))
    assert_caches(tc, jc, **F32)
    dec = jax.jit(jm.decode)
    for pos in range(S, S + STEPS):
        tok = toks[:, pos:pos + 1]
        jl, jc = dec(params, jc, {"token": jnp.asarray(tok),
                                  "pos": jnp.int32(pos)})
        tl, tc = tm.decode(tc, {"token": torch.from_numpy(tok).long(),
                                "pos": pos})
        np.testing.assert_allclose(f32(tl), f32(jl), err_msg=str(pos), **F32)
        assert_caches(tc, jc, **F32)
    # decode equals the full forward's last positions too
    np.testing.assert_allclose(f32(tl[:, 0]), f32(got[:, -1]), **F32)


def test_local_global_bfloat16():
    jm, params, tm = pair("gemma3-1b", "bfloat16", **LAYOUTS["tail"])
    toks = tokens(tm.cfg, S=S + 2, seed=8)
    want, _ = strict(jm.forward, params, {"tokens": jnp.asarray(toks)})
    got, _ = tm({"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(f32(got), f32(want), **BF16)
    _, jc = strict(functools.partial(jm.prefill, max_len=S + 2), params,
                   {"tokens": jnp.asarray(toks[:, :S])})
    _, tc = tm.prefill({"tokens": torch.from_numpy(toks[:, :S]).long()},
                       max_len=S + 2)
    for pos in (S, S + 1):
        tok = toks[:, pos:pos + 1]
        jl, jc = strict(jm.decode, params, jc, {"token": jnp.asarray(tok),
                                                "pos": jnp.int32(pos)})
        tl, tc = tm.decode(tc, {"token": torch.from_numpy(tok).long(),
                                "pos": pos})
        np.testing.assert_allclose(f32(tl), f32(jl), **BF16)


def test_decode_refuses_a_position_past_the_global_cache():
    # the rings take any position; the global layers' full caches need a
    # slot at pos
    _, _, tm = pair("gemma3-1b")
    toks = torch.from_numpy(tokens(tm.cfg, S=S)).long()
    _, cache = tm.prefill({"tokens": toks}, max_len=S + 1)
    tm.decode(cache, {"token": toks[:, :1], "pos": S})
    with pytest.raises(IndexError, match="group_global cache's 13 slots"):
        tm.decode(cache, {"token": toks[:, :1], "pos": S + 1})
