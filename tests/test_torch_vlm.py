"""The port's VLM (InternVL2's language backbone after a patch-embedding
prefix) on the CPU against the JAX package, with the JAX package's
weights carried across by ``repro_torch.convert.model_params_to_torch``
and its caches by ``model_cache_to_torch``.

The reduced internvl2-1b: 2 layers, d_model 64, 4 query heads over 2 kv
heads of 16, QKV bias (drawn at random here: the reference initialises
the biases to zero, which would leave them untested), tied embeddings,
4 patches before the tokens. Prefill over P + S - 1 positions with
``max_len`` = P + S + 1, then decode at P + S - 1 and P + S.

Tolerances, ``tests/test_torch_models.py``'s: float32 logits and caches
to ``rtol=atol=2e-4``, bfloat16 logits to ``rtol=2e-2, atol=0.0625``
(the bfloat16 reference compiled without excess precision:
``test_torch_moe.strict``). The JAX decode runs the naive path
(``REPRO_DECODE_IMPL``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro_torch.configs import ModelConfig
from repro_torch.convert import model_cache_to_torch, model_params_to_torch
from test_torch_hybrid import assert_caches
from test_torch_models import BF16, F32, f32, naive_decode, tokens
from test_torch_moe import strict
from test_torch_whisper import served

__all__ = ["naive_decode"]          # the autouse fixture, imported
P, S = 4, 12                        # reduced num_patches; text tokens


def pair(dtype: str = "float32"):
    """(JAX model, its params with random QKV biases, the port's model
    with the same weights)."""
    jcfg = dataclasses.replace(jax_config("internvl2-1b", reduced=True),
                               dtype=dtype)
    jm = jax_build(jcfg)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(9)
    attn = params["layers"]["attn"]
    for name in ("bq", "bk", "bv"):
        attn[name] = rng.standard_normal(attn[name].shape).astype(np.float32)
    tm = model_params_to_torch(params, ModelConfig(**dataclasses.asdict(jcfg)),
                               "cpu")
    return jm, params, tm


@pytest.fixture(scope="module")
def f32_pair():
    return pair()


def batches(cfg, seed: int = 1):
    """Patches (2, P, d) and tokens (2, S), for the reference and the
    port."""
    pa = np.random.default_rng(seed + 1).standard_normal(
        (2, cfg.num_patches, cfg.d_model)).astype(np.float32)
    toks = tokens(cfg, S=S, seed=seed)
    return ({"patches": jnp.asarray(pa), "tokens": jnp.asarray(toks)},
            {"patches": torch.from_numpy(pa),
             "tokens": torch.from_numpy(toks).long()})


def head(batch: dict) -> dict:
    """The batch without its last token."""
    return {"patches": batch["patches"], "tokens": batch["tokens"][:, :-1]}


def test_vlm_forward_matches_the_reference(f32_pair):
    jm, params, tm = f32_pair
    assert tm.cfg.num_patches == P and tm.cfg.qkv_bias
    jb, tb = batches(tm.cfg)
    want, _ = jm.forward(params, jb)
    got, aux = tm(tb)
    assert got.shape == (2, P + S, tm.cfg.vocab_size) and aux == 0.0
    np.testing.assert_allclose(f32(got), f32(want), **F32)


def test_vlm_prefill_and_decode_match_the_reference(f32_pair):
    jm, params, tm = f32_pair
    jb, tb = batches(tm.cfg, seed=2)
    full, _ = tm(tb)
    max_len = P + S + 1
    jl, jc = jm.prefill(params, head(jb), max_len=max_len)
    tl, tc = tm.prefill(head(tb), max_len=max_len)
    np.testing.assert_allclose(f32(tl), f32(jl), **F32)
    assert tc["layers"][0].shape == (tm.cfg.num_layers, 2,
                                     tm.cfg.num_kv_heads, max_len,
                                     tm.cfg.head_dim)
    assert_caches(tc, model_cache_to_torch(jc, "cpu"), **F32)
    for pos, tok in ((P + S - 1, np.array(jb["tokens"][:, -1:])),
                     (P + S, np.full((2, 1), 7, np.int32))):
        jl, jc = jm.decode(params, jc, {"token": jnp.asarray(tok),
                                        "pos": jnp.int32(pos)})
        tl, tc = tm.decode(tc, {"token": torch.from_numpy(tok).long(),
                                "pos": pos})
        np.testing.assert_allclose(f32(tl), f32(jl), err_msg=str(pos), **F32)
        assert_caches(tc, model_cache_to_torch(jc, "cpu"), **F32)
        if pos == P + S - 1:        # and the full forward's last position
            np.testing.assert_allclose(f32(tl[:, 0]), f32(full[:, -1]),
                                       **F32)
    with pytest.raises(IndexError, match="layers cache's 17 slots"):
        tm.decode(tc, {"token": torch.zeros((2, 1), dtype=torch.long),
                       "pos": max_len})


def test_vlm_bfloat16_against_the_reference():
    jm, params, tm = pair("bfloat16")
    jb, tb = batches(tm.cfg, seed=3)
    want, _ = strict(jm.forward, params, jb)
    got, _ = tm(tb)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(want), **BF16)
    _, jc = strict(functools.partial(jm.prefill, max_len=P + S), params,
                   head(jb))
    jl, _ = strict(jm.decode, params, jc, {"token": jb["tokens"][:, -1:],
                                           "pos": jnp.int32(P + S - 1)})
    _, tc = tm.prefill(head(tb), max_len=P + S)
    tl, _ = tm.decode(tc, {"token": tb["tokens"][:, -1:], "pos": P + S - 1})
    np.testing.assert_allclose(f32(tl), f32(jl), **BF16)


def test_serve_sends_patches_and_decodes_after_them(monkeypatch):
    rep, seen = served(monkeypatch, ["--arch", "internvl2-1b",
                                     "--prompt-len", "6",
                                     "--decode-steps", "3"])
    assert rep["arch"] == "internvl2-1b-smoke" and rep["logits_finite"]
    assert rep["prefills"] == 4 and rep["decodes"] == 12
    assert seen["batches"] == [{"patches": (2, P, 64), "tokens": (2, 6)}] * 4
    assert seen["positions"] == [P + 6, P + 7, P + 8] * 4
    assert seen["max_len"] == {P + 6 + 3}
