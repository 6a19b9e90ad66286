"""The port's hybrid (hymba) stack and its sliding-window ring caches on
the CPU against the JAX package, with the JAX package's weights carried
across by ``repro_torch.convert.model_params_to_torch``.

The reduced hymba-1.5b config: 2 layers, d_model 64, attention with a
window of 8 beside 4 SSD heads. A prompt longer than the window fills
the ring through ``_to_ring`` (the last 8 positions, position t in slot
t % 8); decode writes slot ``pos % 8`` and attends over
``min(pos + 1, 8)`` slots, so six steps from position 12 wrap the ring.
Ring reordering is exact (element for element); floats to
``tests/test_torch_models.py``'s tolerances (float32 ``rtol=atol=2e-4``,
bfloat16 ``rtol=2e-2, atol=0.0625``), the bfloat16 reference compiled
without excess precision (``test_torch_moe.strict``). The JAX decode
runs the naive path (``REPRO_DECODE_IMPL``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import model_zoo as JZ
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.models import build_model
from repro_torch.models import model_zoo as Z
from test_torch_models import BF16, F32, f32, naive_decode, tokens
from test_torch_moe import pair, strict

__all__ = ["naive_decode"]          # the autouse fixture, imported
W = 8                               # the reduced config's window


def assert_caches(tc: dict, jc: dict, **tol) -> None:
    """Every cache tensor of the port's dict against the reference's."""
    assert set(tc) == set(jc)
    for key in jc:
        assert len(tc[key]) == len(jc[key])
        for a, b in zip(tc[key], jc[key]):
            assert tuple(a.shape) == b.shape, key
            np.testing.assert_allclose(f32(a), f32(b), err_msg=key, **tol)


@pytest.mark.parametrize("S", [5, W, 12, 2 * W + 3])
def test_to_ring_matches_the_reference(S):
    rng = np.random.default_rng(S)
    k, v = (rng.standard_normal((2, 3, 2, S, 4)).astype(np.float32)
            for _ in range(2))
    want = JZ._to_ring((jnp.asarray(k), jnp.asarray(v)), W)
    got = Z._to_ring((torch.from_numpy(k), torch.from_numpy(v)), W)
    for a, b in zip(got, want):
        assert a.shape == b.shape == (2, 3, 2, W, 4)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_hybrid_forward_float32_and_bfloat16():
    for dtype, tol in (("float32", F32), ("bfloat16", BF16)):
        jm, params, tm = pair("hymba-1.5b", dtype)
        toks = tokens(tm.cfg, S=24)
        want, _ = strict(jm.forward, params, {"tokens": jnp.asarray(toks)})
        got, aux = tm({"tokens": torch.from_numpy(toks).long()})
        assert got.dtype == getattr(torch, dtype) and aux == 0.0
        np.testing.assert_allclose(f32(got), f32(want), **tol)


@pytest.mark.parametrize("S", [12, 24])
def test_hybrid_prefill_and_decode_across_the_ring(S):
    jm, params, tm = pair("hymba-1.5b")
    cfg = tm.cfg
    assert cfg.sliding_window == W
    toks = tokens(cfg, S=S + 6, seed=S)
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :S])},
                        max_len=S + 6)
    tl, tc = tm.prefill({"tokens": torch.from_numpy(toks[:, :S]).long()},
                        max_len=S + 6)
    np.testing.assert_allclose(f32(tl), f32(jl), **F32)
    k, v, conv, h = tc["layers"]
    assert k.shape == (cfg.num_layers, 2, cfg.num_kv_heads, W, cfg.head_dim)
    assert h.dtype == torch.float32
    assert_caches(tc, jc, **F32)
    dec = jax.jit(jm.decode)
    for pos in range(S, S + 6):
        tok = toks[:, pos:pos + 1]
        jl, jc = dec(params, jc, {"token": jnp.asarray(tok),
                                  "pos": jnp.int32(pos)})
        tl, out = tm.decode(tc, {"token": torch.from_numpy(tok).long(),
                                 "pos": pos})
        assert out is tc
        np.testing.assert_allclose(f32(tl), f32(jl), err_msg=str(pos), **F32)
        assert_caches(tc, jc, **F32)


def test_hybrid_bfloat16_decode():
    jm, params, tm = pair("hymba-1.5b", "bfloat16")
    toks = tokens(tm.cfg, S=14)
    _, jc = strict(functools.partial(jm.prefill, max_len=14), params,
                   {"tokens": jnp.asarray(toks[:, :12])})
    _, tc = tm.prefill({"tokens": torch.from_numpy(toks[:, :12]).long()},
                       max_len=14)
    for pos in (12, 13):
        tok = toks[:, pos:pos + 1]
        jl, jc = strict(jm.decode, params, jc, {"token": jnp.asarray(tok),
                                                "pos": jnp.int32(pos)})
        tl, tc = tm.decode(tc, {"token": torch.from_numpy(tok).long(),
                                "pos": pos})
        np.testing.assert_allclose(f32(tl), f32(jl), **BF16)


def test_ring_decode_matches_own_full_forward():
    # the serving contract on the port alone: prefill past the window,
    # decode on through the ring, equal the full forward's positions
    cfg = get_config("hymba-1.5b", reduced=True)
    cfg = dataclasses.replace(cfg, dtype="float32")
    model = build_model(cfg, device="cpu", seed=3)
    toks = torch.from_numpy(tokens(cfg, S=20, seed=4)).long()
    full, _ = model({"tokens": toks})
    _, cache = model.prefill({"tokens": toks[:, :11]})
    for pos in range(11, 20):
        lg, cache = model.decode(cache, {"token": toks[:, pos:pos + 1],
                                         "pos": pos})
        np.testing.assert_allclose(f32(lg[:, 0]), f32(full[:, pos]), **F32)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_init_cache_matches_the_reference(arch):
    jcfg = jax_config(arch, reduced=True)
    want = JZ.make_init_cache(jcfg)(3, 10)
    if isinstance(want, tuple):     # Whisper's bare tuple, under "layers"
        want = {"layers": want}
    got = build_model(get_config(arch, reduced=True),
                      device="cpu").init_cache(3, 10)
    assert set(got) == set(want)
    for key in want:
        assert [(tuple(t.shape), str(t.dtype).split(".")[-1])
                for t in got[key]] == [(b.shape, str(b.dtype))
                                       for b in want[key]]
        assert not any(t.any() for t in got[key])
