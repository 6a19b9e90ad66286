"""The port's MoE layer and the reduced MoE models on the CPU against the
JAX package (``repro.models.moe``, ``repro.models.transformer``), with
the JAX package's weights carried across by
``repro_torch.convert.model_params_to_torch``.

Routing is integer output and must match exactly: each token's top-k
experts, the stable sort by expert, each pair's rank within its expert
and which pairs the capacity keeps (the reference's routing is restated
below from ``repro/models/moe.py``, which returns only the output and
the aux loss). Floats to ``tests/test_torch_models.py``'s tolerances:
the layer in float32 to ``rtol=1e-5`` and ``atol=1e-6`` times the
output's largest magnitude (the reference draws its expert weights at
scale ``E ** -0.5``, so the reduced layer's outputs reach ~25, and
float32 products summed in another order differ by an ULP of that,
~2e-6, at elements that cancel to near 0), logits to
``rtol=atol=2e-4`` in float32 and ``rtol=2e-2, atol=0.0625`` in
bfloat16. The JAX decode runs the naive path (``REPRO_DECODE_IMPL``).
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
from repro.models import moe as JE
from repro_torch.configs import ModelConfig
from repro_torch.convert import model_params_to_torch
from repro_torch.models import moe as E
from test_torch_models import BF16, F32, LAYER, f32, naive_decode, tokens

MOE_ARCHS = ("qwen3-moe-30b-a3b", "qwen3-moe-235b-a22b")
__all__ = ["naive_decode"]          # the autouse fixture, imported


def pair(arch: str, dtype: str = "float32", **over):
    """(JAX model, its params, the port's model with the same weights) at
    the reduced config with ``over``."""
    jcfg = dataclasses.replace(jax_config(arch, reduced=True), dtype=dtype,
                               **over)
    jm = jax_build(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tm = model_params_to_torch(jax.tree.map(np.asarray, params),
                               ModelConfig(**dataclasses.asdict(jcfg)), "cpu")
    return jm, params, tm


def jax_routing(p, cfg, x, capacity_factor):
    """The reference's routing, as ``repro/models/moe.py::moe`` computes
    it: (top-k experts, the stable order by expert, each sorted pair's
    rank in its expert, kept)."""
    E_, k = cfg.num_experts, cfg.experts_per_token
    xt = x.reshape(-1, cfg.d_model)
    T = xt.shape[0]
    logits = jnp.einsum("td,de->te", xt.astype(jnp.float32),
                        p["router"].astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    _, topi = jax.lax.top_k(probs, k)
    flat_e = topi.reshape(-1)
    order = jnp.argsort(flat_e)
    counts = jnp.zeros((E_,), jnp.int32).at[flat_e].add(1)
    starts = jnp.cumsum(counts) - counts
    slot = jnp.arange(T * k, dtype=jnp.int32) - starts[flat_e[order]]
    cap = E.capacity(T, k, E_, capacity_factor)
    return [np.asarray(a) for a in (topi, order, slot, slot < cap)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity_factor", [8.0, 0.1])
def test_moe_layer_matches_the_reference(capacity_factor, dtype):
    _, params, tm = pair("qwen3-moe-30b-a3b", dtype)
    cfg = tm.cfg
    p0 = jax.tree.map(lambda a: np.asarray(a[0]), params["layers"]["moe"])
    tp = tm.params.layers[0].moe
    x = np.random.default_rng(3).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want, want_aux = JE.moe(p0, cfg, jx, jnp.dtype(dtype),
                            capacity_factor=capacity_factor)
    got, got_aux = E.moe(tp, cfg, tx, capacity_factor=capacity_factor)
    assert got.dtype == tx.dtype and got_aux.dtype == torch.float32
    np.testing.assert_allclose(f32(got_aux), f32(want_aux), **LAYER)
    scale = max(1.0, float(np.abs(f32(want)).max()))
    np.testing.assert_allclose(
        f32(got), f32(want),
        **(dict(rtol=LAYER["rtol"], atol=LAYER["atol"] * scale)
           if dtype == "float32" else BF16))

    r = E.route(tp, cfg, tx.reshape(-1, cfg.d_model), capacity_factor)
    topi, order, slot, keep = jax_routing(p0, cfg, jx, capacity_factor)
    np.testing.assert_array_equal(r.topi.numpy(), topi)
    np.testing.assert_array_equal(r.order.numpy(), order)
    np.testing.assert_array_equal(r.slot.numpy(), slot)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    # dropless at 8.0; at 0.1 the 8-slot floor keeps some pairs, drops others
    assert keep.all() == (capacity_factor == 8.0)
    assert keep.any()


def test_dropped_pairs_fall_through_the_residual():
    # a pair past its expert's capacity contributes nothing: a token whose
    # pairs are all dropped gets a zero output
    _, params, tm = pair("qwen3-moe-30b-a3b")
    cfg = tm.cfg
    tp = tm.params.layers[0].moe
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 64, cfg.d_model)).astype(np.float32))
    out, _ = E.moe(tp, cfg, x, capacity_factor=0.1)
    r = E.route(tp, cfg, x[0], 0.1)
    kept = torch.zeros(64 * cfg.experts_per_token, dtype=torch.bool)
    kept[r.order] = r.keep
    none_kept = ~kept.view(64, -1).any(1)
    assert none_kept.any() and (~none_kept).any()
    assert not out[0, none_kept].any()
    assert out[0, ~none_kept].abs().sum(-1).min() > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_model_forward_prefill_decode_float32(arch):
    jm, params, tm = pair(arch)
    toks = tokens(tm.cfg, S=24)
    want, want_aux = jm.forward(params, {"tokens": jnp.asarray(toks)})
    got, got_aux = tm({"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(f32(got), f32(want), **F32)
    np.testing.assert_allclose(f32(got_aux), f32(want_aux), **F32)

    S = 20
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :S])},
                        max_len=24)
    tl, tc = tm.prefill({"tokens": torch.from_numpy(toks[:, :S]).long()},
                        max_len=24)
    np.testing.assert_allclose(f32(tl), f32(jl), **F32)
    for a, b in zip(tc["layers"], jc["layers"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(f32(a), f32(b), **F32)
    dec = jax.jit(jm.decode)
    for pos in range(S, 24):
        tok = toks[:, pos:pos + 1]
        jl, jc = dec(params, jc, {"token": jnp.asarray(tok),
                                  "pos": jnp.int32(pos)})
        tl, tc = tm.decode(tc, {"token": torch.from_numpy(tok).long(),
                                "pos": pos})
        np.testing.assert_allclose(f32(tl), f32(jl), **F32)
    for a, b in zip(tc["layers"], jc["layers"]):
        np.testing.assert_allclose(f32(a), f32(b), **F32)


@pytest.fixture(scope="module")
def bf16_pair():
    """``pair`` of the reduced qwen3-moe-30b-a3b in bfloat16, built once."""
    return pair("qwen3-moe-30b-a3b", "bfloat16")


def strict(fn, *args):
    """``fn(*args)`` compiled with ``xla_allow_excess_precision`` off: by
    default XLA keeps a compiled scan's bfloat16 intermediates in float32,
    the router's inputs move by a bfloat16 step, and near-tied top-k
    choices flip (this file's bfloat16 model: 4 of 48 tokens, logits 3.5
    apart from the same reference run op by op); the port, like the
    reference op by op, rounds every bfloat16 op as written."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def test_moe_model_bfloat16(bf16_pair):
    jm, params, tm = bf16_pair
    toks = tokens(tm.cfg, S=24)
    want, _ = strict(jm.forward, params, {"tokens": jnp.asarray(toks)})
    got, _ = tm({"tokens": torch.from_numpy(toks).long()})
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(want), **BF16)
    _, jc = strict(functools.partial(jm.prefill, max_len=24), params,
                   {"tokens": jnp.asarray(toks[:, :-1])})
    jl, _ = strict(jm.decode, params, jc, {"token": jnp.asarray(toks[:, -1:]),
                                           "pos": jnp.int32(23)})
    _, tc = tm.prefill({"tokens": torch.from_numpy(toks[:, :-1]).long()},
                       max_len=24)
    tl, _ = tm.decode(tc, {"token": torch.from_numpy(toks[:, -1:]).long(),
                           "pos": 23})
    np.testing.assert_allclose(f32(tl), f32(jl), **BF16)


def test_moe_model_bfloat16_gap_to_the_default_compile(bf16_pair):
    """How far the port is from the reference as it compiles by default
    (``strict`` holds it to the op-by-op rounding instead): near-tied
    top-k choices move, and 8 of the 48 tokens' logit rows fall outside
    the bfloat16 tolerance now (at most 3.5 apart). A change that widens
    that gap fails here."""
    jm, params, tm = bf16_pair
    toks = tokens(tm.cfg, S=24)
    got = f32(tm({"tokens": torch.from_numpy(toks).long()})[0])
    want = f32(jax.jit(jm.forward)(params, {"tokens": jnp.asarray(toks)})[0])
    outside = (np.abs(got - want)
               > BF16["atol"] + BF16["rtol"] * np.abs(want)).any(-1)
    assert outside.sum() <= 8, f"{outside.sum()} of {outside.size} rows"


def test_router_stays_float32_after_convert(bf16_pair):
    _, params, tm = bf16_pair
    moe0 = tm.params.layers[0].moe
    assert moe0["router"].dtype == torch.float32
    assert all(moe0[w].dtype == torch.bfloat16 for w in ("wi", "wg", "wo"))
    np.testing.assert_array_equal(moe0["router"].numpy(),
                                  np.asarray(params["layers"]["moe"]
                                             ["router"][0]))
    assert tm.params.layers[0].ln2.dtype == torch.float32


def test_capacity_matches_the_reference_formula():
    # max(8, ceil8(ceil(T k cf / E))): the decode step's 4 tokens at
    # qwen3-moe-30b-a3b's 128 experts top-8 get the 8-slot floor, the
    # serve prefill's 4,000 tokens 320 slots
    assert E.capacity(4, 8, 128, 1.25) == 8
    assert E.capacity(4000, 8, 128, 1.25) == 320
    assert E.capacity(48, 2, 8, 1.25) == 16
    assert E.capacity(24, 2, 8, 0.1) == 8
