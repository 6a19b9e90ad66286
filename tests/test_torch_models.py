"""The port's model substrate on the CPU against the JAX package: configs,
layers, the attention block, the dense transformer's forward and decode
step, and the model API, with the JAX package's weights carried across
by ``repro_torch.convert.model_params_to_torch``.

The port runs on ``device="cpu"``, i.e. on the kernels' plain versions;
the JAX side runs its reference attention, its decode held to the naive
path (``REPRO_DECODE_IMPL=naive``: the default CPU decode scales q in
bfloat16, the Pallas kernel and the port in float32).

Tolerances: float32 logits and activations to ``rtol=atol=2e-4`` (the
bound of ``tests/test_models.py``'s prefill+decode check; measured
~2e-6); bfloat16 logits to ``atol=0.0625, rtol=2e-2``, two bfloat16
steps at the logits' magnitude (~4): the two frameworks round the same
float32 products to bfloat16 at different places; the measured worst is
one step. Layer functions in float32 to ``rtol=1e-5, atol=1e-6``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES as JAX_ARCHS
from repro.configs import get_config as jax_config
from repro.models import attention as JA
from repro.models import build_model as jax_build
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import ARCH_NAMES, ModelConfig, get_config
from repro_torch.convert import model_params_to_torch
from repro_torch.models import attention as A
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

F32 = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=2e-2, atol=0.0625)
LAYER = dict(rtol=1e-5, atol=1e-6)
# dense reference configs the port builds: qk-norm (qwen3), QKV bias
# (qwen2.5), neither (mistral-nemo)
DENSE = ("qwen3-4b", "qwen2.5-14b", "mistral-nemo-12b")


@pytest.fixture(autouse=True)
def naive_decode(monkeypatch):
    monkeypatch.setenv("REPRO_DECODE_IMPL", "naive")


def port_config(name: str, dtype: str = "float32") -> ModelConfig:
    """The reference's reduced config, field for field, in the port."""
    jcfg = jax_config(name, reduced=True)
    return ModelConfig(**{**dataclasses.asdict(jcfg), "dtype": dtype})


def pair(name: str = "qwen3-4b", dtype: str = "float32", seed: int = 0):
    """(JAX model, its params, the port's model with the same weights)."""
    cfg = port_config(name, dtype)
    jm = jax_build(dataclasses.replace(jax_config(name, reduced=True),
                                       dtype=dtype))
    params = jm.init(jax.random.PRNGKey(seed))
    tm = model_params_to_torch(jax.tree.map(np.asarray, params), cfg, "cpu")
    return jm, params, tm


def tokens(cfg, B=2, S=24, seed=1):
    t = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))
    return t.astype(np.int32)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ---------------------------------------------------------------------------
# Configs.
# ---------------------------------------------------------------------------

def test_registry_holds_the_published_qwen3_4b():
    # and every other config of the reference, in its order
    assert ARCH_NAMES == JAX_ARCHS
    assert len(ARCH_NAMES) == 10
    for arch in ARCH_NAMES:
        for reduced in (False, True):
            want = jax_config(arch, reduced=reduced)
            got = get_config(arch, reduced=reduced)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert got.param_count() == want.param_count()
    full = get_config("qwen3-4b")
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads,
            full.head_dim, full.d_ff, full.vocab_size) == (
                36, 2560, 32, 8, 128, 9728, 151936)
    ssm = get_config("mamba2-1.3b")
    assert (ssm.family, ssm.num_layers, ssm.d_model, ssm.ssm_inner,
            ssm.ssm_heads, ssm.ssm_head_dim, ssm.ssm_state, ssm.ssm_conv,
            ssm.ssm_chunk, ssm.vocab_size, ssm.tie_embeddings, ssm.dtype) == (
                "ssm", 48, 2048, 4096, 64, 64, 128, 4, 256, 50280, True,
                "bfloat16")


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_config_copy_derives_the_same_reduced_config(arch):
    want = jax_config(arch)
    got = ModelConfig(**dataclasses.asdict(want))
    assert dataclasses.asdict(got.reduced()) == dataclasses.asdict(
        want.reduced())
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    assert got.layer_kinds() == want.layer_kinds()


def test_unported_arch_raises():
    with pytest.raises(KeyError, match="unknown arch 'no-such-arch'"):
        get_config("no-such-arch")


# ---------------------------------------------------------------------------
# Layers.
# ---------------------------------------------------------------------------

def test_rms_norm_and_rope():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 5, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    got = L.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
    np.testing.assert_allclose(f32(got), f32(JL.rms_norm(x, w, 1e-6)), **LAYER)
    for pos in (np.arange(5), np.array([[3, 4, 5, 6, 7], [0, 9, 2, 8, 1]])):
        want = JL.rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
        got = L.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
        np.testing.assert_allclose(f32(got), f32(want), **LAYER)


def test_rms_norm_keeps_bfloat16():
    x = np.random.default_rng(1).standard_normal((4, 32)).astype(np.float32)
    w = np.zeros(32, np.float32)
    got = L.rms_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w), 1e-6)
    want = JL.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), 1e-6)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(f32(got), f32(want))


def test_embed_mlp_unembed():
    _, params, tm = pair()
    p = jax.tree.map(np.asarray, params)
    toks = tokens(tm.cfg)
    x = JL.embed_tokens(p["embed"], jnp.asarray(toks), jnp.float32)
    got = L.embed_tokens(tm.params.embed, torch.from_numpy(toks).long())
    np.testing.assert_array_equal(f32(got), f32(x))
    mlp0 = jax.tree.map(lambda a: a[0], p["layers"]["mlp"])
    np.testing.assert_allclose(
        f32(L.mlp(tm.params.layers[0].mlp, got)),
        f32(JL.mlp(mlp0, x, jnp.float32)), **LAYER)
    np.testing.assert_allclose(
        f32(L.unembed(tm.params.embed, got)),
        f32(JL.unembed(p["embed"], x, jnp.float32)), **LAYER)


# ---------------------------------------------------------------------------
# The attention block.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_attention_block_full_and_decode(arch):
    _, params, tm = pair(arch)
    cfg = tm.cfg
    attn0 = jax.tree.map(lambda a: np.asarray(a[0]),
                         params["layers"]["attn"])
    x = np.random.default_rng(2).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)
    pos = np.arange(12)
    want, (jk, jv) = JA.attn_full(attn0, cfg, jnp.asarray(x),
                                  jnp.asarray(pos), jnp.float32)
    tp = tm.params.layers[0].attn
    got, (tk, tv) = A.attn_full(
        tp, cfg, torch.from_numpy(x),
        L.rope_tables(torch.from_numpy(pos), cfg.head_dim, cfg.rope_theta))
    for a, b in ((got, want), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(f32(a), f32(b), **F32)
    assert tk.is_contiguous() and tk.shape == (2, cfg.num_kv_heads, 12,
                                               cfg.head_dim)

    # one token at position 12 against a 16-slot cache holding the 12
    xt = x[:, :1] * 0.5
    kc = np.zeros((2, cfg.num_kv_heads, 16, cfg.head_dim), np.float32)
    vc = kc.copy()
    kc[:, :, :12], vc[:, :, :12] = f32(jk), f32(jv)
    want, jkc, jvc = JA.attn_decode(attn0, cfg, jnp.asarray(xt),
                                    jnp.int32(12), jnp.asarray(kc),
                                    jnp.asarray(vc), jnp.int32(13),
                                    jnp.int32(12), jnp.float32)
    tkc, tvc = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got, k2, v2 = A.attn_decode(
        tp, cfg, torch.from_numpy(xt),
        L.rope_tables(torch.tensor([12]), cfg.head_dim, cfg.rope_theta),
        tkc, tvc, torch.full((2,), 13, dtype=torch.int32), 12)
    assert k2 is tkc and v2 is tvc                  # written in place
    for a, b in ((got, want), (k2, jkc), (v2, jvc)):
        np.testing.assert_allclose(f32(a), f32(b), **F32)


# ---------------------------------------------------------------------------
# The transformer and the model API.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_forward_and_decode_step_float32(arch):
    jm, params, tm = pair(arch)
    toks = tokens(tm.cfg)
    want, _ = jm.forward(params, {"tokens": jnp.asarray(toks)})
    got, aux = tm({"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, 24, tm.cfg.vocab_size) and aux == 0.0
    np.testing.assert_allclose(f32(got), f32(want), **F32)

    _, jc = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :-1])},
                       max_len=24)
    _, tc = tm.prefill({"tokens": torch.from_numpy(toks[:, :-1]).long()},
                       max_len=24)
    for a, b in zip(tc["layers"], jc["layers"]):
        assert a.shape == b.shape == (tm.cfg.num_layers, 2,
                                      tm.cfg.num_kv_heads, 24,
                                      tm.cfg.head_dim)
        np.testing.assert_allclose(f32(a), f32(b), **F32)
    jl, _ = JT.decode_step(params, jm.cfg, jc, jnp.asarray(toks[:, -1:]),
                           jnp.int32(23))
    tl, tc2 = T.decode_step(tm.params, tm.cfg, tc,
                            torch.from_numpy(toks[:, -1:]).long(), 23)
    assert tc2 is tc
    np.testing.assert_allclose(f32(tl), f32(jl), **F32)


def test_forward_and_decode_bfloat16():
    jm, params, tm = pair(dtype="bfloat16")
    assert tm.params.layers[0].attn["wq"].dtype == torch.bfloat16
    assert tm.params.layers[0].ln1.dtype == torch.float32
    toks = tokens(tm.cfg)
    want, _ = jm.forward(params, {"tokens": jnp.asarray(toks)})
    got, _ = tm({"tokens": torch.from_numpy(toks).long()})
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(want), **BF16)
    _, jc = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :-1])},
                       max_len=24)
    jl, _ = jm.decode(params, jc, {"token": jnp.asarray(toks[:, -1:]),
                                   "pos": jnp.int32(23)})
    _, tc = tm.prefill({"tokens": torch.from_numpy(toks[:, :-1]).long()},
                       max_len=24)
    tl, _ = tm.decode(tc, {"token": torch.from_numpy(toks[:, -1:]).long(),
                           "pos": 23})
    np.testing.assert_allclose(f32(tl), f32(jl), **BF16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_decode_matches_own_full_forward(dtype):
    # tests/test_models.py's serving contract, on the port alone: prefill
    # S-1 tokens, decode the last, equal the full forward's last position
    cfg = dataclasses.replace(get_config("qwen3-4b", reduced=True),
                              dtype=dtype)
    model = build_model(cfg, device="cpu", seed=3)
    toks = torch.from_numpy(tokens(cfg, S=24, seed=4)).long()
    full, _ = model({"tokens": toks})
    last, cache = model.prefill({"tokens": toks[:, :-1]}, max_len=24)
    np.testing.assert_allclose(f32(last[:, 0]), f32(full[:, -2]),
                               **(F32 if dtype == "float32" else BF16))
    lg, _ = model.decode(cache, {"token": toks[:, -1:], "pos": 23})
    np.testing.assert_allclose(f32(lg[:, 0]), f32(full[:, -1]),
                               **(F32 if dtype == "float32" else BF16))


def test_init_cache_and_weight_scales():
    cfg = get_config("qwen3-4b", reduced=True)
    model = build_model(cfg, device="cpu")
    k, v = model.init_cache(3, 10)["layers"]
    assert k.shape == v.shape == (cfg.num_layers, 3, cfg.num_kv_heads, 10,
                                  cfg.head_dim)
    assert k.dtype == torch.bfloat16 and not k.any()
    wq = model.params.layers[0].attn["wq"].float()
    assert abs(wq.std().item() - cfg.d_model ** -0.5) < 0.02
    tok = model.params.embed["tok"].float()
    assert abs(tok.std().item() - 1.0) < 0.05
    again = build_model(cfg, device="cpu")
    assert torch.equal(again.params.embed["unembed"],
                       model.params.embed["unembed"])


def test_convert_refuses_a_misshapen_pytree():
    jm, params, _ = pair()
    p = jax.tree.map(np.asarray, params)
    p["final_norm"] = np.zeros(7, np.float32)
    with pytest.raises(RuntimeError, match="final_norm"):
        model_params_to_torch(p, port_config("qwen3-4b"), "cpu")
    p = jax.tree.map(np.asarray, params)
    p["layers"] = jax.tree.map(lambda a: a[:1], p["layers"])
    with pytest.raises(RuntimeError, match="layers.1"):
        model_params_to_torch(p, port_config("qwen3-4b"), "cpu")
    p = jax.tree.map(np.asarray, params)
    del p["embed"]["unembed"]
    with pytest.raises(RuntimeError, match="unembed"):
        model_params_to_torch(p, port_config("qwen3-4b"), "cpu")


def test_remat_raises(monkeypatch):
    # remat trains every stack (tests/test_torch_train_step.py); on the
    # card the SSM stack's scan runs as ops.SSDScan (the ssd kernel, then
    # ssd_bwd): with the two wrappers swapped for their plain versions it
    # gives the CPU's loss and gradients; a kernel that has no backward
    # (decode attention) still raises instead of losing the gradient
    from repro_torch.kernels import decode_attention as tdec
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd as tssd
    model = build_model(get_config("mamba2-1.3b", reduced=True),
                        device="cpu").trainable()
    tokens = torch.arange(8, dtype=torch.int32)[None] % 7
    batch = {"tokens": tokens, "targets": (tokens + 1) % 7}
    params = list(model.parameters())

    def loss_and_grads():
        loss = model.loss(batch, remat=True)
        return loss, torch.autograd.grad(loss, params)

    want = loss_and_grads()
    calls = []
    monkeypatch.setattr(ops, "_on_host", lambda x: False)
    monkeypatch.setattr(tssd, "ssd", lambda *a, chunk: ref.ssd(*a))
    monkeypatch.setattr(tssd, "ssd_bwd",
                        lambda *a: calls.append(1) or ref.ssd_grads(*a))
    got = loss_and_grads()
    assert len(calls) == model.cfg.num_layers
    torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=1e-6)
    for g, w in zip(got[1], want[1]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    monkeypatch.setattr(tdec, "_launcher", lambda: None)
    q = torch.zeros(1, 4, 16, requires_grad=True)
    kv = torch.zeros(1, 1, 8, 16)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.decode_attention(q, kv, kv, torch.ones(1, dtype=torch.int32))
