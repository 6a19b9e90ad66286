"""The port's Whisper encoder-decoder on the CPU against the JAX package
(``repro.models.whisper`` through ``repro.models.build_model``), with
the JAX package's weights carried across by
``repro_torch.convert.model_params_to_torch`` and its caches by
``model_cache_to_torch``.

The reduced whisper-tiny: one encoder and one decoder layer, d_model 64,
4 query heads over 2 kv heads of 16, 16 encoder frames
(``cross_kv_len``), ``max_decode_len`` 32. Decoder lengths of 16 take
the cross-attention's kernel branch (Sd == Se: ``ops.attention``, non
causal), other lengths the reference's float32 grouped einsum. The self
K/V leaves prefill as a ring of 32 slots; decode from position 28 wraps
the ring at 32 and reads the positional table's last row from there on
(the reference's ``dynamic_slice_in_dim`` clamps).

Tolerances, ``tests/test_torch_models.py``'s: float32 logits, caches
and activations to ``rtol=atol=2e-4`` (measured ~2e-6), bfloat16 logits
to ``rtol=2e-2, atol=0.0625`` (two bfloat16 steps at the logits'
magnitude), the bfloat16 reference compiled without excess precision
(``test_torch_moe.strict``); the sinusoidal table to ``atol=2.5e-4``:
the frequencies are equal bit for bit and the arguments too, but a sine
of an argument near 1,500 is known only to that argument's float32 ULP
(1.2e-4), and XLA:CPU's ``sin``/``cos`` reduce such arguments that
loosely in some runs of this suite (6 % of the (1500, 384) table up to
1.5e-4 from torch's, twice in about ten runs; else within one ULP of
the result, 6e-8); two ULPs of the largest argument allow for it, and
any slip in the formula moves entries by O(1). The JAX decode runs the
naive path (``REPRO_DECODE_IMPL``).
"""
import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models import whisper as JW
from repro_torch.convert import model_cache_to_torch
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models import whisper as W
from repro_torch.serving import ServingEngine
from test_torch_hybrid import assert_caches
from test_torch_models import BF16, F32, f32, naive_decode, tokens
from test_torch_moe import pair, strict

__all__ = ["naive_decode"]          # the autouse fixture, imported
SE, CAP = 16, 32                    # reduced cross_kv_len, max_decode_len


@pytest.fixture(scope="module")
def f32_pair():
    return pair("whisper-tiny")


def frames(cfg, B=2, seed=2) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.cross_kv_len, cfg.d_model)).astype(np.float32)


def batches(cfg, Sd: int, seed: int = 1):
    """The same batch for the reference and the port: frames (2, Se, d)
    and decoder tokens (2, Sd)."""
    fr, toks = frames(cfg, seed=seed + 1), tokens(cfg, S=Sd, seed=seed)
    return ({"frames": jnp.asarray(fr), "tokens": jnp.asarray(toks)},
            {"frames": torch.from_numpy(fr),
             "tokens": torch.from_numpy(toks).long()})


@pytest.mark.parametrize("num,dim", [(1500, 384), (448, 384), (16, 64)])
def test_sinusoidal_positions_match_the_reference(num, dim):
    got = L.sinusoidal_positions(num, dim)
    assert got.dtype == torch.float32 and got.shape == (num, dim)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(JL.sinusoidal_positions(num, dim)),
                               rtol=0, atol=2.5e-4)


def test_encode_matches_the_reference(f32_pair):
    _, params, tm = f32_pair
    fr = frames(tm.cfg)
    want = JW.encode(params, tm.cfg, jnp.asarray(fr))
    got = W.encode(tm.params, tm.cfg, torch.from_numpy(fr))
    assert got.shape == (2, SE, tm.cfg.d_model)
    np.testing.assert_allclose(f32(got), f32(want), **F32)


@pytest.mark.parametrize("Sd", [SE, 10])
def test_decode_full_logits_and_caches(f32_pair, monkeypatch, Sd):
    # both cross-attention branches: the kernel at Sd == Se (non causal),
    # the grouped float32 einsum otherwise
    _, params, tm = f32_pair
    jb, tb = batches(tm.cfg, Sd)
    enc = JW.encode(params, tm.cfg, jb["frames"])
    want, jc = JW.decode_full(params, tm.cfg, jb["tokens"], enc,
                              collect_cache=True)
    calls = []
    plain = ops.attention
    monkeypatch.setattr(ops, "attention", lambda q, k, v, causal=True, **kw:
                        calls.append(causal) or plain(q, k, v, causal, **kw))
    got, tc = W.decode_full(tm.params, tm.cfg, tb["tokens"],
                            torch.from_numpy(np.array(enc)),
                            collect_cache=True)
    assert calls == ([True, False] if Sd == SE else [True])
    np.testing.assert_allclose(f32(got), f32(want), **F32)
    L_, H, D = tm.cfg.num_layers, tm.cfg.num_kv_heads, tm.cfg.head_dim
    for a, b, S in zip(tc, jc, (Sd, Sd, SE, SE)):
        assert tuple(a.shape) == b.shape == (L_, 2, H, S, D)
        np.testing.assert_allclose(f32(a), f32(b), **F32)


@pytest.mark.parametrize("Sd", [5, SE, CAP + 8])
def test_prefill_returns_the_self_ring_and_the_cross_cache(f32_pair, Sd):
    jm, params, tm = f32_pair
    jb, tb = batches(tm.cfg, Sd, seed=3)
    jl, jc = jm.prefill(params, jb)
    tl, tc = tm.prefill(tb, max_len=Sd + 100)       # Whisper ignores max_len
    np.testing.assert_allclose(f32(tl), f32(jl), **F32)
    assert tl.shape == (2, 1, tm.cfg.vocab_size)
    assert [t.shape[-2] for t in tc["layers"]] == [CAP, CAP, SE, SE]
    assert_caches(tc, model_cache_to_torch(jc, "cpu"), **F32)
    _, (k_all, *_) = W.decode_full(
        tm.params, tm.cfg, tb["tokens"],
        W.encode(tm.params, tm.cfg, tb["frames"]), collect_cache=True)
    for t in range(max(Sd - CAP, 0), Sd):           # position t in slot t % 32
        assert torch.equal(tc["layers"][0][..., t % CAP, :], k_all[..., t, :])


def test_decode_across_the_ring_wrap_and_the_position_clamp(f32_pair):
    # prefill 28 tokens, decode 28..37: slots 28..31, then 0..5 (the ring
    # wraps at 32); positions from 32 on read the table's row 31
    jm, params, tm = f32_pair
    steps = 10
    jb, tb = batches(tm.cfg, 28 + steps, seed=4)
    toks = np.asarray(jb["tokens"])
    _, jc = jm.prefill(params, {"frames": jb["frames"],
                                "tokens": jb["tokens"][:, :28]})
    _, tc = tm.prefill({"frames": tb["frames"],
                        "tokens": tb["tokens"][:, :28]})
    cross = [t.clone() for t in tc["layers"][2:]]
    dec = jax.jit(jm.decode)
    for pos in range(28, 28 + steps):
        tok = np.array(toks[:, pos:pos + 1])
        jl, jc = dec(params, jc, {"token": jnp.asarray(tok),
                                  "pos": jnp.int32(pos)})
        tl, tc2 = tm.decode(tc, {"token": torch.from_numpy(tok).long(),
                                 "pos": pos})
        assert tc2 is tc
        np.testing.assert_allclose(f32(tl), f32(jl), err_msg=str(pos), **F32)
        assert_caches(tc, model_cache_to_torch(jc, "cpu"), **F32)
    for a, b in zip(tc["layers"][2:], cross):        # read, never written
        assert torch.equal(a, b)


def test_decode_from_the_reference_cache_and_a_tensor_position(f32_pair):
    # the reference's prefill state injected into the port's decode; the
    # step with the position as a device tensor (as a CUDA graph feeds
    # it) equals the step with an int, past the clamp
    jm, params, tm = f32_pair
    jb, tb = batches(tm.cfg, CAP + 2, seed=5)
    _, jc = jm.prefill(params, jb)
    tok = np.array(jb["tokens"][:, -1:])
    jl, jc2 = jm.decode(params, jc, {"token": jnp.asarray(tok),
                                     "pos": jnp.int32(CAP + 2)})
    c_int, c_pos = model_cache_to_torch(jc, "cpu"), model_cache_to_torch(jc, "cpu")
    t = torch.from_numpy(tok).long()
    got_int, _ = W.decode_step(tm.params, tm.cfg, c_int, t, CAP + 2)
    got_pos, _ = W.decode_step(tm.params, tm.cfg, c_pos, t,
                               torch.tensor([CAP + 2]))
    np.testing.assert_allclose(f32(got_int), f32(jl), **F32)
    assert_caches(c_int, model_cache_to_torch(jc2, "cpu"), **F32)
    assert torch.equal(got_int, got_pos)
    for a, b in zip(c_int["layers"], c_pos["layers"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_decode_matches_own_full_forward(dtype):
    # tests/test_models.py's serving contract on the port alone: prefill
    # Sd - 1 tokens, decode the last, equal the full forward's last position
    _, _, tm = pair("whisper-tiny", dtype)
    _, tb = batches(tm.cfg, 12, seed=6)
    full, aux = tm(tb)
    assert full.shape == (2, 12, tm.cfg.vocab_size) and aux == 0.0
    tol = F32 if dtype == "float32" else BF16
    last, cache = tm.prefill({"frames": tb["frames"],
                              "tokens": tb["tokens"][:, :-1]})
    np.testing.assert_allclose(f32(last[:, 0]), f32(full[:, -2]), **tol)
    lg, _ = tm.decode(cache, {"token": tb["tokens"][:, -1:], "pos": 11})
    np.testing.assert_allclose(f32(lg[:, 0]), f32(full[:, -1]), **tol)


def test_whisper_bfloat16_against_the_reference():
    jm, params, tm = pair("whisper-tiny", "bfloat16")
    assert tm.params.dec_layers[0].cross_attn["wq"].dtype == torch.bfloat16
    jb, tb = batches(tm.cfg, 12, seed=7)
    want, _ = strict(jm.forward, params, jb)
    got, _ = tm(tb)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(want), **BF16)
    head = {"frames": jb["frames"], "tokens": jb["tokens"][:, :-1]}
    _, jc = strict(jm.prefill, params, head)
    jl, _ = strict(jm.decode, params, jc,
                   {"token": jb["tokens"][:, -1:], "pos": jnp.int32(11)})
    _, tc = tm.prefill({"frames": tb["frames"],
                        "tokens": tb["tokens"][:, :-1]})
    tl, _ = tm.decode(tc, {"token": tb["tokens"][:, -1:], "pos": 11})
    np.testing.assert_allclose(f32(tl), f32(jl), **BF16)


def test_init_cache_and_the_cache_layout(f32_pair):
    _, _, tm = f32_pair
    cfg = tm.cfg
    assert tm.layout == {"layers": (T.RING, T.RING, W.READ, W.READ)}
    for S, slots in ((10, 10), (100, CAP)):
        c = tm.init_cache(3, S)["layers"]
        assert [tuple(t.shape) for t in c] == [
            (cfg.num_layers, 3, cfg.num_kv_heads, n, cfg.head_dim)
            for n in (slots, slots, SE, SE)]
    assert len(tm.params.enc_layers) == cfg.encoder_layers
    assert "unembed" not in tm.params.embed             # tied


def served(monkeypatch, argv):
    """``serve.main(argv)`` on the CPU with the engines' calls recorded:
    (the JSON report, each prefill's batch shapes, each decode's
    position, the engines' max_len)."""
    seen = dict(batches=[], positions=[], max_len=set())
    prefill, decode = ServingEngine.prefill, ServingEngine.decode

    def rec_prefill(self, batch):
        seen["max_len"].add(self.max_len)
        seen["batches"].append({k: tuple(v.shape) for k, v in batch.items()})
        return prefill(self, batch)

    def rec_decode(self, cache, token, pos):
        seen["positions"].append(pos)
        return decode(self, cache, token, pos)

    monkeypatch.setattr(ServingEngine, "prefill", rec_prefill)
    monkeypatch.setattr(ServingEngine, "decode", rec_decode)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(argv + ["--smoke", "--device", "cpu", "--requests", "2",
                           "--frontends", "2", "--batch", "2"])
    return json.loads(out.getvalue().strip().splitlines()[-1]), seen


def test_serve_sends_frames_and_decodes_from_the_prompt(monkeypatch):
    rep, seen = served(monkeypatch, ["--arch", "whisper-tiny",
                                     "--prompt-len", "4",
                                     "--decode-steps", "3"])
    assert rep["arch"] == "whisper-tiny-smoke" and rep["logits_finite"]
    assert rep["prefills"] == 4 and rep["decodes"] == 12
    assert seen["batches"] == [{"frames": (2, SE, 64), "tokens": (2, 4)}] * 4
    assert seen["positions"] == [4, 5, 6] * 4


def test_serve_refuses_a_decode_past_max_decode_len(monkeypatch):
    with pytest.raises(ValueError, match="at most 32 positions"):
        served(monkeypatch, ["--arch", "whisper-tiny", "--prompt-len", "30",
                             "--decode-steps", "3"])
