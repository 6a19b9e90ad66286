"""The port's SSM serving slice on the CPU against the JAX package: the
plain SSD scan and single-token update (``repro_torch.kernels.ref``,
what ``kernels.ops`` runs for a CPU tensor) against the JAX oracles and
the Pallas SSD body in interpret mode; the Mamba-2 block; the reduced
mamba2 model with the JAX package's weights carried across by
``repro_torch.convert.model_params_to_torch``; the serving launcher; and
the device dispatch of the SSD kernel.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them
against their plain version there); here the bf16 kernel's arithmetic
(its operands as bf16 terms) is modelled in torch and scored against the
plain version with ``chip_smoke.py``'s allowance, and the launch
geometry its wrapper mirrors in Python is checked.

Tolerances:
- SSD scan, float32: ``rtol=atol=1e-5`` against the JAX sequential
  oracle (the same recurrence; einsum and exp round differently), and
  ``rtol=atol=1e-3`` against the chunked Pallas body, the bound
  ``tests/test_kernels.py`` holds that body to (the chunked form
  reassociates the decays). bfloat16 x: one bfloat16 step of the
  output (``rtol=atol=2e-2`` after the cast).
- Mamba-2 block and model in float32: ``rtol=atol=1e-4`` (measured
  ~1e-5: matrix products summed in another order).
- In bfloat16: ``rtol=2e-2, atol=0.0625``, the dense tests' bound,
  against the reference evaluated op by op (the block, and the model
  under ``jax.disable_jit``; measured 0.0 for both). Against the jitted
  reference model the bound is ``atol=0.125`` (eight bfloat16 steps at
  unit scale): the jitted JAX forward differs from its own op-by-op
  evaluation by up to 0.082 at logits of ~3.6, because XLA:CPU fuses
  the bfloat16 elementwise chains (the conv taps, the residual adds)
  without rounding between ops, while the port rounds after every op
  as the eager reference does. Measured against the jitted model:
  0.078.
"""
import contextlib
import functools
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels import ref as jref
from repro.kernels import ssd as jssd
from repro.models import build_model as jax_build
from repro.models import ssm as JS
from repro_torch.configs import ModelConfig, get_config
from repro_torch.convert import model_params_to_torch
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import ssd as tssd
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models import ssm as S

SCAN = dict(rtol=1e-5, atol=1e-5)
CHUNKED = dict(rtol=1e-3, atol=1e-3)
F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=0.0625)
BF16_JIT = dict(rtol=2e-2, atol=0.125)
# (B, S, H, P, N, chunk): tests/test_kernels.py's SSD sweep
SSD_CASES = [(2, 96, 2, 16, 8, 32),
             (1, 64, 4, 32, 16, 64),
             (2, 130, 2, 16, 8, 32),       # S not a chunk multiple
             (1, 256, 2, 64, 128, 128)]    # mamba2-1.3b-like dims
ARCH = "mamba2-1.3b"
MATRICES = ("in_proj", "out_proj", "conv_w", "conv_b")


def ssd_inputs(B, S, H, P, N, seed):
    """As ``tests/test_kernels.py`` draws them."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (rng.normal(0, 1, (B, S, H, P)).astype(f32),
            rng.uniform(0.001, 0.1, (B, S, H)).astype(f32),
            (-rng.uniform(0.5, 2, (H,))).astype(f32),
            rng.normal(0, 1, (B, S, N)).astype(f32),
            rng.normal(0, 1, (B, S, N)).astype(f32))


def T(x) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(x), copy=True))


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def port_config(dtype: str) -> ModelConfig:
    """The reference's reduced mamba2 config, field for field."""
    return ModelConfig(**{**dataclasses.asdict(jax_config(ARCH, reduced=True)),
                          "dtype": dtype})


def pair(dtype: str, seed: int = 0):
    """(JAX model, its params, the port's model with the same weights)."""
    jm = jax_build(dataclasses.replace(jax_config(ARCH, reduced=True),
                                       dtype=dtype))
    params = jm.init(jax.random.PRNGKey(seed))
    tm = model_params_to_torch(jax.tree.map(np.asarray, params),
                               port_config(dtype), "cpu")
    return jm, params, tm


def tokens(cfg, B=2, S=40, seed=1):
    t = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))
    return t.astype(np.int32)


# ---------------------------------------------------------------------------
# The SSD scan and the single-token update.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("oracle", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_plain_vs_reference(case, oracle):
    B, S, H, P, N, c = case
    x, dt, A, Bm, Cm = ssd_inputs(B, S, H, P, N, seed=S + N)
    got = ref.ssd(T(x), T(dt), T(A), T(Bm), T(Cm))
    assert got.shape == (B, S, H, P) and got.dtype == torch.float32
    if oracle == "ref":
        want = jax.jit(jref.ssd)(x, dt, A, Bm, Cm)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN)
    else:
        want = jssd.ssd(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)),
                        chunk=c, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **CHUNKED)


def test_ssd_keeps_bfloat16():
    x, dt, A, Bm, Cm = ssd_inputs(2, 40, 2, 16, 8, seed=5)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = jax.jit(jref.ssd)(xb, dt, A, Bm, Cm)
    got = ref.ssd(T(f32(xb)).bfloat16(), T(dt), T(A), T(Bm), T(Cm))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(want), rtol=2e-2, atol=2e-2)


def test_ssd_decode_step_steps_through_the_scan():
    B, S, H, P, N = 2, 32, 2, 8, 4
    x, dt, A, Bm, Cm = (T(a) for a in ssd_inputs(B, S, H, P, N, seed=7))
    want = ref.ssd(x, dt, A, Bm, Cm)
    h = torch.zeros(B, H, N, P)
    for t in range(S):
        h, y = ops.ssd_decode_step(h, x[:, t], dt[:, t], A, Bm[:, t],
                                   Cm[:, t])
        np.testing.assert_allclose(y.numpy(), want[:, t].numpy(), **SCAN)
    jh = jnp.zeros((B, H, N, P), jnp.float32)
    for t in range(S):
        jh, _ = jref.ssd_decode_step(
            jh, x[:, t].numpy(), dt[:, t].numpy(), A.numpy(),
            Bm[:, t].numpy(), Cm[:, t].numpy())
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **SCAN)


def test_ops_ssd_on_the_host_is_the_plain_version():
    x, dt, A, Bm, Cm = (T(a) for a in ssd_inputs(1, 20, 2, 16, 8, seed=9))
    assert torch.equal(ops.ssd(x, dt, A, Bm, Cm, chunk=8),
                       ref.ssd(x, dt, A, Bm, Cm))
    assert tssd.ssd.launches == 0


# ---------------------------------------------------------------------------
# The Mamba-2 block.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_block_full_and_decode(dtype):
    jcfg = dataclasses.replace(jax_config(ARCH, reduced=True), dtype=dtype)
    cfg = port_config(dtype)
    p = jax.tree.map(np.asarray, JS.init_ssm(jax.random.PRNGKey(3), jcfg))
    tdt = getattr(torch, dtype)
    tp = {k: T(v).to(tdt if k in MATRICES else torch.float32)
          for k, v in p.items()}
    jx = jnp.asarray(np.random.default_rng(0).standard_normal(
        (2, 40, cfg.d_model)), dtype)
    tx = T(f32(jx)).to(tdt)
    tol = F32 if dtype == "float32" else BF16

    want = JS.ssm_full(p, jcfg, jx, jnp.dtype(dtype))
    got = S.ssm_full(tp, cfg, tx)
    assert got.dtype == tdt and got.shape == (2, 40, cfg.d_model)
    np.testing.assert_allclose(f32(got), f32(want), **tol)

    jo, (jconv, jh) = JS.ssm_full(p, jcfg, jx, jnp.dtype(dtype),
                                  return_state=True)
    to, (tconv, th) = S.ssm_full(tp, cfg, tx, return_state=True)
    assert tconv.dtype == tdt and th.dtype == torch.float32
    assert th.shape == (2, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim)
    for a, b in ((to, jo), (tconv, jconv), (th, jh)):
        assert a.shape == b.shape
        np.testing.assert_allclose(f32(a), f32(b), **tol)

    jo, jconv2, jh2 = JS.ssm_decode(p, jcfg, jx[:, :1], jconv, jh,
                                    jnp.dtype(dtype))
    to, tconv2, th2 = S.ssm_decode(tp, cfg, tx[:, :1], tconv, th)
    assert to.shape == (2, 1, cfg.d_model)
    for a, b in ((to, jo), (tconv2, jconv2), (th2, jh2)):
        np.testing.assert_allclose(f32(a), f32(b), **tol)


# ---------------------------------------------------------------------------
# The reduced mamba2 model through model_params_to_torch.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_forward_prefill_and_decode(dtype, monkeypatch):
    monkeypatch.setenv("REPRO_DECODE_IMPL", "naive")
    jm, params, tm = pair(dtype)
    cfg = tm.cfg
    tol = F32 if dtype == "float32" else BF16_JIT
    layer = tm.params.layers[0]
    assert layer.ssm["in_proj"].dtype == getattr(torch, dtype)
    assert layer.ssm["A_log"].dtype == torch.float32
    assert not hasattr(layer, "attn") and not hasattr(layer, "mlp")
    toks = tokens(cfg)

    want, _ = jm.forward(params, {"tokens": jnp.asarray(toks)})
    got, aux = tm({"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, 40, cfg.vocab_size) and aux == 0.0
    np.testing.assert_allclose(f32(got), f32(want), **tol)

    S0 = 36
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :S0])},
                        max_len=40)
    tl, tc = tm.prefill({"tokens": torch.from_numpy(toks[:, :S0]).long()},
                        max_len=40)
    np.testing.assert_allclose(f32(tl), f32(jl), **tol)
    conv_dim = cfg.ssm_inner + 2 * cfg.ssm_state
    shapes = ((cfg.num_layers, 2, cfg.ssm_conv - 1, conv_dim),
              (cfg.num_layers, 2, cfg.ssm_heads, cfg.ssm_state,
               cfg.ssm_head_dim))
    for a, b, shape in zip(tc["layers"], jc["layers"], shapes):
        assert a.shape == b.shape == shape
        np.testing.assert_allclose(f32(a), f32(b), **tol)
    before = [t.data_ptr() for t in tc["layers"]]
    for pos in range(S0, 40):
        batch = {"token": toks[:, pos:pos + 1], "pos": pos}
        jl, jc = jm.decode(params, jc, {"token": jnp.asarray(batch["token"]),
                                        "pos": jnp.int32(pos)})
        tl, tc = tm.decode(tc, {"token": torch.from_numpy(
            batch["token"]).long(), "pos": pos})
        np.testing.assert_allclose(f32(tl), f32(jl), **tol)
    assert [t.data_ptr() for t in tc["layers"]] == before   # in place
    for a, b in zip(tc["layers"], jc["layers"]):
        np.testing.assert_allclose(f32(a), f32(b), **tol)


def test_mamba2_bfloat16_matches_the_reference_op_by_op():
    # the jitted reference fuses bfloat16 elementwise chains; op by op it
    # rounds where the port does
    jm, params, tm = pair("bfloat16")
    toks = tokens(tm.cfg, S=12)
    with jax.disable_jit():
        want, _ = jm.forward(params, {"tokens": jnp.asarray(toks)})
    got, _ = tm({"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(f32(got), f32(want), **BF16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_decode_matches_own_full_forward(dtype):
    cfg = dataclasses.replace(get_config(ARCH, reduced=True), dtype=dtype)
    model = build_model(cfg, device="cpu", seed=3)
    toks = torch.from_numpy(tokens(cfg, S=24, seed=4)).long()
    full, _ = model({"tokens": toks})
    tol = F32 if dtype == "float32" else BF16
    last, cache = model.prefill({"tokens": toks[:, :20]}, max_len=24)
    np.testing.assert_allclose(f32(last[:, 0]), f32(full[:, 19]), **tol)
    for pos in range(20, 24):
        lg, cache = model.decode(cache, {"token": toks[:, pos:pos + 1],
                                         "pos": pos})
        np.testing.assert_allclose(f32(lg[:, 0]), f32(full[:, pos]), **tol)


def test_init_cache_is_the_ssm_zeros():
    cfg = get_config(ARCH, reduced=True)
    model = build_model(cfg, device="cpu")
    conv, h = model.init_cache(3, 10)["layers"]
    assert conv.shape == (cfg.num_layers, 3, cfg.ssm_conv - 1,
                          cfg.ssm_inner + 2 * cfg.ssm_state)
    assert conv.dtype == torch.bfloat16 and not conv.any()
    assert h.shape == (cfg.num_layers, 3, cfg.ssm_heads, cfg.ssm_state,
                       cfg.ssm_head_dim)
    assert h.dtype == torch.float32 and not h.any()
    # decoding from the zero caches equals prefilling one token (the two
    # conv paths round in another order in bfloat16)
    tok = torch.from_numpy(tokens(cfg, B=3, S=1)).long()
    lg, _ = model.decode({"layers": (conv, h)}, {"token": tok, "pos": 0})
    want, _ = model.prefill({"tokens": tok})
    np.testing.assert_allclose(f32(lg), f32(want), **BF16)


def test_published_config_and_weight_layout():
    full = get_config(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(jax_config(ARCH))
    assert full.param_count() == 1_343_430_656
    model = build_model(get_config(ARCH, reduced=True), device="cpu")
    ssm0 = model.params.layers[0].ssm
    np.testing.assert_allclose(
        -torch.exp(ssm0["A_log"]).numpy(),
        -np.linspace(1.0, 16.0, model.cfg.ssm_heads), rtol=1e-6)
    assert set(ssm0.keys()) == {"in_proj", "conv_w", "conv_b", "A_log",
                                "dt_bias", "norm", "out_proj"}


def test_convert_refuses_a_misshapen_ssm_pytree():
    _, params, _ = pair("float32")
    p = jax.tree.map(np.asarray, params)
    p["layers"]["ssm"]["A_log"] = p["layers"]["ssm"]["A_log"][:, :1]
    with pytest.raises(RuntimeError, match="A_log"):
        model_params_to_torch(p, port_config("float32"), "cpu")
    p = jax.tree.map(np.asarray, params)
    del p["layers"]["ssm"]["dt_bias"]
    with pytest.raises(RuntimeError, match="dt_bias"):
        model_params_to_torch(p, port_config("float32"), "cpu")


# ---------------------------------------------------------------------------
# Serving and dispatch.
# ---------------------------------------------------------------------------

def test_serve_mamba2_runs_to_the_end_on_the_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        router = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                             "--requests", "4", "--frontends", "2",
                             "--batch", "2", "--prompt-len", "20",
                             "--decode-steps", "3", "--slow-replica", "2"])
    assert router.weights.shape == (2, 3)
    report = json.loads(out.getvalue().strip().splitlines()[-1])
    assert report["arch"] == "mamba2-1.3b-smoke" and report["device"] == "cpu"
    assert report["microbatches"] == report["prefills"] == 8
    assert report["decodes"] == 8 * 3 == len(report["decode_s"])
    assert report["logits_finite"] and report["maintenance_calls"] >= 1


def test_ssd_dispatch_raises_without_a_kernel_library(monkeypatch, tmp_path):
    def missing():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(_build, "nvcc", missing)
    monkeypatch.setattr(_build, "LIBRARY", tmp_path / "libreprotorch.so")
    monkeypatch.setattr(_build, "_lib", None)
    tssd._launcher.cache_clear()
    monkeypatch.setattr(ops, "_on_host", lambda x: False)
    args = (T(a) for a in ssd_inputs(1, 20, 2, 16, 8, seed=1))
    with pytest.raises(RuntimeError, match="nvcc"):
        ops.ssd(*args)
    assert tssd.ssd.launches == 0


def test_ssd_wrapper_refuses_host_tensors(monkeypatch):
    # with a library present the wrapper still checks the device first
    monkeypatch.setattr(tssd, "_launcher", lambda: None)
    args = (T(a) for a in ssd_inputs(1, 20, 2, 16, 8, seed=1))
    with pytest.raises(ValueError, match="CUDA"):
        tssd.ssd(*args)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "hymba-1.5b"])
def test_ssd_kernel_is_built_for_the_ssm_configs(arch):
    # every (state, head) width the reference's SSM configs use, full and
    # reduced, is a template instance of csrc/ssd.cu
    for reduced in (False, True):
        cfg = jax_config(arch, reduced=reduced)
        assert cfg.ssm_state in tssd.STATE_DIMS, cfg.name
        assert cfg.ssm_head_dim in tssd.HEAD_DIMS, cfg.name


# ---------------------------------------------------------------------------
# The bfloat16 kernel's arithmetic and launch geometry, mirrored on the CPU.
# ---------------------------------------------------------------------------

def in_bf16_terms(t, terms):
    """``t`` as the sum of ``terms`` bf16 values (0: exact float32): hi =
    t rounded, lo = the remainder rounded."""
    if terms == 0:
        return t
    hi = t.bfloat16().float()
    return hi if terms == 1 else hi + (t - hi).bfloat16().float()


def product_in_bf16_terms(a, b, terms):
    """a @ b with both float32 operands as bf16 terms; with two, the three
    products hi.hi + hi.lo + lo.hi that the kernel issues."""
    if terms != 2:
        return in_bf16_terms(a, terms) @ in_bf16_terms(b, terms)
    ah, bh = a.bfloat16().float(), b.bfloat16().float()
    al, bl = (a - ah).bfloat16().float(), (b - bh).bfloat16().float()
    return ah @ bh + ah @ bl + al @ bh


def chunked_in_bf16_terms(x, dt, A, Bm, Cm, terms, T=tssd.CHUNK):
    """The bfloat16 passes of csrc/ssd.cu in float32 with their operand
    rounding: chunks of T rows in parallel, C.B^T and (exp(cum_i) C).h_in as
    products of ``terms`` bf16 terms each, the decayed scores M and B w as
    ``terms`` terms against the bf16 x, the states passed across chunks in
    float32."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    pad = (-S) % T

    def chunks(t):
        pads = t.new_zeros(Bsz, pad, *t.shape[2:])
        t = torch.cat([t.float(), pads.float()], 1)
        return t.reshape(Bsz, -1, T, *t.shape[2:])

    xs, ds, Bs, Cs = (chunks(t) for t in (x, dt, Bm, Cm))
    nc = xs.shape[1]
    cum = torch.cumsum(A * ds, dim=2)                             # (B,nc,T,H)
    cb = product_in_bf16_terms(Cs, Bs.transpose(-1, -2), terms)   # (B,nc,T,T)
    live = torch.ones(T, T, dtype=torch.bool).tril()[None, None, :, :, None]
    gap = torch.where(live, cum[:, :, :, None] - cum[:, :, None], 0.0)
    M = torch.where(live, cb[..., None] * torch.exp(gap) * ds[:, :, None], 0.0)
    intra = torch.einsum("bcijh,bcjhp->bcihp", in_bf16_terms(M, terms), xs)
    last = cum[:, :, -1]                                          # (B,nc,H)
    w = torch.exp(last[:, :, None] - cum) * ds
    Bw = Bs[:, :, :, None, :] * w[..., None]                # (B,nc,T,H,N)
    states = torch.einsum("bcjhn,bcjhp->bchnp", in_bf16_terms(Bw, terms), xs)
    h = torch.zeros(Bsz, H, N, P)
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = torch.exp(last[:, c])[..., None, None] * h + states[:, c]
    # exp(cum_i) C_i in bf16 terms against h_in's terms
    eC = torch.exp(cum).permute(0, 1, 3, 2)[..., None] * Cs[:, :, None]
    inter = product_in_bf16_terms(eC, torch.stack(h_in, 1), terms)
    y = inter.permute(0, 1, 3, 2, 4) + intra
    return y.reshape(Bsz, nc * T, H, P)[:, :S].to(x.dtype)


@functools.cache
def serve_shape_scan():
    """SSD inputs drawn as chip_smoke.py's model-made ones (numpy seed 41)
    at mamba2-1.3b's widths and the serving prompt, one batch row, and the
    plain scan of them."""
    rng = np.random.default_rng(41)
    B, S, H, P, N = 1, 1000, 64, 64, 128
    x = torch.from_numpy(rng.standard_normal((B, S, H, P)).astype(np.float32))
    dt = torch.nn.functional.softplus(torch.from_numpy(
        (-2.0 + 0.5 * rng.standard_normal((B, S, H))).astype(np.float32)))
    A = -torch.linspace(1.0, 16.0, H)
    Bm, Cm = (torch.from_numpy(rng.standard_normal((B, S, N))
                               .astype(np.float32)) for _ in range(2))
    args = (x.bfloat16(), dt, A, Bm, Cm)
    return args, ref.ssd(*args).float()


@pytest.mark.parametrize("terms", [0, 2, 1])
def test_ssd_operands_in_two_bf16_terms_meet_the_allowance(terms):
    # chip_smoke.py's bf16 check, |out - plain| <= 1e-2 + 2**-7 |plain|, is
    # about one bf16 step of each output: the chunked form in exact float32
    # (terms 0) and with every float32 operand as two bf16 terms, as the
    # tensor-core passes multiply them (terms 2), stay inside it; one bf16
    # term per operand (terms 1) lands several times outside
    args, plain = serve_shape_scan()
    out = chunked_in_bf16_terms(*args, terms).float()
    allowance = 1e-2 + 2.0 ** -7 * plain.abs()
    used = ((out - plain).abs() / allowance).max().item()
    assert (used > 1.0) if terms == 1 else (used <= 0.95), used


@pytest.mark.parametrize("S", [1, 255, 256, 257, 1000])
def test_ssd_pass_grids_cover_every_chunk(S):
    # (B, H, N, P) of mamba2-1.3b's serve prefill; S ragged or whole chunks
    B, H, N, P = 4, 64, 128, 64
    grids = tssd._grids(B, S, H, N, P)
    nc = tssd._chunks(S)
    assert (nc - 1) * tssd.CHUNK < S <= nc * tssd.CHUNK
    blocks = tssd.CHUNK // tssd.ROWS
    # C.B^T: every lower 64 x 64 tile of every (batch row, chunk)
    (tiles, bcs, _), _ = grids["cb"]
    assert tiles == sum(range(1, blocks + 1)) and bcs == B * nc
    # states: one CTA per (head, chunk, batch row), a warpgroup per 64 rows
    (gh, gc, gb), threads = grids["state"]
    assert (gh, gc, gb) == (H, nc, B) and threads == 128 * -(-N // 64)
    # the pass: every run of 8 (P, N) entries of every (head, batch row)
    (ge, gh, gb), threads = grids["pass"]
    assert ge * threads * 8 >= N * P > (ge - 1) * threads * 8
    assert (gh, gb) == (H, B)
    # the scan: every 128-row block of every chunk, the ragged one
    # included, every head in groups of SCAN_HEADS, 64 rows a warpgroup
    (gblk, ghg, gbc), threads = grids["scan"]
    assert gbc == B * nc and gblk * tssd.SCAN_ROWS == tssd.CHUNK
    assert gbc // B * gblk * tssd.SCAN_ROWS >= S
    assert threads == 128 * tssd.SCAN_ROWS // tssd.ROWS
    assert ghg * tssd.SCAN_HEADS >= H > (ghg - 1) * tssd.SCAN_HEADS


def test_ssd_workspace_at_the_serving_shape():
    # mamba2-1.3b's prefill (B=4, S=1000: four chunks of 256): C.B^T 4 MB,
    # the chunk states 33.5 MB, cum and dt 2 MB, the decays 4 KB
    B, S, H, N, P = 4, 1000, 64, 128, 64
    floats = tssd._workspace_floats(B, S, H, N, P)
    assert floats == 16 * 256 * 256 + 16 * H * N * P + 16 * H * 512 + 16 * H
    assert 16 * H * N * P * 4 == 33_554_432
    assert floats * 4 == 39_849_984
    assert tssd._workspace_floats(1, 77, 3, 16, 32) == (
        256 * 256 + 3 * 16 * 32 + 3 * 512 + 3)


@pytest.mark.parametrize("N", tssd.STATE_DIMS)
@pytest.mark.parametrize("P", tssd.HEAD_DIMS)
def test_ssd_pass_shared_memory_fits(N, P):
    # every pass within the 227 KB a block may have; the scan holds its
    # block's C.B^T (128 rows of a whole chunk, float32), x of a whole
    # chunk and h_in as two bf16 terms
    smem = tssd._smem_bytes(N)
    assert all(0 <= b <= 232_448 for b in smem.values()), smem
    assert smem["scan"] >= (tssd.SCAN_ROWS * tssd.CHUNK * 4
                            + tssd.CHUNK * 64 * 2 + 2 * N * 64 * 2)
    assert P in tssd.HEAD_DIMS


def test_ssd_tensor_core_flops_at_the_serving_shape():
    # the passes' own products, padding and split terms included (at most:
    # the scan skips tiles whose decays all underflow): 29.5 GFLOP, 30 us
    # at the bf16 tensor-core peak, against the algorithm's 11.8 GFLOP at
    # 32-row tiles; four CUDA launches a call
    flops = tssd._mma_flops(4, 1000, 64, 128, 64)
    assert flops == 29_494_345_728
    assert tssd.LAUNCHES_PER_CALL[torch.bfloat16] == len(tssd._grids(
        4, 1000, 64, 128, 64))
