"""The port's SSM serving slice on the CPU against the JAX package: the
plain SSD scan and single-token update (``repro_torch.kernels.ref``,
what ``kernels.ops`` runs for a CPU tensor) against the JAX oracles and
the Pallas SSD body in interpret mode; the Mamba-2 block; the reduced
mamba2 model with the JAX package's weights carried across by
``repro_torch.convert.model_params_to_torch``; the serving launcher; and
the device dispatch of the SSD kernel.

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it
against its plain version there).

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
