"""The port's kernels on the CPU: their plain PyTorch versions against the
JAX package's oracles and its Pallas kernel bodies (``interpret=True``),
and the device dispatch in ``repro_torch.kernels.ops``.

The CUDA kernels themselves run only on the card (``chip_smoke.py``
holds each against the plain version there); here the plain versions
carry their arithmetic. Selections and counters must match exactly:
the maintenance quantile ``q``, the round step's choices, error
counters, ring pointers, pool bits and queue. Other floats match to
``rtol=1e-5``: XLA sums a row in its own order (the plain round step
adds the M columns left to right, as the CUDA kernel does) and
contracts ``a * b + c`` into FMAs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import kde as jkde_kernel
from repro.kernels import ref as jref
from repro.kernels import round_fused as jround
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import kde as tkde_kernel
from repro_torch.kernels import round_fused as tround

EXACT = ("err", "in_pool", "ptr", "rptr", "q", "arrivals", "choices")
RTOL, ATOL = 1e-5, 1e-7


def T(x) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(x), copy=True))


def maint_inputs(rows: int, R: int, seed: int):
    rng = np.random.default_rng(seed)
    lat = rng.uniform(0.005, 0.15, (rows, R)).astype(np.float32)
    lat[rng.uniform(size=(rows, R)) < 0.3] = np.float32(0.05)      # ties
    mask = rng.uniform(size=(rows, R)) < rng.uniform(size=(rows, 1))
    mask[0::5], mask[1::5] = False, True                          # empty, full
    rtt = rng.uniform(0.002, 0.04, rows).astype(np.float32)
    rtt[2::5] = np.float32(0.06)                                  # proc ties at 0
    return lat, mask, rtt


def round_inputs(K=70, M=10, C=8, R=16, Rq=32, seed=0):
    """A mid-run state: arms cooling down, an inactive instance, error
    counters near the threshold, rows that issue nothing, queues deep
    enough that latencies straddle tau."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    active = np.arange(M) != 3
    cooling = rng.uniform(size=(K, M)) < 0.1
    pool = (rng.uniform(size=(K, M)) < 0.8) & ~cooling & active
    w = rng.uniform(size=(K, M)).astype(f32) * pool
    w[::11] = 0.0                                        # fallback rows
    w = (w / np.maximum(w.sum(-1, keepdims=True), f32(1e-30))).astype(f32)
    nc = rng.integers(0, C + 1, K).astype(np.int32)
    nc[:2] = 0
    return dict(
        weights=w, cw=rng.uniform(-0.5, 0.5, (K, M)).astype(f32),
        err=rng.integers(0, 3, (K, M)).astype(np.int32),
        cooldown_until=np.where(cooling, f32(12.0), f32(-1e30)).astype(f32),
        in_pool=pool, active=active,
        lat_buf=rng.uniform(0.005, 0.15, (K, M, R)).astype(f32),
        ts_buf=rng.uniform(0.0, 9.9, (K, M, R)).astype(f32),
        ptr=rng.integers(0, R, (K, M)).astype(np.int32),
        r_buf=(rng.uniform(size=(K, Rq)) < 0.9).astype(f32),
        rts_buf=rng.uniform(0.0, 9.9, (K, Rq)).astype(f32),
        rptr=rng.integers(0, Rq, K).astype(np.int32),
        q=rng.uniform(0.0, 12.0, M).astype(f32), nc=nc,
        z=np.exp(0.25 * rng.standard_normal((C, K))).astype(f32),
        rtt_t=rng.uniform(0.002, 0.045, (K, M)).astype(f32),
        s_m=np.full(M, 0.0055, f32),
        served_per_round=(f32(0.1) / (f32(C) * np.full(M, 0.0055, f32))),
        t=np.float32(10.0))


STATICS = dict(tau=0.08, err_thresh=3, cooldown=2.0)


def assert_round_out(want, got):
    for name in ref.RoundStepOut._fields:
        a, b = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert a.shape == b.shape, name
        if name in EXACT or a.dtype.kind in "biu":
            np.testing.assert_array_equal(b.astype(a.dtype), a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL, err_msg=name)


# ---------------------------------------------------------------------------
# Maintenance statistics.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,R", [(37, 16), (20, 64)])
def test_maintenance_plain_vs_reference_oracle(rows, R):
    lat, mask, rtt = maint_inputs(rows, R, rows)
    mu, q = jax.jit(lambda a, b, c: jref.bandit_maintenance_stats(
        a, b, c, 0.08, 0.9))(lat, mask, rtt)
    tmu, tq = ref.bandit_maintenance_stats(T(lat), T(mask), T(rtt), 0.08, 0.9)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
    np.testing.assert_allclose(tmu.numpy(), np.asarray(mu), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("rows,R", [(37, 16), (20, 64)])
def test_maintenance_plain_vs_pallas_body(rows, R):
    lat, mask, rtt = maint_inputs(rows, R, rows + 1)
    mu, q = jkde_kernel.fused_maintenance(
        jnp.asarray(lat), jnp.asarray(mask), jnp.asarray(rtt), 0.08, 0.9,
        interpret=True)
    tmu, tq = ops.bandit_maintenance_stats(T(lat), T(mask), T(rtt), 0.08, 0.9)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
    np.testing.assert_allclose(tmu.numpy(), np.asarray(mu), rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# KDE success probability (the maintenance's middle stage, bandwidths given).
# tests/test_kernels.py's sweep and tolerance.
# ---------------------------------------------------------------------------

def kde_inputs(rows: int, R: int, seed: int):
    rng = np.random.default_rng(seed)
    lat = rng.exponential(0.03, (rows, R)).astype(np.float32)
    mask = rng.random((rows, R)) < 0.7
    mask[0] = False                                               # empty row
    bw = rng.uniform(1e-3, 1e-2, rows).astype(np.float32)
    return lat, mask, bw


@pytest.mark.parametrize("oracle", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("rows,R", [(8, 16), (300, 64), (1024, 128)])
def test_kde_success_prob_plain_vs_reference(rows, R, oracle):
    lat, mask, bw = kde_inputs(rows, R, rows + R)
    if oracle == "ref":
        want = jax.jit(lambda a, b, c: jref.kde_success_prob(a, b, 0.08, c))(
            lat, mask, bw)
    else:
        want = jkde_kernel.kde_success_prob(
            jnp.asarray(lat), jnp.asarray(mask), 0.08, jnp.asarray(bw),
            interpret=True)
    got = ops.kde_success_prob(T(lat), T(mask), 0.08, T(bw))
    assert got.shape == (rows,) and got[0].item() == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-6)


def test_kde_dispatch_raises_without_a_kernel_library(monkeypatch, tmp_path):
    _no_nvcc(monkeypatch, tmp_path)
    tkde_kernel._kde_launcher.cache_clear()
    monkeypatch.setattr(ops, "_on_host", lambda x: False)
    lat, mask, bw = kde_inputs(10, 16, 0)
    with pytest.raises(RuntimeError, match="nvcc"):
        ops.kde_success_prob(T(lat), T(mask), 0.08, T(bw))
    assert tkde_kernel.kde_success_prob.launches == 0


def test_kde_wrapper_refuses_host_tensors(monkeypatch):
    monkeypatch.setattr(tkde_kernel, "_kde_launcher", lambda: None)
    lat, mask, bw = kde_inputs(10, 16, 0)
    with pytest.raises(ValueError, match="CUDA"):
        tkde_kernel.kde_success_prob(T(lat), T(mask), 0.08, T(bw))


# ---------------------------------------------------------------------------
# Round step.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def round_case():
    args = round_inputs()
    got = ops.round_step(*(T(v) for v in args.values()), **STATICS)
    return args, got


def test_round_step_plain_vs_reference_oracle(round_case):
    args, got = round_case
    want = jax.jit(lambda a: jref.round_step_swrr(**a, **STATICS))(args)
    assert_round_out(want, got)
    # the state really moved: trips, ring writes, queue arrivals
    assert (got.cooldown_until.numpy() != args["cooldown_until"]).any()
    assert (got.ptr.numpy() != args["ptr"]).any()
    assert got.arrivals.sum().item() == args["nc"].sum()


def test_round_step_plain_vs_pallas_body(round_case):
    # K = 70 is not a multiple of the Pallas kernel's 64-player block
    args, got = round_case
    want = jround.round_step_swrr(
        **{k: jnp.asarray(v) for k, v in args.items()}, **STATICS,
        interpret=True)
    assert_round_out(want, got)


def test_round_step_leaves_inputs_untouched(round_case):
    args, _ = round_case
    ins = {k: T(v) for k, v in args.items()}
    before = {k: v.clone() for k, v in ins.items()}
    ops.round_step(*ins.values(), **STATICS)
    for k in ins:
        assert torch.equal(ins[k], before[k]), k


def test_round_step_idle_rows_issue_nothing():
    args = round_inputs(K=9, seed=3)
    args["nc"][:] = 0
    out = ops.round_step(*(T(v) for v in args.values()), **STATICS)
    assert out.arrivals.sum().item() == 0.0
    for name in ("lat_buf", "ts_buf", "ptr", "r_buf", "rts_buf", "rptr",
                 "err", "cooldown_until", "in_pool"):
        np.testing.assert_array_equal(getattr(out, name).numpy(), args[name],
                                      err_msg=name)


# ---------------------------------------------------------------------------
# Dispatch: a tensor off the CPU goes to the kernel or raises.
# ---------------------------------------------------------------------------

def test_build_flags_target_hopper_and_forbid_fma():
    assert "arch=compute_90a,code=sm_90a" in _build.COMPILE_FLAGS
    assert "--fmad=false" in _build.COMPILE_FLAGS
    assert [s.name for s in _build.sources()] == [
        "decode_attention.cu", "flash_attention.cu", "maintenance.cu",
        "round_fused.cu", "ssd.cu"]


def _no_nvcc(monkeypatch, tmp_path):
    def missing():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(_build, "nvcc", missing)
    monkeypatch.setattr(_build, "LIBRARY", tmp_path / "libreprotorch.so")
    monkeypatch.setattr(_build, "_lib", None)
    tkde_kernel._launcher.cache_clear()
    tround._launcher.cache_clear()


def test_dispatch_raises_without_a_kernel_library(monkeypatch, tmp_path):
    # a tensor the dispatch takes for a card's: the call must try the
    # kernel and raise, never fall back to the plain version
    _no_nvcc(monkeypatch, tmp_path)
    monkeypatch.setattr(ops, "_on_host", lambda x: False)
    lat, mask, rtt = maint_inputs(10, 16, 0)
    with pytest.raises(RuntimeError, match="nvcc"):
        ops.bandit_maintenance_stats(T(lat), T(mask), T(rtt), 0.08, 0.9)
    args = round_inputs(K=5)
    with pytest.raises(RuntimeError, match="nvcc"):
        ops.round_step(*(T(v) for v in args.values()), **STATICS)
    assert tkde_kernel.fused_maintenance.launches == 0


def test_kernel_wrappers_refuse_host_tensors(monkeypatch, tmp_path):
    # with a library present the wrappers still check the device first
    monkeypatch.setattr(tkde_kernel, "_launcher", lambda: None)
    monkeypatch.setattr(tround, "_launcher", lambda: None)
    lat, mask, rtt = maint_inputs(10, 16, 0)
    with pytest.raises(ValueError, match="CUDA"):
        tkde_kernel.fused_maintenance(T(lat), T(mask), T(rtt), 0.08, 0.9)
    args = round_inputs(K=5)
    with pytest.raises(ValueError, match="CUDA"):
        tround.round_step_swrr(*(T(v) for v in args.values()), **STATICS)
