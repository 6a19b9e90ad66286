"""The SSD backward on the CPU: ``ref.ssd_grads`` (the plain version of
``ssd_bwd``, the kernel of ``csrc/ssd_bwd.cu``) against ``jax.grad``
through the JAX package's ``ref.ssd``; a model of the kernel's schedule
in torch (32-row tiles, the states entering them and the adjoints
leaving them, the decayed products inside a tile, r's reverse sum in
32-row blocks with a carry, the heads' partials summed in order, rows
past S inert) against ``ref.ssd_grads``; ``ops.SSDScan``'s wiring with
the two CUDA wrappers swapped for their plain versions; the workspace
size the wrapper mirrors.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them
against ``ref.ssd_grads`` there, within ``SSD_BWD_TOL``).

Tolerances:
- ``ref.ssd_grads`` against ``jax.grad``, float32: each gradient within
  ``2e-5`` of its largest magnitude (plus ``1e-4`` of each element's
  own): the same recurrence differentiated by two frameworks, whose
  einsums and reverse sums round in other orders (measured: ~3e-7 of
  the scale).
- The schedule's model against ``ref.ssd_grads`` in float64: ``1e-10``
  of each gradient's scale (the algebra is exact; measured ~1e-15).
- The model in float32 against ``ref.ssd_grads`` in float32 is the
  kernel's rounding against the plain version's: within half of
  ``chip_smoke.SSD_BWD_TOL``'s float32 allowance, which this test
  states again (``KERNEL_F32``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ref as jref
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd as tssd

JAX_TOL = dict(scale=2e-5, rtol=1e-4)
MODEL_F64 = 1e-10
# chip_smoke.SSD_BWD_TOL["float32"]: |got - plain| <= scale * max|plain| +
# rtol |plain|; dA, a sum over B S terms dt_i ddA_i whose ddA_i are
# themselves reverse sums, within ``terms`` of the sum of the terms'
# magnitudes (measured: the other gradients <= 2.1e-6 of their scale, dA <=
# 5.0e-5 of its terms at mamba2-1.3b's heads, S 256)
KERNEL_F32 = dict(scale=2e-5, rtol=1e-4, terms=1e-3)

# (B, S, H, P, N): the reduced mamba2 / hymba widths (they coincide) with S
# past two tiles and no multiple of a tile or of their 16-row chunk; the
# published heads (mamba2: 64 of 64, N 128; hymba: 25 of 64, N 16) at a
# short S
SHAPES = {"reduced": (2, 70, 4, 16, 8), "mamba2_heads": (1, 40, 64, 64, 128),
          "hymba_heads": (2, 45, 25, 64, 16)}


def inputs(B, S, H, P, N, seed=0, dtype=np.float32):
    """x, dt, A, Bm, Cm as the model makes them (dt softplus'd around -2,
    A = -linspace(1, 16)), and dy; numpy from a seed."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P))
    dt = np.log1p(np.exp(-2.0 + 0.5 * rng.standard_normal((B, S, H))))
    A = -np.linspace(1.0, 16.0, H)
    Bm, Cm = (rng.standard_normal((B, S, N)) for _ in range(2))
    dy = rng.standard_normal((B, S, H, P))
    return tuple(a.astype(dtype) for a in (x, dt, A, Bm, Cm, dy))


def T(a):
    return torch.from_numpy(np.array(a))


def scaled_err(got, want, scale, rtol):
    """The worst element's share of ``scale * max|want| + rtol |want|``."""
    want = want.double()
    allow = scale * want.abs().max() + rtol * want.abs()
    return ((got.double() - want).abs() / allow).max().item()


def da_terms(x, dt, A, dx, ddt):
    """sum over (b, i) of |dt_i ddA_i| per head, from the gradients alone:
    dt_i ddA_i = (dt_i ddt_i - x_i . dx_i) / A (ddt_i = B_i . (g_i x_i) +
    A ddA_i and x_i . dx_i = dt_i B_i . (g_i x_i))."""
    terms = (dt.double() * ddt.double()
             - (x.double() * dx.double()).sum(-1)) / A.double()
    return terms.abs().sum((0, 1))


def chunked_grads(x, dt, A, Bm, Cm, dy, tile=tssd.BWD_TILE):
    """``ssd_bwd``'s schedule in torch, in the inputs' dtype: returns the
    five gradients and the workspace's arrays (states, adjoints, the
    heads' partials of dB and dC, r, x . v, dA's partials)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    nt = -(-S // tile)
    pad = nt * tile - S
    # rows past S: zeros with dt = 0 (inert: decay 1, no contribution)
    xt, dyt = (F.pad(t, (0, 0, 0, 0, 0, pad)).reshape(Bsz, nt, tile, H, P)
               for t in (x, dy))
    Bt, Ct = (F.pad(t, (0, 0, 0, pad)).reshape(Bsz, nt, tile, N)
              for t in (Bm, Cm))
    dtt = F.pad(dt, (0, 0, 0, pad)).reshape(Bsz, nt, tile, H)
    cum = torch.cumsum(A * dtt, 2)                       # in-tile sums
    ecum = torch.exp(cum)
    elast = torch.exp(cum[:, :, -1:] - cum)
    last = ecum[:, :, -1]                                # (B, nt, H)
    # 1. the state entering each tile, the adjoint leaving it
    hs = torch.zeros(Bsz, nt, H, N, P, dtype=x.dtype)
    gs = torch.zeros_like(hs)
    h = torch.zeros(Bsz, H, N, P, dtype=x.dtype)
    for t in range(nt):
        hs[:, t] = h
        h = last[:, t, :, None, None] * h + torch.einsum(
            "bjn,bjh,bjhp->bhnp", Bt[:, t], elast[:, t] * dtt[:, t], xt[:, t])
    g = torch.zeros_like(h)
    for t in reversed(range(nt)):
        gs[:, t] = g
        g = last[:, t, :, None, None] * g + torch.einsum(
            "bkn,bkh,bkhp->bhnp", Ct[:, t], ecum[:, t], dyt[:, t])
    # 2. inside each tile: Z, W, dx, the heads' partials, r
    i = torch.arange(tile)
    upper = (i[None, :] >= i[:, None]).to(x.dtype)       # [i][k]: k >= i
    dec = torch.exp(cum[:, :, None, :, :] - cum[:, :, :, None, :]) \
        * upper[None, None, :, :, None]                  # (B, nt, i, k, H)
    Z = dec * torch.einsum("btkn,btin->btik", Ct, Bt)[..., None]
    W = dec * torch.einsum("btihp,btkhp->btikh", xt, dyt)
    v = torch.einsum("btikh,btkhp->btihp", Z, dyt) + elast[..., None] \
        * torch.einsum("bthnp,btin->btihp", gs, Bt)
    dxt = dtt[..., None] * v
    q = (xt * v).sum(-1)                                 # (B, nt, T, H)
    dBh = dtt[..., None] * (torch.einsum("btikh,btkn->btihn", W, Ct)
                            + elast[..., None]
                            * torch.einsum("bthnp,btihp->btihn", gs, xt))
    dCh = torch.einsum("btih,btikh,btin->btkhn", dtt, W, Bt) \
        + ecum[..., None] * torch.einsum("bthnp,btkhp->btkhn", hs, dyt)
    r = (Ct[:, :, :, None, :] * dCh).sum(-1) - dtt * q
    rows = lambda a: a.reshape(Bsz, nt * tile, *a.shape[3:])[:, :S]  # noqa: E731
    r, q, dtr = rows(r), rows(q), rows(dtt)
    # 3. ddA: r summed from the end in 32-row blocks, a carry between them
    ddA = torch.zeros_like(r)
    carry = torch.zeros(Bsz, H, dtype=x.dtype)
    for s0 in reversed(range(0, S, 32)):
        blk = r[:, s0:s0 + 32].flip(1).cumsum(1).flip(1)
        ddA[:, s0:s0 + 32] = blk + carry[:, None]
        carry = carry + blk[:, 0]
    ddt = q + A * ddA
    pdA = (dtr * ddA).sum(1)                             # (B, H)
    # 4. the heads' partials summed in order, dA over the batch rows
    dBh, dCh = rows(dBh), rows(dCh)                      # (B, S, H, N)
    grads = (rows(dxt), ddt, pdA.sum(0), dBh.sum(2), dCh.sum(2))
    work = (hs, gs, dBh, dCh, r, q, pdA)
    return grads, work


@pytest.mark.parametrize("shape", SHAPES, ids=list(SHAPES))
def test_ssd_grads_match_jax_grad(shape):
    B, S, H, P, N = SHAPES[shape]
    x, dt, A, Bm, Cm, dy = inputs(B, S, H, P, N, seed=3)

    def loss(x, dt, A, Bm, Cm):
        return jnp.vdot(jref.ssd(x, dt, A, Bm, Cm), dy)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(x, dt, A, Bm, Cm)
    got = ref.ssd_grads(*(T(a) for a in (x, dt, A, Bm, Cm, dy)))
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        used = scaled_err(g, T(np.asarray(w)), **JAX_TOL)
        assert used <= 1.0, (name, used)


def f64(shape, seed):
    return tuple(T(a) for a in inputs(*shape, seed=seed, dtype=np.float64))


@pytest.mark.parametrize("shape", [(2, 70, 4, 16, 8), (1, 32, 3, 32, 16),
                                   (2, 65, 2, 64, 128), (1, 5, 2, 16, 8)],
                         ids=["ragged", "one_tile", "mamba2_widths",
                              "short"])
def test_chunked_schedule_is_the_gradient_in_float64(shape):
    x, dt, A, Bm, Cm, dy = f64(shape, seed=5)
    want = ref.ssd_grads(x, dt, A, Bm, Cm, dy)
    got, _ = chunked_grads(x, dt, A, Bm, Cm, dy)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        assert g.dtype == torch.float64 and g.shape == w.shape, name
        err = (g - w).abs().max().item() / w.abs().max().item()
        assert err <= MODEL_F64, (name, err)


def test_decays_need_no_state_products():
    # the decay's gradient through r (y . dy from the dC partials, x . dx)
    # equals autograd's with respect to A dt itself, row by row
    x, dt, A, Bm, Cm, dy = f64((1, 40, 2, 16, 8), seed=6)
    u = (A * dt).requires_grad_()
    h = torch.zeros(1, 2, 8, 16, dtype=torch.float64)
    ys = []
    for t in range(40):
        h = h * torch.exp(u[:, t])[..., None, None] + dt[:, t, :, None, None] \
            * Bm[:, t, None, :, None] * x[:, t, :, None, :]
        ys.append(torch.einsum("bn,bhnp->bhp", Cm[:, t], h))
    want, = torch.autograd.grad(torch.stack(ys, 1), u, dy)
    (dx, ddt, _, _, _), (_, _, _, _, r, q, _) = chunked_grads(
        x, dt, A, Bm, Cm, dy)
    ddA = (ddt - q) / A
    torch.testing.assert_close(ddA, want, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(ddA, r.flip(1).cumsum(1).flip(1),
                               rtol=1e-10, atol=1e-10)


def test_rows_past_s_are_inert():
    # S = 50 ends in a tile's middle: its 14 rows past S are padded inert
    # (dt = 0, zeros) and change nothing; the workspace holds two tiles of
    # states but only S rows of partials, r and x . v
    x, dt, A, Bm, Cm, dy = f64((1, 50, 2, 16, 8), seed=7)
    got, (hs, _, dBh, _, r, _, _) = chunked_grads(x, dt, A, Bm, Cm, dy)
    assert hs.shape[1] == 2 and dBh.shape[1] == 50 and r.shape[1] == 50
    want = ref.ssd_grads(x, dt, A, Bm, Cm, dy)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("shape", ["reduced", "mamba2_heads", "hymba_heads"])
def test_kernel_rounding_meets_the_card_allowance(shape):
    # the schedule in float32 against the plain version in float32: the
    # kernel's reassociation, scored as chip_smoke.py scores the kernel
    B, S, H, P, N = SHAPES[shape]
    args = tuple(T(a) for a in inputs(B, S, H, P, N, seed=8))
    want = ref.ssd_grads(*args)
    got, _ = chunked_grads(*args)
    x, dt, A = args[:3]
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        if name == "dA":
            allow = KERNEL_F32["terms"] * da_terms(x, dt, A, want[0], want[1])
            used = ((g.double() - w.double()).abs() / allow).max().item()
        else:
            used = scaled_err(g, w, KERNEL_F32["scale"], KERNEL_F32["rtol"])
        assert used <= 0.5, (name, used)


def test_workspace_mirror_counts_the_schedules_arrays():
    for B, S, H, P, N in (*SHAPES.values(), (8, 256, 64, 64, 128),
                          (8, 300, 25, 64, 16)):
        if B * S * H * P * N > 5e6:           # the training shapes: by count
            nt = -(-S // tssd.BWD_TILE)
            sizes = (B * H * nt * N * P,) * 2 + (B * S * H * N,) * 2 \
                + (B * S * H,) * 2 + (B * H,)
        else:
            args = tuple(T(a) for a in inputs(B, S, H, P, N))
            sizes = tuple(a.numel() for a in chunked_grads(*args)[1])
        assert tssd._bwd_workspace_floats(B, S, H, N, P) == sum(sizes)
    # 404 MB at mamba2-1.3b's training shape, as the wrapper says
    assert tssd._bwd_workspace_floats(8, 256, 64, 128, 64) * 4 \
        == 403_703_808


def test_ssd_scan_wiring(monkeypatch):
    # on the card ops.ssd is SSDScan: the forward kernel, then ssd_bwd
    # with the saved inputs, its five gradients in the inputs' order; here
    # the two wrappers are swapped for their plain versions on CPU tensors
    calls = []
    monkeypatch.setattr(ops, "_on_host", lambda x: False)
    monkeypatch.setattr(tssd, "ssd", lambda *a, chunk: calls.append(
        ("ssd", chunk)) or ref.ssd(*a))
    monkeypatch.setattr(tssd, "ssd_bwd", lambda *a: calls.append(
        ("ssd_bwd", len(a))) or ref.ssd_grads(*a))
    x, dt, A, Bm, Cm, dy = (T(a) for a in inputs(2, 40, 3, 16, 8, seed=9))
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    y = ops.ssd(*leaves, chunk=16)
    assert y.grad_fn is not None and calls == [("ssd", 16)]
    got = torch.autograd.grad(y, leaves, dy)
    assert calls == [("ssd", 16), ("ssd_bwd", 6)]
    want = ref.ssd_grads(x, dt, A, Bm, Cm, dy)
    for g, w, leaf in zip(got, want, leaves):
        assert g.shape == leaf.shape and g.dtype == leaf.dtype
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    # under no_grad, or with no input that requires grad: nothing recorded
    with torch.no_grad():
        out = ops.ssd(*leaves, chunk=16)
    assert out.grad_fn is None and not out.requires_grad
    assert ops.ssd(x, dt, A, Bm, Cm, chunk=16).grad_fn is None
    assert [c[0] for c in calls].count("ssd_bwd") == 1


def test_ssd_bwd_wrapper_refuses_host_tensors(monkeypatch):
    monkeypatch.setattr(tssd, "_bwd_launcher", lambda: None)
    args = tuple(T(a) for a in inputs(1, 20, 2, 16, 8))
    with pytest.raises(ValueError, match="CUDA"):
        tssd.ssd_bwd(*args)
    assert tssd.ssd_bwd.launches == 0


def test_ssd_bwd_is_built_for_the_ssm_configs():
    # every (state, head) width of the SSM and hybrid configs, full and
    # reduced, is a template instance of csrc/ssd_bwd.cu (BWD_WIDTHS), and
    # ops counts it
    for arch in ("mamba2-1.3b", "hymba-1.5b"):
        for reduced in (False, True):
            cfg = get_config(arch, reduced=reduced)
            assert (cfg.ssm_state, cfg.ssm_head_dim) in tssd.BWD_WIDTHS
    assert tssd.ssd_bwd in ops.WRAPPERS
    assert tssd.BWD_LAUNCHES_PER_CALL == 4
