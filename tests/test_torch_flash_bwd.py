"""The flash-attention backward's design on the CPU.

The CUDA kernels of ``repro_torch/kernels/csrc/flash_attention_bwd.cu``
run only on the card (``chip_smoke.py`` holds them against
``ref.attention_grads`` within ``BWD_TOL`` and checks that a second call
gives the same bits). Here:

- the plain backward (``ref.attention_grads``) against ``jax.grad``
  through the JAX package's reference attention, float32, to 1e-5 (sums
  in another order);
- a plain-torch model of the tensor-core kernels' rounding at qwen3-4b's
  training heads, held to chip_smoke.py's bfloat16 allowance
  (``|g - plain| <= 1e-3 + 2**-7 |plain|``): P and dS entering their
  products as two bfloat16 terms stay under half of it; one term each,
  or delta taken from the bfloat16-rounded output (the usual
  FlashAttention shortcut), break it;
- the Python mirrors of the kernels' launch geometry: the route by dtype
  and head dim, shared memory, the padded lse rows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import _SMEM_LIMIT

# chip_smoke.py's BWD_TOL["bfloat16"]
ATOL, RTOL = 1e-3, 2.0 ** -7


def normal(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# (B, Hq, Hkv, S, D, causal, window)
PLAIN_CASES = [
    (1, 4, 2, 70, 64, True, None),
    (2, 4, 1, 70, 32, True, 48),
    (1, 2, 2, 40, 16, False, None),
]


@pytest.mark.parametrize("case", PLAIN_CASES)
def test_plain_backward_vs_jax_grad(case):
    B, Hq, Hkv, S, D, causal, window = case
    q, k, v, do = normal([(B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D),
                          (B, Hq, S, D)], S + Hq + D)
    got = ref.attention_grads(*map(torch.from_numpy, (q, k, v, do)),
                              causal=causal, window=window)
    @jax.jit
    def grads(a, b, c, d):
        _, vjp = jax.vjp(lambda a, b, c: jref.attention(
            a, b, c, causal=causal, window=window), a, b, c)
        return vjp(d)

    want = grads(*map(jnp.asarray, (q, k, v, do)))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def bf16(x):
    return x.to(torch.bfloat16).float()


def split_terms(x, terms):
    """x as it enters a bfloat16 product: one term (x rounded) or two
    (that plus the remainder rounded)."""
    hi = bf16(x)
    return hi if terms == 1 else hi + bf16(x - hi)


def kernel_rounding(q, k, v, do, design):
    """The tensor-core backward's rounding in plain torch, causal: every
    product in float32 on bfloat16 operands, P and dS entering theirs in
    ``design``'s terms, delta from P and dP or (``"delta_from_out"``) from
    the bfloat16-rounded output, each gradient rounded once to bfloat16."""
    S, D = q.shape[-2:]
    G = q.shape[1] // k.shape[1]
    scale = D ** -0.5
    kk, vv = (t.float().repeat_interleave(G, 1) for t in (k, v))
    qf, dof = q.float(), do.float()
    s = qf @ kk.transpose(-1, -2) * scale
    live = torch.ones(S, S, dtype=torch.bool).tril()
    s = s.masked_fill(~live, ref._NEG)
    lse = torch.logsumexp(s, -1, keepdim=True)
    p = torch.where(live, torch.exp(s - lse), 0.0)
    dp = dof @ vv.transpose(-1, -2)
    if design == "delta_from_out":
        delta = (dof * bf16(p @ vv)).sum(-1, keepdim=True)
    else:
        delta = (p * dp).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    terms = 1 if design == "one_term" else 2
    pt, dst = split_terms(p, terms), split_terms(ds, terms)
    dq = scale * dst @ kk
    B, Hq, _, _ = q.shape
    grouped = (B, Hq // G, G, S, D)
    dk = (scale * dst.transpose(-1, -2) @ qf).reshape(grouped).sum(2)
    dv = (pt.transpose(-1, -2) @ dof).reshape(grouped).sum(2)
    return tuple(bf16(g) for g in (dq, dk, dv))


@pytest.fixture(scope="module")
def training_heads():
    """qwen3-4b's training heads (B 1, 32/8 heads, S 256, D 128, causal):
    unit-scale bfloat16 q, k, v and dO from numpy seed 0, and the plain
    float32 gradients."""
    arrays = normal([(1, 32, 256, 128), (1, 8, 256, 128), (1, 8, 256, 128),
                     (1, 32, 256, 128)], 0)
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in arrays)
    return (q, k, v, do), ref.attention_grads(q, k, v, do)


@pytest.mark.parametrize("design", ["two_terms", "one_term",
                                    "delta_from_out"])
def test_two_bf16_terms_meet_the_allowance(training_heads, design):
    inputs, plain = training_heads
    used = max(((g - p).abs() / (ATOL + RTOL * p.abs())).max().item()
               for g, p in zip(kernel_rounding(*inputs, design), plain))
    assert (used < 0.5) if design == "two_terms" else (used > 1.0), used


@pytest.mark.parametrize("D", tfa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_route_by_dtype_and_head_dim(dtype, D):
    want = dtype == torch.bfloat16 and D in (64, 128)
    assert tfa.bwd_tensor_cores(dtype, D) is want


@pytest.mark.parametrize("D", tfa.BWD_TC_HEAD_DIMS)
def test_tensor_core_backward_shared_memory_fits(D):
    # dQ kernel: q and dO blocks of 128 rows and two stages of K and V;
    # dK/dV kernel: K, V and two stages of q and dO, 64 rows each
    assert tfa._bwd_smem_bytes(D) <= _SMEM_LIMIT
    assert tfa._bwd_smem_bytes(D) >= max(2 * 128 * D * 2 + 4 * 64 * D * 2,
                                         6 * 64 * D * 2 + 1024)


@pytest.mark.parametrize("S", [1, 63, 64, 65, 256, 1100])
def test_lse_rows_cover_every_q_tile(S):
    # the dK/dV kernel copies 64 lse and delta rows from each q tile start
    rows = tfa._lse_rows(S)
    assert rows % 64 == 0 and S <= rows < S + 64
    assert all(q0 + 64 <= rows for q0 in range(0, S, 64))
