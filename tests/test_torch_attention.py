"""The port's attention kernels on the CPU: their plain PyTorch versions
(``repro_torch.kernels.ref.attention`` / ``decode_attention``, what
``kernels.ops`` runs for a CPU tensor) against the JAX package's oracles
(``repro.kernels.ref``) and its Pallas kernel bodies in interpret mode,
and the device dispatch.

The CUDA kernels themselves run only on the card (``chip_smoke.py``
holds each against its plain version there); here the Python mirrors of
their launch geometry are checked (shared memory, the decode kernel's
split plan and workspace), and the decode kernel's split-and-combine rule,
written out in plain torch, is held against the JAX references. The
Pallas bodies run with
16-wide blocks so S = 40 leaves a partial block, the causal and window
skips fire, and ``length`` values of 1, 16 (a block edge), 17 and S
land on both sides of a block boundary.

Tolerances: float32 inputs to ``rtol=1e-5, atol=1e-6`` (sums in another
order, XLA's and PyTorch's ``exp``); bfloat16 inputs are compared in
float32 after the cast to ``atol=rtol=2e-2`` (the outputs round to
bfloat16, 2**-8 relative, at unit scale).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as jdec
from repro.kernels import flash_attention as jfa
from repro.kernels import ref as jref
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import flash_attention as tfa

TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
BLOCK = 16

# (B, Hq, Hkv, S, D, causal, window)
PREFILL = [
    (2, 2, 2, 40, 16, True, None),     # GQA group 1, partial last block
    (1, 4, 2, 40, 32, True, None),     # group 2
    (2, 4, 1, 64, 16, True, None),     # group 4, S a block multiple
    (1, 4, 2, 40, 16, True, 8),        # sliding window
    (2, 4, 2, 40, 16, False, None),    # bidirectional
    (1, 4, 1, 40, 16, False, 8),       # bidirectional with a window
]
# (B, Hq, Hkv, S, D, lengths)
DECODE = [
    (2, 4, 1, 40, 16, (1, 40)),        # group 4: one slot, all slots
    (2, 4, 2, 48, 32, (16, 17)),       # group 2: a block edge and one past
    (2, 2, 2, 40, 16, (40, 33)),       # group 1: full, mid-block
]


def arrays(shapes, dtype, seed):
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    if dtype == "bfloat16":             # values exactly representable in both
        out = [np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
               for a in out]
    return out


def to_torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def to_jax(a, dtype):
    return jnp.asarray(a, getattr(jnp, dtype))


def check(got: torch.Tensor, want, dtype):
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **TOL[dtype])


# ---------------------------------------------------------------------------
# Prefill attention.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PREFILL)
@pytest.mark.parametrize("oracle", ["ref", "pallas_interpret"])
def test_attention_plain_vs_reference(case, dtype, oracle):
    B, Hq, Hkv, S, D, causal, window = case
    q, k, v = arrays([(B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D)], dtype,
                     S + Hq)
    jq, jk, jv = (to_jax(a, dtype) for a in (q, k, v))
    if oracle == "ref":
        want = jref.attention(jq, jk, jv, causal=causal, window=window)
    else:
        want = jfa.flash_attention(jq, jk, jv, causal=causal, window=window,
                                   block_q=BLOCK, block_k=BLOCK,
                                   interpret=True)
    got = ops.attention(*(to_torch(a, dtype) for a in (q, k, v)),
                        causal=causal, window=window)
    check(got, want, dtype)


def test_attention_explicit_scale():
    q, k, v = arrays([(1, 2, 24, 16), (1, 1, 24, 16), (1, 1, 24, 16)],
                     "float32", 3)
    want = jref.attention(*(jnp.asarray(a) for a in (q, k, v)), scale=0.3)
    got = ref.attention(*(torch.from_numpy(a) for a in (q, k, v)), scale=0.3)
    check(got, want, "float32")


# ---------------------------------------------------------------------------
# Decode attention.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DECODE)
@pytest.mark.parametrize("oracle", ["ref", "pallas_interpret"])
def test_decode_attention_plain_vs_reference(case, dtype, oracle):
    B, Hq, Hkv, S, D, lengths = case
    q, k, v = arrays([(B, Hq, D), (B, Hkv, S, D), (B, Hkv, S, D)], dtype,
                     S + Hq + D)
    length = np.asarray(lengths, np.int32)
    jq, jk, jv = (to_jax(a, dtype) for a in (q, k, v))
    if oracle == "ref":
        want = jref.decode_attention(jq, jk, jv, jnp.asarray(length))
    else:
        want = jdec.decode_attention(jq, jk, jv, jnp.asarray(length),
                                     block_k=BLOCK, interpret=True)
    got = ops.decode_attention(*(to_torch(a, dtype) for a in (q, k, v)),
                               torch.from_numpy(length))
    check(got, want, dtype)


def test_decode_matches_the_last_row_of_full_attention():
    # the cache holds the prompt; the last query row of causal prefill
    # attention is one decode step at length S
    q, k, v = arrays([(2, 4, 20, 16), (2, 2, 20, 16), (2, 2, 20, 16)],
                     "float32", 5)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    full = ops.attention(tq, tk, tv)
    step = ops.decode_attention(tq[:, :, -1].contiguous(), tk, tv,
                                torch.full((2,), 20, dtype=torch.int32))
    torch.testing.assert_close(step, full[:, :, -1], rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# Dispatch: a tensor off the CPU goes to the kernel or raises.
# ---------------------------------------------------------------------------

def _decode_args():
    q, k, v = arrays([(2, 4, 16), (2, 2, 24, 16), (2, 2, 24, 16)],
                     "float32", 0)
    return (*(torch.from_numpy(a) for a in (q, k, v)),
            torch.tensor([3, 24], dtype=torch.int32))


def _prefill_args():
    q, k, v = arrays([(1, 4, 24, 16), (1, 2, 24, 16), (1, 2, 24, 16)],
                     "float32", 0)
    return tuple(torch.from_numpy(a) for a in (q, k, v))


def test_dispatch_raises_without_a_kernel_library(monkeypatch, tmp_path):
    def missing():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(_build, "nvcc", missing)
    monkeypatch.setattr(_build, "LIBRARY", tmp_path / "libreprotorch.so")
    monkeypatch.setattr(_build, "_lib", None)
    tfa._launcher.cache_clear()
    tdec._launcher.cache_clear()
    monkeypatch.setattr(ops, "_on_host", lambda x: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        ops.attention(*_prefill_args())
    with pytest.raises(RuntimeError, match="nvcc"):
        ops.decode_attention(*_decode_args())
    assert tfa.flash_attention.launches == 0
    assert tdec.decode_attention.launches == 0


def test_kernel_wrappers_refuse_host_tensors(monkeypatch):
    # with a library present the wrappers still check the device first
    monkeypatch.setattr(tfa, "_launcher", lambda: None)
    monkeypatch.setattr(tdec, "_launcher", lambda: None)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(*_prefill_args())
    with pytest.raises(ValueError, match="CUDA"):
        tdec.decode_attention(*_decode_args())


def test_decode_kernel_shared_memory_fits_the_serving_shape():
    # qwen3-4b: G = 32 / 8 query heads of 128 per kv head, in either dtype;
    # the limit bites for a group of 128 heads of 256
    assert tdec._smem_bytes(4, 128) <= tdec._SMEM_LIMIT
    assert tdec._smem_bytes(4, 128, 2) <= tdec._SMEM_LIMIT
    assert tdec._smem_bytes(128, 256) > tdec._SMEM_LIMIT


# ---------------------------------------------------------------------------
# Launch geometry of the CUDA kernels, mirrored in Python.
# ---------------------------------------------------------------------------

def pv_in_bf16_terms(q, k, v, terms):
    """Causal attention with P entering P . V as ``terms`` bf16 terms (1:
    P rounded; 2: that plus the remainder rounded), everything else in
    float32: the rounding the bf16 flash kernel adds to the plain version."""
    S, D = q.shape[-2:]
    G = q.shape[1] // k.shape[1]
    kk, vv = (t.float().repeat_interleave(G, 1) for t in (k, v))
    s = q.float() @ kk.transpose(-1, -2) * D ** -0.5
    live = torch.ones(S, S, dtype=torch.bool).tril()
    p = torch.where(live, torch.exp(s - s.masked_fill(~live, ref._NEG)
                                    .amax(-1, keepdim=True)), 0.0)
    hi = p.to(torch.bfloat16).float()
    pb = hi if terms == 1 else hi + (p - hi).to(torch.bfloat16).float()
    return ((pb @ vv) / p.sum(-1, keepdim=True)).to(torch.bfloat16)


@pytest.mark.parametrize("terms", [1, 2])
def test_probabilities_in_two_bf16_terms_meet_the_allowance(terms):
    # chip_smoke.py's bf16 check, |out - plain| <= 2e-3 + 2**-6 |plain|:
    # with P rounded once, early causal rows (few terms whose values
    # cancel) exceed it; with P in two bf16 terms, as flash_tc_kernel
    # multiplies it, every output stays well inside
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .bfloat16() for s in ((1, 8, 1000, 128), (1, 2, 1000, 128),
                                     (1, 2, 1000, 128)))
    plain = ref.attention(q, k, v).float()
    out = pv_in_bf16_terms(q, k, v, terms).float()
    used = ((out - plain).abs() / (2e-3 + 2.0 ** -6 * plain.abs())).max()
    assert (used > 1.0) if terms == 1 else (used < 0.5), used.item()

@pytest.mark.parametrize("D", tfa.HEAD_DIMS)
def test_flash_tensor_core_kernel_shared_memory_fits(D):
    # q block, two stages of K and V, alignment slack and barriers
    assert tfa._smem_bytes(D) <= tdec._SMEM_LIMIT
    rows = 64 if D == 256 else 128
    assert tfa._smem_bytes(D) >= rows * D * 2 + 4 * 64 * D * 2


@pytest.mark.parametrize("S", [0, 1, 63, 64, 65, 200, 1016])
def test_decode_split_plan_covers_the_cache(S):
    splits = tdec._splits(S)
    assert splits[0][0] == 0 and splits[-1][1] == S
    for (lo, hi), (nxt, _) in zip(splits, splits[1:]):
        assert hi == nxt                           # no gap, no overlap
    assert all(0 <= hi - lo <= tdec.CHUNK for lo, hi in splits)
    assert len(splits) == max(1, -(-S // tdec.CHUNK))


def test_decode_split_grid_fills_the_card_at_the_serving_shape():
    # qwen3-4b's decode cache (B=4, Hkv=8, S=1016): at least two CTAs per
    # SM of the H100's 132, and the float32 partials the wrapper allocates
    B, Hkv, G, S, D = 4, 8, 4, 1016, 128
    assert len(tdec._splits(S)) * Hkv * B >= 2 * 132
    floats = tdec._workspace_floats(B, Hkv, G, S, D)
    assert floats == B * Hkv * len(tdec._splits(S)) * G * (D + 2)
    assert floats * 4 == 1_064_960


def split_combine(q, k, v, length):
    """The decode kernel's two passes in plain torch, float32 inside: each
    split's (max, normaliser, unnormalised output) over its live slots,
    then M = max m_i, L = sum l_i e^(m_i - M), O = sum acc_i e^(m_i - M) /
    max(L, 1e-30)."""
    B, Hq, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Hkv, Hq // Hkv, D) * D ** -0.5
    n_live = length.long().clamp(0, S)
    ms, ls, accs = [], [], []
    for lo, hi in tdec._splits(S):
        live = (torch.arange(lo, hi)[None, :] < n_live[:, None])[:, None, None]
        s = torch.einsum("bhgd,bhkd->bhgk", qg, k[:, :, lo:hi].float())
        s = torch.where(live, s, ref._NEG)
        m = s.amax(-1, keepdim=True)
        p = torch.where(live, torch.exp(s - m), 0.0)
        ms.append(m[..., 0])
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bhgk,bhkd->bhgd", p, v[:, :, lo:hi].float()))
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    w = torch.exp(m - m.amax(0))
    out = (acc * w[..., None]).sum(0) / (l * w).sum(0).clamp_min(1e-30)[..., None]
    return out.reshape(B, Hq, D).to(q.dtype)


# (B, Hq, Hkv, S, D, lengths): one slot, a split's edge and one past it,
# the whole cache, and rows whose trailing splits are empty
SPLIT_CASES = [
    (4, 8, 2, 200, 32, (1, 64, 65, 200)),
    (2, 4, 1, 130, 16, (129, 3)),
    (1, 4, 4, 64, 16, (64,)),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SPLIT_CASES)
@pytest.mark.parametrize("oracle", ["ref", "pallas_interpret"])
def test_split_combine_rule_vs_reference(case, dtype, oracle):
    B, Hq, Hkv, S, D, lengths = case
    q, k, v = arrays([(B, Hq, D), (B, Hkv, S, D), (B, Hkv, S, D)], dtype,
                     S + Hq + D + 1)
    length = np.asarray(lengths, np.int32)
    jq, jk, jv = (to_jax(a, dtype) for a in (q, k, v))
    if oracle == "ref":
        want = jref.decode_attention(jq, jk, jv, jnp.asarray(length))
    else:
        want = jdec.decode_attention(jq, jk, jv, jnp.asarray(length),
                                     block_k=BLOCK, interpret=True)
    got = split_combine(*(to_torch(a, dtype) for a in (q, k, v)),
                        torch.from_numpy(length))
    check(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_gives_the_tpu_kernels_zeros_for_length_zero(dtype):
    # a row of length 0 beside a full one: the plain version gives the
    # TPU kernel's answer (zeros), the full row its attention
    B, Hq, Hkv, S, D = 2, 4, 2, 40, 16
    q, k, v = arrays([(B, Hq, D), (B, Hkv, S, D), (B, Hkv, S, D)], dtype, 12)
    length = np.asarray([0, S], np.int32)
    want = jdec.decode_attention(*(to_jax(a, dtype) for a in (q, k, v)),
                                 jnp.asarray(length), block_k=BLOCK,
                                 interpret=True)
    assert not np.asarray(want.astype(jnp.float32))[0].any()
    got = ref.decode_attention(*(to_torch(a, dtype) for a in (q, k, v)),
                               torch.from_numpy(length))
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    check(got, want, dtype)


def test_split_combine_rule_gives_zeros_for_length_zero():
    # every split of the row is empty: L = 0 and the output is exactly 0,
    # as the TPU kernel and the plain version give
    q, k, v = arrays([(2, 4, 16), (2, 2, 130, 16), (2, 2, 130, 16)],
                     "float32", 9)
    length = torch.tensor([0, 70], dtype=torch.int32)
    got = split_combine(*(torch.from_numpy(a) for a in (q, k, v)), length)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    want = jref.decode_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                 jnp.asarray(length.numpy()))
    check(got[1:], np.asarray(want)[1:], "float32")
