"""The port's attention kernels on the CPU: their plain PyTorch versions
(``repro_torch.kernels.ref.attention`` / ``decode_attention``, what
``kernels.ops`` runs for a CPU tensor) against the JAX package's oracles
(``repro.kernels.ref``) and its Pallas kernel bodies in interpret mode,
and the device dispatch.

The CUDA kernels themselves run only on the card (``chip_smoke.py``
holds each against its plain version there). The Pallas bodies run with
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
    # qwen3-4b: G = 32 / 8 query heads of 128 per kv head
    assert tdec._smem_bytes(4, 128) <= tdec._SMEM_LIMIT
    assert tdec._smem_bytes(64, 256) > tdec._SMEM_LIMIT
