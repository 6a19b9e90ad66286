"""Head dim 80 (``--train-100m``'s attention) on the CPU against the JAX
package: the plain attention and its backward (``ref.attention``,
``ref.attention_grads``, what the flash kernels are held to on the card)
against the reference's attention and ``jax.grad`` through it; the
kernels' Python mirrors at D 80 (the forward's shared memory, its
32-byte swizzle boxes, the backward's route); and ``train_100m_config``
cut to 2 layers, its loss and gradients against the JAX package's with
the weights carried across by ``convert.model_params_to_torch``.

The CUDA kernels run only on the card (``chip_smoke.py``'s
``TRAIN_100M_FLASH`` cases hold them at ``ATTN_TOL`` and ``BWD_TOL``).

Tolerances (float32, sums in another order): the attention and its
gradients to ``1e-5`` (``tests/test_torch_flash_bwd.py``'s bound); the
model's loss to ``rtol=1e-5`` and each gradient leaf to ``1e-5 x`` its
largest element (``tests/test_torch_train_step.py``'s bounds).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JShapeConfig
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.launch.train import train_100m_config as jax_100m
from repro.models import build_model as jax_build
from repro import training as JT
from repro_torch.configs import ModelConfig
from repro_torch.convert import model_params_to_torch, named_to_numpy
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import ref
from repro_torch.launch import train

ATTN = dict(rtol=1e-5, atol=1e-5)


def normal(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# (B, Hq, Hkv, S, causal, window): --train-100m's 8/4 heads, then a window
CASES = [(2, 8, 4, 64, True, None), (1, 4, 2, 70, True, 24),
         (1, 2, 1, 33, False, None)]


@pytest.mark.parametrize("case", CASES)
def test_plain_attention_and_grads_at_d80_match_jax(case):
    B, Hq, Hkv, S, causal, window = case
    q, k, v, do = normal([(B, Hq, S, 80), (B, Hkv, S, 80), (B, Hkv, S, 80),
                          (B, Hq, S, 80)], S + Hq)
    T = [torch.from_numpy(a) for a in (q, k, v, do)]
    out = ref.attention(*T[:3], causal=causal, window=window)
    want = jref.attention(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **ATTN)
    got = ref.attention_grads(*T, causal=causal, window=window)

    @jax.jit
    def grads(a, b, c, d):
        _, vjp = jax.vjp(lambda a, b, c: jref.attention(
            a, b, c, causal=causal, window=window), a, b, c)
        return vjp(d)

    for g, w in zip(got, grads(q, k, v, do)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **ATTN)


def test_kernel_mirrors_at_d80():
    # the forward takes D 80 in five 32-byte boxes (80 bf16 = 160 bytes,
    # which no 128- or 64-byte swizzle divides): its q block, two stages of
    # K and V and the barriers hold whole rows, as at every D
    assert 80 in tfa.HEAD_DIMS and 160 % 128 and 160 % 64 and not 160 % 32
    assert tfa._smem_bytes(80) == 1024 + 128 * 80 * 2 + 4 * 64 * 80 * 2 + 64
    assert tfa._smem_bytes(80) <= tdec._SMEM_LIMIT
    # the backward takes the CUDA-core kernels at D 80 in both dtypes
    assert not tfa.bwd_tensor_cores(torch.bfloat16, 80)
    assert not tfa.bwd_tensor_cores(torch.float32, 80)
    # decode keeps its own head dims: no served model has D 80
    assert 80 not in tdec.HEAD_DIMS


@pytest.fixture
def ref_kernels():
    with jops.mode("ref"):
        yield


def test_train_100m_cut_to_two_layers_matches_jax(ref_kernels):
    jcfg = dataclasses.replace(jax_100m(), num_layers=2, dtype="float32")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(
        dataclasses.replace(train.train_100m_config(), num_layers=2,
                            dtype="float32"))
    jm = jax_build(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    tm = model_params_to_torch(jax.tree.map(np.asarray, params), cfg,
                               "cpu").trainable()
    batch = JT.synthetic_batch(jcfg, JShapeConfig("t", "train", 48, 2), 3)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, batch, remat=True)))(params)
    named = dict(tm.named_parameters())
    loss = tm.loss({k: torch.from_numpy(np.array(v))
                    for k, v in batch.items()}, remat=True)
    grads = torch.autograd.grad(loss, list(named.values()))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    got = named_to_numpy(dict(zip(named, grads)))
    want = jax.tree.map(np.asarray, jgrads)
    flat = {"/".join(p.key for p in path): np.asarray(x) for path, x in
            jax.tree_util.tree_leaves_with_path(want)}
    mine = {"/".join(p.key for p in path): np.asarray(x) for path, x in
            jax.tree_util.tree_leaves_with_path(got)}
    assert mine.keys() == flat.keys()
    for k, w in flat.items():
        np.testing.assert_allclose(mine[k], w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)
