"""Serving on a mesh of ranks against one rank, and one rank against the
JAX package: ``prefill`` and 4 ``decode`` steps of the reduced
qwen3-4b, qwen3-moe-30b-a3b, gemma3-1b, mamba2-1.3b and whisper-tiny in
float32 (the port's weights from seed 0; against the reference, its
weights drawn by its ``init`` and carried across by ``convert``, for
the dense model: the other families' one-rank serving is held against
the reference by their own files, ``test_torch_whisper.py`` and the
others). Every one of the ten configs also
serves on a model axis of 2.

One spawn of 4 gloo CPU ranks serves and trains on a 2 x 2 (data, model)
mesh, then splits into two groups of 2 (``torch_mesh_ranks.then_in_pairs``).
On 2 x 2 it serves the models under four of the reference dry run's rule
sets (``sharding.rules_for``): the head-split layout (``plain``: the
batch over ``data``, heads, caches' KV heads, FFN, experts and the
vocabulary over ``model``), ``hybrid`` (the caches' rows over ``model``
and slots over ``data``: the query re-laid by an all-to-all),
``batchmodel`` (the batch over ``model``, the weights gathered, the
slots over ``data``) and the long-context rules (the slots over every
rank; ``batchmodel`` for two of them, ``cells4``); and it trains the SSM,
hybrid and Whisper families 3 steps (``adamw(1e-3, clip_norm=1.0)``, seq
16 x batch 8) with their heads split over ``model``, against one rank.
The two pairs then serve all ten configs on a (1, 2) mesh under
``hybrid`` (an all-to-all, no slot split), half each, and three on
(2, 1) (the slots over ``data``).

Tolerances: sharded against one rank ``rtol=1e-4, atol=1e-5`` (float32,
the reference SPMD test's;
the partial sums over ``model`` and the merge of the slots' slices
round in another order); one rank against the reference's prefill and
decode ``rtol=atol=2e-4``, ``test_torch_models.py``'s.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro_torch.configs import ARCH_NAMES, ModelConfig
from repro_torch.configs.base import AUDIO, VLM, ShapeConfig
from repro_torch.convert import model_params_to_torch
from repro_torch.launch.mesh import _free_port, make_test_mesh, spawn
from repro_torch.models import build_model
from repro_torch.sharding import rules_for
from torch_mesh_ranks import serve, then_in_pairs, train

ARCHS = ("qwen3-4b", "qwen3-moe-30b-a3b", "gemma3-1b", "mamba2-1.3b",
         "whisper-tiny")
B, PROMPT, STEPS = 4, 12, 4
MAX_LEN = PROMPT + STEPS
SHARDED = dict(rtol=1e-4, atol=1e-5)
F32 = dict(rtol=2e-4, atol=2e-4)
DECODE = ShapeConfig("d", "decode", MAX_LEN, B)
LONG = ShapeConfig("long", "decode", MAX_LEN, 1)      # batch 1: long context
LAYOUTS4 = ("plain", "hybrid", "batchmodel", "long")
# the families whose SSM or cross-attention heads split over ``model``,
# also trained on the mesh
TRAINED = ("mamba2-1.3b", "hymba-1.5b", "whisper-tiny")
# the slots over 2 ranks alone: a full cache, rings and a cross cache
SLOTS2 = ("qwen3-4b", "gemma3-1b", "whisper-tiny")
TRAIN = ShapeConfig("t", "train", 16, 8)


def jcfg(arch: str):
    return dataclasses.replace(jax_config(arch, reduced=True),
                               dtype="float32")


@functools.cache
def reference(arch: str):
    """The reference's params as numpy, and the port's state dict of
    them."""
    cfg = case(arch)[0]
    params = jax.tree.map(np.asarray, jax.jit(
        jax_build(jcfg(arch)).init)(jax.random.PRNGKey(0)))
    return params, model_params_to_torch(params, cfg, "cpu").state_dict()


@functools.cache
def case(arch: str):
    """(the port's config, its state dict from seed 0, None, the whole
    batch, the decode tokens (B, STEPS), the first decode position)."""
    cfg = ModelConfig(**dataclasses.asdict(jcfg(arch)))
    state = build_model(cfg, "cpu", seed=0).state_dict()
    rng = np.random.default_rng(3)
    prompt = 4 if cfg.family == AUDIO else PROMPT
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, prompt)))}
    if cfg.family == AUDIO:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.cross_kv_len, cfg.d_model)).astype(np.float32))
    if cfg.family == VLM:
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, STEPS)))
    return cfg, state, None, batch, tokens, prompt + cfg.num_patches


def rules(arch: str, mesh, layout: str) -> dict:
    cfg = case(arch)[0]
    if layout == "long":
        over = rules_for(cfg, LONG, mesh)
        # every rank on the slots: no batch or KV-head split to claim them
        over.update(kv_batch=(), kv_heads=())
        return over
    return rules_for(cfg, DECODE, mesh, layout)


def calls(mesh, layouts, archs=ARCHS) -> list:
    out = []
    for arch in archs:
        cfg, state, _, batch, tokens, start = case(arch)
        for layout in layouts:
            out.append((serve, (cfg, state, batch, tokens, start,
                                start + STEPS, mesh,
                                rules(arch, mesh, layout)), {}))
    return out


@functools.cache
def one_rank(arch: str, weights: str = "port") -> list:
    cfg, state, _, batch, tokens, start = case(arch)
    if weights == "reference":
        state = reference(arch)[1]
    return serve(cfg, state, batch, tokens, start, start + STEPS)


def cells4() -> list:
    """(arch, layout) of the 4-rank runs: every arch under the plain,
    ``hybrid`` and long-context rules; ``batchmodel`` (the weights
    gathered a layer at a time) for a decoder with KV heads and the SSM
    (its packed columns put back in their order)."""
    return [(a, lay) for a in ARCHS for lay in LAYOUTS4
            if lay != "batchmodel" or a in ("qwen3-4b", "mamba2-1.3b")]


# each pair's runs after the 2 x 2 ones, (mesh, archs) under ``hybrid``
PAIRS = (((make_test_mesh(1, 2), ARCH_NAMES[:5]),
          (make_test_mesh(2, 1), SLOTS2)),
         ((make_test_mesh(1, 2), ARCH_NAMES[5:]),))


@pytest.fixture(scope="module")
def ranks() -> tuple:
    """The one spawn's results: ``{(arch, layout or "train"): run}`` on
    2 x 2 and ``{(arch, "1x2" or "2x1"): run}`` on the pairs."""
    mesh = make_test_mesh(2, 2)
    todo = [c for a, lay in cells4() for c in calls(mesh, (lay,), (a,))] + [
        (train, (case(a)[0], case(a)[1], TRAIN, STEPS, mesh), {})
        for a in TRAINED]
    pairs = tuple([c for m, archs in runs for c in calls(m, ("hybrid",), archs)]
                  for runs in PAIRS)
    got = spawn(then_in_pairs, 4, todo, pairs, (_free_port(), _free_port()),
                every_rank=True, threads=1)
    keys = cells4() + [(a, "train") for a in TRAINED]
    two = {}
    for p, runs in enumerate(PAIRS):
        names = [(a, f"{m.shape['data']}x{m.shape['model']}")
                 for m, archs in runs for a in archs]
        two.update(zip(names, got[2 * p][1]))
    return dict(zip(keys, got[0][0])), two


@pytest.fixture(scope="module")
def four(ranks) -> dict:
    return ranks[0]


@pytest.mark.parametrize("arch", TRAINED)
def test_split_heads_train_as_one_rank(four, arch):
    """The SSM's heads split by head group, the hybrid's attention and SSM
    heads, Whisper's cross-attention heads: 3 steps on 2 x 2 ranks equal
    one rank's."""
    cfg, state = case(arch)[:2]
    one = train(cfg, state, TRAIN, STEPS)["losses"]
    assert np.isfinite(one).all()
    np.testing.assert_allclose(four[(arch, "train")]["losses"], one,
                               **SHARDED)


@pytest.fixture(scope="module")
def two(ranks) -> dict:
    return ranks[1]


def check(got: list, want: list) -> None:
    assert len(got) == len(want) == STEPS + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), **SHARDED)


@pytest.mark.parametrize("arch, layout", cells4())
def test_four_ranks_serve_as_one(four, arch, layout):
    check(four[(arch, layout)], one_rank(arch))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_every_arch_serves_on_a_model_axis_of_two(two, arch):
    check(two[(arch, "1x2")], one_rank(arch))


@pytest.mark.parametrize("arch", SLOTS2)
def test_slots_split_over_two_ranks(two, arch):
    check(two[(arch, "2x1")], one_rank(arch))


@pytest.mark.parametrize("arch", ("qwen3-4b",))
def test_one_rank_serves_as_the_reference(arch, monkeypatch):
    monkeypatch.setenv("REPRO_DECODE_IMPL", "naive")
    cfg, _, _, batch, tokens, start = case(arch)
    params = reference(arch)[0]
    model = jax_build(jcfg(arch))
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    logits, cache = jax.jit(lambda p, b: model.prefill(
        p, b, max_len=MAX_LEN))(params, jb)
    want = [np.asarray(logits)]
    step = jax.jit(model.decode)
    for i in range(STEPS):
        logits, cache = step(params, cache, {
            "token": jnp.asarray(tokens[:, i:i + 1].numpy()),
            "pos": jnp.int32(start + i)})
        want.append(np.asarray(logits))
    got = one_rank(arch, "reference")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.reshape(g.shape), **F32)
