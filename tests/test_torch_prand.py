"""repro_torch.core.prand / fmath against jax.random, draw for draw.

The port rebuilds jax's threefry2x32 generator in torch integer ops, so
the same key gives the same draws. Integer draws and ``uniform`` are
compared bit for bit; ``normal`` and ``gumbel`` to 4 ULP: they go through
``core.fmath``, which replays XLA's float32 polynomials with its FMAs
emulated in float64, whose double rounding can differ from one fused
rounding in the last place (measured: 0 ULP at these shapes).
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import prand as jprand
from repro_torch.core import fmath, prand

SHAPES = [(), (7,), (3, 5)]
SEEDS = [0, 7, 2 ** 40 + 3]


def ulp(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in float32 units in the last place (same-sign values)."""
    ai = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ai - bi)


def test_threefry_variant_is_pinned():
    # the port follows the partitionable variant; flipping it changes
    # every draw (ROADMAP §C), so a jax that flips the default fails here
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_split_fold_in_exact(seed):
    k = jax.random.PRNGKey(seed)
    t = prand.prng_key(seed)
    assert np.array_equal(np.asarray(k, np.int64), t.numpy())
    for n in (2, 3, 50):
        assert np.array_equal(np.asarray(jax.random.split(k, n), np.int64),
                              prand.split(t, n).numpy())
    for d in (0, 1, 12345, 2 ** 31 + 5):
        assert np.array_equal(np.asarray(jax.random.fold_in(k, d), np.int64),
                              prand.fold_in(t, d).numpy())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS[:2])
def test_bits_and_uniform_exact(shape, seed):
    k, t = jax.random.PRNGKey(seed), prand.prng_key(seed)
    bits = np.asarray(jax.random.bits(k, shape, jnp.uint32), np.int64)
    assert np.array_equal(bits, prand.random_bits(t, shape).numpy())
    u = np.asarray(jax.random.uniform(k, shape))
    assert np.array_equal(u.view(np.int32),
                          prand.uniform(t, shape).numpy().view(np.int32))
    u2 = np.asarray(jax.random.uniform(k, shape, minval=-3.0, maxval=0.5))
    assert np.array_equal(
        u2.view(np.int32),
        prand.uniform(t, shape, -3.0, 0.5).numpy().view(np.int32))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS[:2])
def test_normal_and_gumbel_within_4_ulp(shape, seed):
    k, t = jax.random.PRNGKey(seed), prand.prng_key(seed)
    assert ulp(jax.random.normal(k, shape),
               prand.normal(t, shape).numpy()).max(initial=0) <= 4
    assert ulp(jax.random.gumbel(k, shape),
               prand.gumbel(t, shape).numpy()).max(initial=0) <= 4


@pytest.mark.parametrize("n", [1, 10, 37, 1000])
def test_permutation_exact(n):
    k = jax.random.PRNGKey(n)
    assert np.array_equal(np.asarray(jax.random.permutation(k, n)),
                          prand.permutation(prand.prng_key(n), n).numpy())


def test_player_helpers():
    K = 37
    k, t = jax.random.PRNGKey(11), prand.prng_key(11)
    pids_j, pids_t = jnp.arange(K), torch.arange(K)
    assert np.array_equal(
        np.asarray(jprand.player_uniform(k, pids_j)),
        prand.player_uniform(t, pids_t).numpy())
    assert np.array_equal(
        np.asarray(jprand.player_uniform_row(k, pids_j, 5)),
        prand.player_uniform_row(t, pids_t, 5).numpy())
    assert ulp(jprand.player_normal(k, pids_j),
               prand.player_normal(t, pids_t).numpy()).max() <= 4
    assert ulp(jprand.player_gumbel(k, pids_j, 5),
               prand.player_gumbel(t, pids_t, 5).numpy()).max() <= 4


def test_batched_keys_map_like_vmap():
    k = jax.random.PRNGKey(3)
    ks = jax.random.split(k, 4)
    want = np.asarray(jax.vmap(lambda kk: jax.random.normal(kk, (6,)))(ks))
    got = prand.normal(prand.split(prand.prng_key(3), 4), (6,)).numpy()
    assert ulp(want, got).max() <= 4


def test_categorical_matches():
    k = jax.random.PRNGKey(5)
    logits = np.log(1.0 / (1.0 + np.arange(6, dtype=np.float32)))
    logits = np.repeat(logits[None], 30, 0)
    want = np.asarray(jax.random.categorical(k, jnp.asarray(logits)))
    got = prand.categorical(prand.prng_key(5), torch.from_numpy(logits))
    assert np.array_equal(want, got.numpy())


@pytest.mark.parametrize("name,lo,hi", [
    ("exp", -4.0, 4.0), ("exp", -90.0, 90.0), ("log", 1e-30, 1.0),
    ("log", 1.0, 1e6), ("log1p", -0.999, 0.0), ("log1p", -0.5, 4.0),
    ("erfinv", -0.9999, 0.9999)])
def test_fmath_rounds_as_xla(name, lo, hi):
    # exact to the bit on this host: XLA:CPU contracts the polynomials
    # into FMAs and flushes denormals, and fmath replays both
    rng = np.random.default_rng(zlib.crc32(f"{name}{lo}".encode()))
    x = rng.uniform(lo, hi, 100_000).astype(np.float32)
    jfn = {"exp": jnp.exp, "log": jnp.log, "log1p": jnp.log1p,
           "erfinv": jax.lax.erf_inv}[name]
    want = np.asarray(jax.jit(jfn)(x))
    got = getattr(fmath, name)(torch.from_numpy(x)).numpy()
    assert ulp(want, got).max() <= (4 if name == "erfinv" else 0)


def test_fmath_special_values():
    x = torch.tensor([0.0, -0.0, float("inf"), -1.0, float("nan"), 1e-40])
    lg = fmath.log(x).numpy()
    assert lg[0] == -np.inf and lg[1] == -np.inf and lg[2] == np.inf
    assert np.isnan(lg[3]) and np.isnan(lg[4]) and lg[5] == -np.inf
    assert fmath.exp(torch.tensor([0.0])).item() == 1.0
    assert fmath.log1p(torch.tensor([-1.0])).item() == -np.inf
    assert np.array_equal(fmath.erfinv(torch.tensor([1.0, -1.0])).numpy(),
                          [np.inf, -np.inf])
