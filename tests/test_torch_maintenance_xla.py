"""The plain maintenance statistics round as XLA:CPU rounds the
reference's, bit for bit, live JAX calls on the CPU.

``kernels/ref.py::bandit_maintenance_stats`` (the CPU's maintenance) is
held against ``repro.kernels.ref.bandit_maintenance_stats`` under
``jax.jit``: ``mu`` and ``q`` equal bit for bit at the simulator's
window R = 64, and at R = 3, 6, 12, 16, 17, 24, 32 and 128, on seeded
rows that take in the edges: no sample, one sample, every sample valid, tied samples,
samples whose ``|z|`` passes erf's clamp. Its parts each equal XLA's:
``core/fmath.py::erf`` (the clamp point, |x| up to 12, a denormal),
the ``powf`` table of ``n ** -0.2``, the row sums' order, and
``fmath.sqrt`` (correctly rounded, where torch's vectorised float32
``sqrt`` is not). At R = 20..23 XLA sums the KDE in an order not
replayed: ``q`` stays exact and ``mu`` a few ULPs away. At any R the
KDE's sum is a sum of the whole row.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.core import fmath
from repro_torch.kernels import ref

CLAMP = np.float32(3.7439211627767994)


def bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("seed", range(2))
def test_erf_is_xlas(seed):
    rng = np.random.default_rng(seed)
    x = np.concatenate([
        np.linspace(-12.0, 12.0, 200_001, dtype=np.float32),
        rng.normal(0.0, 2.0, 100_000).astype(np.float32),
        np.array([CLAMP, -CLAMP, np.nextafter(CLAMP, np.float32(0)),
                  np.nextafter(CLAMP, np.float32(9)), 0.0, -0.0, 1e-40,
                  -1e-40, 3.75, -3.75, 12.0, -12.0], np.float32)])
    want = jax.jit(jax.lax.erf)(jnp.asarray(x))
    got = fmath.erf(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("R", [16, 32, 64, 128, 512])
def test_powf_table_is_the_references_pow(R):
    n = np.arange(1, R + 1, dtype=np.float32)
    want = jax.jit(lambda v: v ** -0.2)(jnp.asarray(n))
    np.testing.assert_array_equal(bits(ref._powf_table(R)[1:]), bits(want))
    got = ref._pow_neg_fifth(torch.from_numpy(n), R).numpy()
    np.testing.assert_array_equal(bits(got), bits(want))


def test_sqrt_is_correctly_rounded():
    x = np.random.default_rng(0).uniform(0, 100, 200_000).astype(np.float32)
    want = np.sqrt(x.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(
        bits(fmath.sqrt(torch.from_numpy(x)).numpy()), bits(want))


@pytest.mark.parametrize("R", [16, 32, 64, 96, 128])
def test_row_sum_order_is_xlas(R):
    x = np.random.default_rng(R).normal(60.0, 30.0, (3000, R)).astype(
        np.float32)
    want = jax.jit(lambda a: a.sum(-1))(jnp.asarray(x))
    got = ref._xla_row_sum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(bits(got), bits(want))


def maintenance_rows(rows: int, R: int, seed: int):
    """Seeded windows in seconds: a gamma latency on a per-row RTT,
    with rows of no sample, of one sample, of every sample valid, of
    tied samples, and with samples past erf's clamp."""
    rng = np.random.default_rng(seed)
    lat = (rng.gamma(4.0, 0.01, (rows, R))
           + rng.uniform(0.002, 0.04, (rows, 1))).astype(np.float32)
    mask = rng.random((rows, R)) < rng.uniform(0.0, 1.2, (rows, 1))
    e = rows // 10
    mask[:e] = False                                      # n = 0
    mask[e:2 * e] = False
    mask[e:2 * e, min(3, R - 1)] = True                   # n = 1
    mask[2 * e:3 * e] = True                              # every sample
    lat[3 * e:4 * e] = lat[3 * e:4 * e, :1]               # tied samples
    lat[4 * e:5 * e, 0] = 20.0                            # erf clamps z
    lat[5 * e:6 * e, 1::4] = np.float32(0.08)             # at tau
    rtt = rng.uniform(0.002, 0.04, rows).astype(np.float32)
    return lat, mask, rtt


@pytest.mark.parametrize("R", [3, 6, 12, 17, 20, 23, 31, 48])
def test_kde_sum_is_a_row_sum(R):
    """The KDE's sum in XLA's order adds every column once, at any
    width: float32 rounding of the float64 sum of values in [0, 1]."""
    x = np.random.default_rng(R).random((3000, R), dtype=np.float32)
    x[x < 0.2] = 0.0
    got = ref._xla_kde_sum(torch.from_numpy(x))
    assert got.shape == (3000,) and got.dtype == torch.float32
    want = x.astype(np.float64).sum(-1)
    np.testing.assert_allclose(got.double().numpy(), want,
                               rtol=R * 2.0 ** -24, atol=0)


def run_both(R: int, tau: float):
    lat, mask, rtt = maintenance_rows(4000, R, R)
    want = jax.jit(lambda a, b, c: jref.bandit_maintenance_stats(
        a, b, c, tau, 0.9))(lat, mask, rtt)
    got = ref.bandit_maintenance_stats(torch.from_numpy(lat),
                                       torch.from_numpy(mask),
                                       torch.from_numpy(rtt), tau, 0.9)
    return lat, mask, want, got


@pytest.mark.parametrize("R", [20, 23])
def test_maintenance_stats_at_20_to_23_are_ulps_from_the_references(R):
    _, _, want, got = run_both(R, 0.08)
    np.testing.assert_array_equal(bits(got[1].numpy()), bits(want[1]))
    apart = np.abs(bits(got[0].numpy()).astype(np.int64) - bits(want[0]))
    assert apart.max() <= 4


@pytest.mark.parametrize("tau", [0.08, 0.15])
@pytest.mark.parametrize("R", [3, 6, 12, 16, 17, 24, 32, 64, 128])
def test_maintenance_stats_equal_the_references(R, tau):
    lat, mask, want, got = run_both(R, tau)
    # some sample's erf argument lies past the clamp
    m = mask.astype(np.float64)
    n = np.maximum(m.sum(-1), 1.0)
    mean = (lat * m).sum(-1) / n
    sd = np.sqrt((((lat - mean[:, None]) ** 2) * m).sum(-1) / n)
    h = np.maximum(1.06 * sd * n ** -0.2, 1e-4)
    x = np.abs(tau - lat) / h[:, None] / np.sqrt(2.0)
    assert (x[mask] > CLAMP).any()
    for w, g, name in zip(want, got, ("mu", "q")):
        np.testing.assert_array_equal(bits(g.numpy()), bits(w),
                                      err_msg=name)
