"""repro_torch.core against repro.core: SWRR, KDE, oracle and the bandit.

Both packages get the same inputs, made with numpy from a seed; the
bandit functions start from the same mid-run state, built by the JAX
package and carried across with ``repro_torch.convert``. Integer and
bool outputs must match exactly. Floats match to ``rtol=1e-5,
atol=1e-6``: XLA and torch reduce a row in different orders, XLA
contracts ``a * b + c`` into FMAs, and their float32 ``erf``/``pow``
differ by a few ULP.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bandit as jb
from repro.core import kde as jkde
from repro.core import oracle as jor
from repro.core import swrr as jswrr
from repro_torch import convert
from repro_torch.core import bandit as tb
from repro_torch.core import kde as tkde
from repro_torch.core import oracle as tor
from repro_torch.core import swrr as tswrr

K, M, R, RQ = 12, 5, 16, 32
RTOL, ATOL = 1e-5, 1e-6


def T(x) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(x), copy=True))


def assert_same(want, got, what=""):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert want.shape == got.shape, (what, want.shape, got.shape)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got.astype(want.dtype), want,
                                      err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=what)


def assert_state(want, got):
    for f in want._fields:
        assert_same(getattr(want, f), getattr(got, f), f)


def jax_mid_state(seed: int, params, rounds: int = 40):
    """A JAX bandit state after ``rounds`` request rounds and a few
    maintenance steps, with trips, cooldowns and a missing instance."""
    rng = np.random.default_rng(seed)
    active = jnp.asarray(np.arange(M) != M - 1)
    s = jb.init_state(K, M, params, R, RQ, active=active,
                      key=jax.random.PRNGKey(seed),
                      pids=jnp.arange(K, dtype=jnp.int32))
    rtt = jnp.asarray(rng.uniform(0.002, 0.04, (K, M)), jnp.float32)

    @jax.jit
    def rnd(s, lat, t, mask):
        choice, s, _ = jb.select(s)
        return jb.record(s, params, choice, lat, t, mask)

    maint = jax.jit(lambda s, t: jb.maintenance(s, params, rtt, t))
    for r in range(rounds):
        t = jnp.float32(0.1 * r)
        lat = jnp.asarray(rng.uniform(0.01, 0.12, K), jnp.float32)
        s = rnd(s, lat, t, jnp.asarray(rng.uniform(size=K) < 0.8))
        if r % 10 == 9:
            s = maint(s, t)
    return s, np.asarray(rtt)


@pytest.fixture(scope="module")
def params():
    return jb.BanditParams(tau=0.08, rho=0.9, window=10.0, err_thresh=3,
                           cooldown=2.0)


@pytest.fixture(scope="module")
def mid(params):
    return jax_mid_state(0, params)


def tparams(p) -> tb.BanditParams:
    return tb.BanditParams(**p._asdict())


# ---------------------------------------------------------------------------
# SWRR, KDE, oracle.
# ---------------------------------------------------------------------------

def test_swrr_select_random_rows():
    rng = np.random.default_rng(1)
    w = rng.uniform(size=(K, M)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    cw = rng.uniform(-1, 1, (K, M)).astype(np.float32)
    jc, jcw, jv = jswrr.swrr_select(jnp.asarray(w), jnp.asarray(cw))
    tc, tcw, tv = tswrr.swrr_select(T(w), T(cw))
    assert_same(jc, tc, "choice")
    assert_same(jcw, tcw, "cw")
    assert_same(jv, tv, "valid")


def test_swrr_select_exact_ties_take_the_first_index():
    w = np.full((4, M), 0.2, np.float32)
    w[3] = 0.0                                   # all-zero row: invalid
    cw = np.zeros((4, M), np.float32)
    cw[1, 2] = cw[1, 4] = 0.5                    # tie between arms 2 and 4
    cw[2] = 0.5                                  # tie across every arm
    jc, jcw, jv = jswrr.swrr_select(jnp.asarray(w), jnp.asarray(cw))
    tc, tcw, tv = tswrr.swrr_select(T(w), T(cw))
    assert tc.tolist() == [0, 2, 0, 0] == np.asarray(jc).tolist()
    assert_same(jcw, tcw, "cw")
    assert tv.tolist() == [True, True, True, False]


def test_kde_functions():
    rng = np.random.default_rng(2)
    lat = rng.uniform(0.01, 0.15, (20, R)).astype(np.float32)
    lat[:, :4] = np.float32(0.05)                 # ties
    mask = rng.uniform(size=(20, R)) < 0.6
    mask[0], mask[1], mask[2, 1:] = False, True, False
    x = rng.uniform(-4, 4, 50).astype(np.float32)
    assert_same(jkde.normal_cdf(jnp.asarray(x)), tkde.normal_cdf(T(x)))
    jl, jm = jnp.asarray(lat), jnp.asarray(mask)
    tl, tm = T(lat), T(mask)
    assert_same(jkde.silverman_bandwidth(jl, jm), tkde.silverman_bandwidth(tl, tm))
    assert_same(jkde.kde_success_prob(jl, jm, 0.08),
                tkde.kde_success_prob(tl, tm, 0.08))
    bw = rng.uniform(1e-3, 2e-2, 20).astype(np.float32)
    assert_same(jkde.kde_success_prob(jl, jm, 0.08, jnp.asarray(bw)),
                tkde.kde_success_prob(tl, tm, 0.08, T(bw)))
    # counts over counts: exact
    np.testing.assert_array_equal(
        np.asarray(jkde.empirical_success_prob(jl, jm, 0.08)),
        tkde.empirical_success_prob(tl, tm, 0.08).numpy())
    for q in (0.0, 0.5, 0.9, 1.0):              # a selection: exact
        np.testing.assert_array_equal(
            np.asarray(jkde.masked_quantile(jl, jm, q)),
            tkde.masked_quantile(tl, tm, q).numpy())


def test_oracle_functions():
    rng = np.random.default_rng(3)
    mu = rng.uniform(size=(K, M)).astype(np.float32)
    mu[0, 1] = mu[0, 3] = 1.0                    # tie
    w = rng.uniform(size=(K, M)).astype(np.float32)
    act = np.arange(M) % 4 != 1
    for a in (None, act):
        ja = None if a is None else jnp.asarray(a)
        ta = None if a is None else T(a)
        assert_same(jor.oracle_weights(jnp.asarray(mu), ja),
                    tor.oracle_weights(T(mu), ta))
        assert_same(jor.step_regret(jnp.asarray(w), jnp.asarray(mu), ja),
                    tor.step_regret(T(w), T(mu), ta))
    mu_t = rng.uniform(size=(6, K, M)).astype(np.float32)
    assert_same(jor.variation_budget(jnp.asarray(mu_t)),
                tor.variation_budget(T(mu_t)))


# ---------------------------------------------------------------------------
# The bandit, from one mid-run state.
# ---------------------------------------------------------------------------

def test_init_state_exact(params):
    act = np.arange(M) != 2
    pids = np.arange(K, dtype=np.int32)
    for key in (None, 4):
        jk = None if key is None else jax.random.PRNGKey(key)
        tk = None if key is None else tb.prand.prng_key(key)
        js = jb.init_state(K, M, params, R, RQ, jnp.asarray(act), jk,
                           jnp.asarray(pids))
        ts = tb.init_state(K, M, tparams(params), R, RQ, T(act), tk, T(pids))
        assert_state(js, ts)
    js = jb.init_state(K, M, params, R, RQ, key=jax.random.PRNGKey(9))
    ts = tb.init_state(K, M, tparams(params), R, RQ,
                       key=tb.prand.prng_key(9), device="cpu")
    assert_state(js, ts)


def test_select_record_feedback(params, mid):
    js, _ = mid
    ts = convert.bandit_state_to_torch(jax.tree.map(np.asarray, js), "cpu")
    tp = tparams(params)
    jc, js2, jv = jb.select(js)
    tc, ts2, tv = tb.select(ts)
    assert_same(jc, tc, "choice")
    assert_state(js2, ts2)
    rng = np.random.default_rng(4)
    lat = rng.uniform(0.05, 0.11, K).astype(np.float32)
    mask = rng.uniform(size=K) < 0.7
    t = np.float32(4.0)
    for jfn, tfn in ((jb.record, tb.record),
                     (jb.record_feedback, tb.record_feedback)):
        jo = jax.jit(lambda s, c, la, m, f=jfn: f(s, params, c, la, t, m))(
            js2, jc, jnp.asarray(lat), jnp.asarray(mask))
        to = tfn(ts2, tp, tc, T(lat), float(t), T(mask))
        assert_state(jo, to)


def test_record_rings_batch(params, mid):
    js, _ = mid
    ts = convert.bandit_state_to_torch(jax.tree.map(np.asarray, js), "cpu")
    rng = np.random.default_rng(5)
    C = 40                                       # > R: overwrites within a batch
    ch = rng.integers(0, M, (K, C)).astype(np.int32)
    lat = rng.uniform(0.01, 0.12, (K, C)).astype(np.float32)
    mask = rng.uniform(size=(K, C)) < 0.8
    jo = jax.jit(lambda s, c, la, m: jb.record_rings_batch(
        s, params, c, la, np.float32(4.5), m))(
        js, jnp.asarray(ch), jnp.asarray(lat), jnp.asarray(mask))
    to = tb.record_rings_batch(ts, tparams(params), T(ch), T(lat), 4.5, T(mask))
    assert_state(jo, to)


def test_rolling_qos(mid):
    js, _ = mid
    ts = convert.bandit_state_to_torch(jax.tree.map(np.asarray, js), "cpu")
    for t in (2.0, 3.95, 25.0):
        for a, b in zip(jb._rolling_qos(js, np.float32(t), 1.5),
                        tb._rolling_qos(ts, t, 1.5)):
            assert_same(a, b)


@pytest.mark.parametrize("kde_mode", [0, 1])
def test_maintenance(params, mid, kde_mode):
    js, rtt = mid
    ts = convert.bandit_state_to_torch(jax.tree.map(np.asarray, js), "cpu")
    p = params._replace(kde_mode=kde_mode, window=2.0)
    lb = np.arange(K) % 3 == 0
    for mask in (None, lb):
        jo = jax.jit(lambda s, r, m: jb.maintenance(s, p, r, 3.95, m))(
            js, jnp.asarray(rtt), None if mask is None else jnp.asarray(mask))
        to = tb.maintenance(ts, tparams(p), T(rtt), 3.95,
                            None if mask is None else T(mask))
        assert_state(jo, to)


def test_maintenance_subset_drops_padding(params, mid):
    js, rtt = mid
    ts = convert.bandit_state_to_torch(jax.tree.map(np.asarray, js), "cpu")
    p = params._replace(window=2.0)
    idx = np.array([7, 0, K, 4, K], np.int32)     # K = padding sentinel
    jo = jax.jit(lambda s, r, i: jb.maintenance_subset(s, p, r, 3.95, i))(
        js, jnp.asarray(rtt), jnp.asarray(idx))
    to = tb.maintenance_subset(ts, tparams(p), T(rtt), 3.95, T(idx))
    assert_state(jo, to)
    # the subset commits exactly what the masked full update does
    full = tb.maintenance(ts, tparams(p), T(rtt), 3.95,
                          T(np.isin(np.arange(K), idx)))
    for f in to._fields:
        assert torch.equal(getattr(to, f), getattr(full, f)), f


def test_placement_events(params, mid):
    js, rtt = mid
    ts = convert.bandit_state_to_torch(jax.tree.map(np.asarray, js), "cpu")
    tp = tparams(params)
    assert_state(jb.instance_added(js, params, M - 1, jnp.asarray(rtt),
                                   np.float32(4.0)),
                 tb.instance_added(ts, tp, M - 1, T(rtt), 4.0))
    assert_state(jb.instance_removed(js, 1), tb.instance_removed(ts, 1))
    new = np.array([True, False, True, True, True])
    assert_state(jb.sync_active(js, params, jnp.asarray(new)),
                 tb.sync_active(ts, tp, T(new)))
