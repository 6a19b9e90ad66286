"""Lane-batched runs: S simulations as the lanes of one run.

* Inside the port, exactly: lane s of ``run_sim_grid`` over three
  distinct scenarios (one killing and restoring instances, one surge,
  one partition) equals ``run_sim_stream`` on that lane's drivers and
  key, every accumulator field and series value ``torch.equal``, for
  ``qedgeproxy`` (fused round, round scan, pre-fusion structure),
  ``proxy_mity`` at alpha 1.0 and 0.9 and ``dec_sarsa``; ``run_sim_batch``
  against ``run_sim`` in trace mode; ``ref.round_step_swrr`` and
  ``round_step_gumbel`` at S = 3 against three S = 1 calls; the
  placement events touch only the lanes whose liveness changed.
* The round kernel's lane layout (``csrc/round_fused.cu``), through a
  numpy emulation of its blocked schedule with every lane's queue in
  each block, bit for bit against the plain version; its shared memory
  and workspace sizes.
* Against the JAX package: ``run_sim_grid`` against the reference's
  ``run_sim_grid`` on one device, on the same stacked drivers and keys,
  for ``qedgeproxy`` and ``proxy_mity``: every accumulator field and
  series value equal, the float sums of regret and the true ``mu``
  included (the plain maintenance, the oracle's ``erf``, the weights'
  and regret's row sums round as XLA:CPU does). The cascade lane run
  alone equals the reference's run alone. Each lane's stagger table
  equals the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.continuum import library as jlib
from repro.continuum import scenarios as jscn
from repro.continuum import simulator as js
from repro.continuum import topology as jtopo
from repro_torch import convert
from repro_torch.continuum import library as tlib
from repro_torch.continuum import metrics as tm
from repro_torch.continuum import scenarios as tscn
from repro_torch.continuum import simulator as ts
from repro_torch.continuum import topology as ttopo
from repro_torch.core import bandit as tb
from repro_torch.core import prand
from repro_torch.kernels import ref
from repro_torch.kernels import round_fused as tround
from repro_torch.launch.mesh import make_continuum_mesh, make_grid_mesh

SCENARIOS = ("cascade_failure", "surge", "partition_heal")
GRID = dict(K=30, M=10, horizon=5.0, warm=10)
STRATEGIES = {
    "qedgeproxy": ("qedgeproxy", {}, True),
    "qedgeproxy_scan": ("qedgeproxy", {}, False),
    "qedgeproxy_prefusion": ("qedgeproxy", dict(fused=False), True),
    "proxy_mity_1.0": ("proxy_mity", dict(alpha=1.0), True),
    "proxy_mity_0.9": ("proxy_mity", dict(alpha=0.9), True),
    "dec_sarsa": ("dec_sarsa", {}, True),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors: one intra-op thread is faster than many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(x) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(x), copy=True))


# ---------------------------------------------------------------------------
# The plain rounds with a lane axis.
# ---------------------------------------------------------------------------

def lane_round_inputs(S, K, M, C=8, R=16, Rq=32, seed=0):
    """S lanes of a mid-run round state, each lane its own liveness,
    service row, queue and request counts; lane 1 has instances down."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    KK = S * K
    active = rng.uniform(size=(S, M)) > 0.15
    active[:, 0] = True
    if S > 1:
        active[1, 1:3] = False
    act_rows = np.repeat(active, K, axis=0)
    cooling = rng.uniform(size=(KK, M)) < 0.1
    in_pool = (rng.uniform(size=(KK, M)) < 0.8) & ~cooling & act_rows
    w = rng.uniform(size=(KK, M)).astype(f32) * in_pool
    w[rng.uniform(size=KK) < 0.1] = 0.0
    w = (w / np.maximum(w.sum(-1, keepdims=True), f32(1e-30))).astype(f32)
    t = f32(42.5)
    s_m = rng.uniform(0.004, 0.009, (S, M)).astype(f32)
    return dict(
        weights=w, cw=rng.uniform(-0.5, 0.5, (KK, M)).astype(f32),
        err=rng.integers(0, 5, (KK, M)).astype(np.int32),
        cooldown_until=np.where(cooling, t + f32(3.0), f32(-1e30)).astype(f32),
        in_pool=in_pool, active=active,
        lat_buf=rng.uniform(0.005, 0.15, (KK, M, R)).astype(f32),
        ts_buf=rng.uniform(30.0, 42.0, (KK, M, R)).astype(f32),
        ptr=rng.integers(0, R, (KK, M)).astype(np.int32),
        r_buf=(rng.uniform(size=(KK, Rq)) < 0.9).astype(f32),
        rts_buf=rng.uniform(30.0, 42.0, (KK, Rq)).astype(f32),
        rptr=rng.integers(0, Rq, KK).astype(np.int32),
        q=rng.uniform(0.0, 12.0, (S, M)).astype(f32),
        nc=rng.integers(0, C + 1, KK).astype(np.int32),
        z=np.exp(0.25 * rng.standard_normal((C, KK))).astype(f32),
        rtt_t=rng.uniform(0.002, 0.05, (KK, M)).astype(f32),
        s_m=s_m, served_per_round=(f32(0.1) / (f32(C) * s_m)).astype(f32),
        t=t)


ROUND_KW = dict(tau=0.08, err_thresh=5, cooldown=10.0)
PER_LANE = ("active", "q", "s_m", "served_per_round")


def lane_slice(args, s, K):
    """Lane s's inputs alone, in the one-lane (M,) layout."""
    out = {}
    for k, v in args.items():
        if k == "t":
            out[k] = v
        elif k in PER_LANE:
            out[k] = T(v[s])
        elif k == "z":
            out[k] = T(v[:, s * K:(s + 1) * K])
        else:
            out[k] = T(v[s * K:(s + 1) * K])
    return out


@pytest.mark.parametrize("S,K,M", [(3, 7, 5), (4, 30, 10)])
def test_round_step_lanes_equal_single_lane_calls(S, K, M):
    args = lane_round_inputs(S, K, M, seed=S)
    got = ref.round_step_swrr(**{k: T(v) if k != "t" else v
                                 for k, v in args.items()}, **ROUND_KW)
    assert got.q.shape == (S, M) and got.arrivals.shape == (S, M)
    for s in range(S):
        one = ref.round_step_swrr(**lane_slice(args, s, K), **ROUND_KW)
        for name in ref.RoundStepOut._fields:
            a, b = getattr(one, name), getattr(got, name)
            b = b[s] if name in ("q", "arrivals") else b[s * K:(s + 1) * K]
            assert torch.equal(a, b), (s, name)
    # the state moved: trips and arrivals in every lane
    assert (got.cooldown_until.numpy() != args["cooldown_until"]).any()
    assert (got.arrivals.sum(-1) > 0).all()


def test_round_step_gumbel_lanes_equal_single_lane_calls():
    S, K, M, C = 3, 6, 4, 5
    rng = np.random.default_rng(1)
    w = rng.uniform(size=(S * K, M)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    q = rng.uniform(0, 5, (S, M)).astype(np.float32)
    nc = rng.integers(0, C + 1, S * K).astype(np.int32)
    z = np.exp(0.25 * rng.standard_normal((C, S * K))).astype(np.float32)
    gum = rng.gumbel(size=(C, S * K, M)).astype(np.float32)
    rtt = rng.uniform(0.002, 0.05, (S * K, M)).astype(np.float32)
    s_m = rng.uniform(0.004, 0.009, (S, M)).astype(np.float32)
    srv = (np.float32(0.1) / (np.float32(C) * s_m)).astype(np.float32)
    got = ref.round_step_gumbel(*(T(x) for x in (w, q, nc, z, gum, rtt, s_m,
                                                 srv)))
    for s in range(S):
        rows = slice(s * K, (s + 1) * K)
        one = ref.round_step_gumbel(T(w[rows]), T(q[s]), T(nc[rows]),
                                    T(z[:, rows]), T(gum[:, rows]),
                                    T(rtt[rows]), T(s_m[s]), T(srv[s]))
        for i, (a, b) in enumerate(zip(one, got)):
            assert torch.equal(a, b[s] if i < 2 else b[rows]), (s, i)


# ---------------------------------------------------------------------------
# The round kernel's lane layout, emulated in numpy.
# ---------------------------------------------------------------------------

def _row_sum(x, skip=-1):
    s = np.float32(0.0) if skip == 0 else x[0]
    for m in range(1, len(x)):
        s = s + (np.float32(0.0) if m == skip else x[m])
    return np.float32(s)


def _blocked_lanes(a, tau, err_thresh, cooldown, S, warps, ctas_per_sm,
                   sms):
    """numpy emulation of ``round_kernel``'s schedule with S lanes: the
    players of every lane in CTA blocks, each block holding every
    lane's queue; a block's round arrivals summed per lane in its shared
    memory, then onto the round's (S, M) workspace rows; every block
    recomputing every lane's queue; ring slots after the last round."""
    f32 = np.float32
    KK, M, R = a["lat_buf"].shape
    C, Rq = a["z"].shape[0], a["r_buf"].shape[1]
    Kl = KK // S
    grid, _ = tround._grid(KK, warps, ctas_per_sm, sms)
    W = grid * warps
    w, cw = a["weights"].copy(), a["cw"].copy()
    err, cd = a["err"].copy(), a["cooldown_until"].copy()
    pool = a["in_pool"].copy()
    t, t_cd = f32(a["t"]), f32(f32(a["t"]) + f32(cooldown))
    q_blocks = [a["q"].copy() for _ in range(grid)]
    choices = np.zeros((KK, C), np.int32)
    lats, procs = np.zeros((KK, C), f32), np.zeros((KK, C), f32)
    ws = np.zeros((C, S, M), f32)
    for r in range(C):
        partial = np.zeros((grid, S, M), f32)
        for b in range(grid):
            for gw in range(b * warps, (b + 1) * warps):
                for k in tround._players(gw, KK, W):
                    ln = k // Kl
                    q, act = q_blocks[b][ln], a["active"][ln]
                    total = _row_sum(w[k])
                    cw[k] += w[k]
                    choice = int(np.argmax(cw[k]))
                    cw[k][choice] = cw[k][choice] - total
                    q1s = f32((q[choice] + f32(1.0)) * a["s_m"][ln, choice])
                    z = a["z"][r, k]
                    lat = f32(np.float64(q1s) * np.float64(z)
                              + np.float64(a["rtt_t"][k, choice]))
                    mask = r < a["nc"][k]
                    new_err = 0 if lat <= f32(tau) else err[k, choice] + 1
                    trip = bool(mask and new_err >= err_thresh)
                    if mask:
                        err[k, choice] = 0 if trip else new_err
                    if trip:
                        cd[k, choice], pool[k, choice] = t_cd, False
                    wsum = _row_sum(w[k], choice) if trip else total
                    tripped = (np.arange(M) == choice) & trip
                    n_rem = int((act & pool[k]).sum())
                    n_act = int((act & ~tripped).sum())
                    if wsum > 0:
                        num = np.where(tripped, f32(0.0), w[k])
                        den = max(wsum, f32(1e-30))
                    else:
                        fb = act & pool[k] if n_rem else act & ~tripped
                        num = fb.astype(f32)
                        den = f32(max(n_rem if n_rem else n_act, 1))
                    w[k] = np.where(num == 0, num, num / den).astype(f32)
                    cw[k][tripped] = f32(0.0)
                    choices[k, r], lats[k, r] = choice, lat
                    procs[k, r] = f32(q1s * z)
                    if mask:
                        partial[b, ln, choice] += f32(1.0)
        for b in reversed(range(grid)):
            ws[r] += partial[b]
        for b in range(grid):
            q_blocks[b] = np.maximum((q_blocks[b] + ws[r])
                                     - a["served_per_round"],
                                     f32(0.0)).astype(f32)
        for q in q_blocks[1:]:
            np.testing.assert_array_equal(q, q_blocks[0])
    lat_buf, ts_buf = a["lat_buf"].copy(), a["ts_buf"].copy()
    r_buf, rts_buf = a["r_buf"].copy(), a["rts_buf"].copy()
    ptr, rptr = a["ptr"].copy(), a["rptr"].copy()
    for k in range(KK):
        for r in range(min(C, int(a["nc"][k]))):
            ch = choices[k, r]
            lat_buf[k, ch, ptr[k, ch]], ts_buf[k, ch, ptr[k, ch]] = lats[k, r], t
            ptr[k, ch] = (ptr[k, ch] + 1) % R
            r_buf[k, rptr[k]] = f32(1.0) if lats[k, r] <= f32(tau) else f32(0.0)
            rts_buf[k, rptr[k]] = t
            rptr[k] = (rptr[k] + 1) % Rq
    arrivals = np.zeros((S, M), f32)
    for r in range(C):
        arrivals = arrivals + ws[r]
    return ref.RoundStepOut(w, cw, err, cd, pool, lat_buf, ts_buf, ptr, r_buf,
                            rts_buf, rptr, q_blocks[0], arrivals, choices,
                            lats, procs)


@pytest.mark.parametrize("S,K,ctas_per_sm,sms", [(3, 9, 1, 2), (4, 30, 2, 4)])
def test_round_kernel_lane_schedule_is_bit_exact(S, K, ctas_per_sm, sms):
    # (3, 9) on 2 CTAs: a block holds players of several lanes and warps
    # loop over players; (4, 30) on 8 CTAs: lanes straddle blocks
    args = lane_round_inputs(S, K, 6, seed=10 + S)
    want = ref.round_step_swrr(**{k: T(v) if k != "t" else v
                                  for k, v in args.items()}, **ROUND_KW)
    got = _blocked_lanes(args, S=S, warps=tround.WARPS,
                         ctas_per_sm=ctas_per_sm, sms=sms, **ROUND_KW)
    for name in ref.RoundStepOut._fields:
        a, b = getattr(want, name).numpy(), np.asarray(getattr(got, name))
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(b.view(np.uint8), a.view(np.uint8),
                                      err_msg=name)


def test_round_kernel_lane_sizes():
    # every lane's queue, arrivals, s_m, served and liveness rows in each
    # CTA's shared memory; the workspace's rounds are (S, M)
    for S in (1, 3, 4, 16):
        assert tround._smem_bytes(50, 8, 8, S) == \
            tround._smem_bytes(50, 8, 8) + (S - 1) * (16 * 52 + 64)
        assert tround._smem_bytes(10, 8, 8, S) % 16 == 0
        assert tround._workspace_words(8, 50, S) == 32 + 8 * S * 50
    assert tround._smem_bytes(10, 8, 8, 4) == 4 * (16 * 12 + 16) + 8 * (
        24 * 12 + 4 * 8 + 16 + 16)
    assert tround._warps(50, 8, 4) == tround.WARPS
    with pytest.raises(ValueError, match="S=2000 lanes"):
        tround._warps(50, 8, 2000)


def test_round_kernel_wrapper_refuses_host_lanes(monkeypatch):
    monkeypatch.setattr(tround, "_launcher", lambda: None)
    args = lane_round_inputs(3, 4, 5)
    ins = {k: T(v) if k != "t" else v for k, v in args.items()}
    with pytest.raises(ValueError, match="CUDA"):
        tround.round_step_swrr(**ins, **ROUND_KW)


# ---------------------------------------------------------------------------
# Placement events per lane.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lane_state():
    """A mid-run state of 3 lanes of 6 players, and each lane alone."""
    S, K, M = 3, 6, 5
    p = tb.BanditParams()
    active = torch.ones(S, M, dtype=torch.bool)
    keys = torch.stack([prand.prng_key(s) for s in range(S)])
    pids = torch.arange(K, dtype=torch.int32)
    st = tb.init_state(S * K, M, p, 8, 16, active, key=keys, pids=pids)
    rng = np.random.default_rng(3)
    w = rng.uniform(size=(S * K, M)).astype(np.float32)
    st = st._replace(weights=T(w / w.sum(-1, keepdims=True)),
                     lat_buf=T(rng.uniform(0, 0.1, (S * K, M, 8))
                               .astype(np.float32)))
    alone = [tb.init_state(K, M, p, 8, 16, active[s], key=keys[s], pids=pids)
             ._replace(weights=st.weights[s * K:(s + 1) * K],
                       lat_buf=st.lat_buf[s * K:(s + 1) * K])
             for s in range(S)]
    return p, S, K, st, alone


def assert_lane(st, one, s, K):
    for f in st._fields:
        got = getattr(st, f)
        got = got[s] if f == "active" else got[s * K:(s + 1) * K]
        assert torch.equal(got, getattr(one, f)), (s, f)


def test_init_state_lanes_equal_single_lanes(lane_state):
    p, S, K, st, alone = lane_state
    for s in range(S):
        assert_lane(st, alone[s], s, K)


def test_sync_active_moves_only_the_lanes_that_changed(lane_state):
    p, S, K, st, alone = lane_state
    new = st.active.clone()
    new[1, 2] = False                   # lane 1 loses an instance
    got = tb.sync_active(st, p, new)
    assert_lane(got, tb.sync_active(alone[1], p, new[1]), 1, K)
    for s in (0, 2):                    # untouched: bit for bit as before
        assert_lane(got, alone[s], s, K)


def test_instance_events_in_one_lane(lane_state):
    p, S, K, st, alone = lane_state
    got = tb.instance_removed(st, 3, lane=2)
    assert_lane(got, tb.instance_removed(alone[2], 3), 2, K)
    for s in (0, 1):
        assert_lane(got, alone[s], s, K)
    back = tb.instance_added(got, p, 3, None, 1.0, lane=2)
    assert_lane(back, tb.instance_added(tb.instance_removed(alone[2], 3), p,
                                        3, None, 1.0), 2, K)
    with pytest.raises(ValueError, match="lane"):
        tb.instance_removed(st, 3)


# ---------------------------------------------------------------------------
# Lanes against single runs, inside the port.
# ---------------------------------------------------------------------------

SMALL = dict(K=12, M=5, horizon=4.0, warm=5)


@pytest.fixture(scope="module")
def small_lanes():
    """Three distinct scenarios, topologies and keys at 12 x 5."""
    K, M, hz = SMALL["K"], SMALL["M"], SMALL["horizon"]
    cfg = ts.SimConfig(horizon=hz)
    lib = tlib.get_library(hz, K, M)
    drivers = [tscn.compile_scenario(lib[n], cfg, 500 + i, device="cpu")
               for i, n in enumerate(SCENARIOS)]
    rtts = torch.stack([ttopo.make_topology(s, K, M, device="cpu")
                        .lb_instance_rtt() for s in (1, 2, 3)])
    keys = torch.stack([prand.prng_key(11 + s) for s in range(3)])
    # the scenarios do what they say at this size
    assert (~drivers[0].active).any() and drivers[0].active[-1].all()
    assert (drivers[1].n_clients[-1] > drivers[1].n_clients[0]).any()
    assert (drivers[2].rtt_cut_k > 0).any()
    return drivers, rtts, keys


@pytest.mark.parametrize("label", list(STRATEGIES))
def test_lanes_equal_single_runs(label, small_lanes):
    drivers, rtts, keys = small_lanes
    name, kw, fused_round = STRATEGIES[label]
    cfg = ts.SimConfig(horizon=SMALL["horizon"], fused_round=fused_round)
    out = ts.run_sim_grid(name, rtts, cfg, keys,
                          drivers=tscn.stack_drivers(drivers),
                          warmup_steps=SMALL["warm"], device="cpu", **kw)
    assert out.series.succ.shape == (3, cfg.num_steps)
    for s in range(3):
        one = ts.run_sim_stream(name, rtts[s], cfg, keys[s],
                                drivers=drivers[s],
                                warmup_steps=SMALL["warm"], device="cpu",
                                **kw)
        lane = tm.lane(out, s)
        for part in ("acc", "series"):
            for f in getattr(one, part)._fields:
                assert torch.equal(getattr(getattr(lane, part), f),
                                   getattr(getattr(one, part), f)), \
                    (label, s, part, f)


def test_trace_lanes_equal_single_runs(small_lanes):
    drivers, rtts, keys = small_lanes
    cfg = ts.SimConfig(horizon=2.0)
    drv = [tscn.slice_drivers(d, 0, cfg.num_steps) for d in drivers]
    out = ts.run_sim_batch("qedgeproxy", rtts, cfg, keys,
                           drivers=tscn.stack_drivers(drv), device="cpu")
    for s in range(3):
        one = ts.run_sim("qedgeproxy", rtts[s], cfg, keys[s], drivers=drv[s],
                         device="cpu")
        for f in one._fields:
            assert torch.equal(getattr(out, f)[s], getattr(one, f)), (s, f)


def test_shared_drivers_broadcast_to_every_lane(small_lanes):
    _, rtts, keys = small_lanes
    cfg = ts.SimConfig(horizon=1.0)
    out = ts.run_sim_grid("proxy_mity", rtts, cfg, [1, 2, 3], device="cpu")
    for s in range(3):
        one = ts.run_sim_stream("proxy_mity", rtts[s], cfg, s + 1,
                                device="cpu")
        assert torch.equal(tm.lane(out, s).acc.choice_counts,
                           one.acc.choice_counts)
    with pytest.raises(ValueError, match="lanes"):
        ts.run_sim_grid("qedgeproxy", rtts, cfg, keys[:2], device="cpu")


def test_grid_meshes_beyond_one_device_raise(small_lanes):
    """A mesh of one rank runs the plain lanes; a mesh of more ranks
    needs the process group of exactly those ranks (``launch.mesh.spawn``
    starts them; ``tests/test_torch_sharded_grid.py`` runs it), and its
    players axis must split K."""
    _, rtts, keys = small_lanes
    cfg = ts.SimConfig(horizon=0.5)
    out = ts.run_sim_grid("qedgeproxy", rtts, cfg, keys,
                          mesh=make_grid_mesh(devices=1), device="cpu")
    assert out.acc.n_kc.shape[0] == 3
    with pytest.raises(ValueError, match="process group"):
        ts.run_sim_grid("qedgeproxy", rtts, cfg, keys,
                        mesh=make_grid_mesh(devices=2), device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        ts.run_sim_grid("qedgeproxy", rtts, cfg, keys, device="cpu",
                        mesh=make_continuum_mesh(players=rtts.shape[1] + 1,
                                                 devices=rtts.shape[1] + 1))


# ---------------------------------------------------------------------------
# Lanes against the JAX package.
# ---------------------------------------------------------------------------

def test_key_batches_draw_what_each_key_draws_alone():
    keys = torch.stack([prand.prng_key(s) for s in (0, 5, 9)])
    pids = torch.arange(7, dtype=torch.int32)
    for fn, args in ((prand.split, (3,)), (prand.fold_in, (4,)),
                     (prand.player_normal, (pids,)),
                     (prand.player_uniform, (pids,)),
                     (prand.player_uniform_row, (pids, 5)),
                     (prand.player_gumbel, (pids, 5))):
        batch = fn(keys, *args)
        for s in range(3):
            assert torch.equal(batch[s], fn(keys[s], *args)), fn.__name__
    rounds = ts._round_keys(keys, 8)
    for s in range(3):
        assert torch.equal(rounds[s], ts._round_keys(keys[s:s + 1], 8)[0])
        want = jax.vmap(lambda r, k=s: jax.random.split(jax.random.fold_in(
            jax.random.PRNGKey([0, 5, 9][k]), r)))(jnp.arange(8))
        np.testing.assert_array_equal(
            rounds[s].numpy(), np.asarray(want).astype(np.int64))


def test_stagger_tables_per_lane_match_the_reference():
    keys = [3, 8, 21]
    got = ts._stagger_groups(torch.stack([prand.prng_key(k) for k in keys]),
                             37, 10, 4, 0, 37)
    for s, k in enumerate(keys):
        want = js._stagger_groups(jax.random.PRNGKey(k), 37, 10, 4, 0, 37)
        np.testing.assert_array_equal(got[s].numpy(), np.asarray(want))


def grid_inputs():
    """The grid's JAX inputs at 30 x 10: the three scenarios compiled at
    keys 500 + i, topologies 1-3, run keys 20-22."""
    jcfg = js.SimConfig(horizon=GRID["horizon"])
    K, M = GRID["K"], GRID["M"]
    jl = jlib.get_library(jcfg.horizon, K, M)
    jdrv = jscn.stack_drivers([jscn.compile_scenario(
        jl[n], jcfg, jax.random.PRNGKey(500 + i))
        for i, n in enumerate(SCENARIOS)])
    rtts = jnp.stack([jtopo.make_topology(jax.random.PRNGKey(s), K, M)
                      .lb_instance_rtt() for s in (1, 2, 3)])
    jkeys = jnp.stack([jax.random.PRNGKey(20 + s) for s in range(3)])
    return jcfg, jdrv, rtts, jkeys


@pytest.mark.parametrize("name,kw", [("qedgeproxy", {}),
                                     ("proxy_mity", dict(alpha=0.9))],
                         ids=["qedgeproxy", "proxy_mity"])
def test_grid_matches_the_reference_grid(name, kw):
    K, M, warm = GRID["K"], GRID["M"], GRID["warm"]
    jcfg, jdrv, rtts, jkeys = grid_inputs()
    tcfg = ts.SimConfig(horizon=jcfg.horizon)
    want = js.run_sim_grid(name, rtts, jcfg, jkeys, drivers=jdrv,
                           warmup_steps=warm, **kw)
    got = ts.run_sim_grid(
        name, np.asarray(rtts), tcfg,
        convert.key_to_torch(np.asarray(jkeys), "cpu"),
        drivers=convert.drivers_to_torch(jax.tree.map(np.asarray, jdrv),
                                         "cpu"),
        warmup_steps=warm, device="cpu", **kw)
    assert want.acc.succ_kc.shape[0] == 3
    assert_stream_equal(want, got)


def assert_stream_equal(want, got):
    """Every accumulator field and series value of the port's run equal
    to the reference's, float fields included."""
    for f in want.acc._fields:
        a, b = np.asarray(getattr(want.acc, f)), getattr(got.acc, f).numpy()
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    for f in want.series._fields:
        np.testing.assert_array_equal(getattr(got.series, f).numpy(),
                                      np.asarray(getattr(want.series, f)),
                                      err_msg=f)


def test_cascade_drift_is_not_the_bandwidth_rounding():
    """The grid's cascade lane, run alone, equals the reference's run
    alone in every field: the picks it once moved came from the plain
    maintenance's rounding (its KDE ``mu`` an ULP from XLA's), which now
    rounds as XLA:CPU does, the bandwidth's ``n ** -0.2`` taken from
    glibc's ``powf`` as the reference's compiler takes it."""
    jcfg, jdrv, rtts, jkeys = grid_inputs()
    tcfg = ts.SimConfig(horizon=jcfg.horizon)
    jd = jax.tree.map(lambda x: x[0], jdrv)
    want = js.run_sim_stream("qedgeproxy", rtts[0], jcfg, jkeys[0],
                             drivers=jd, warmup_steps=GRID["warm"])
    got = ts.run_sim_stream(
        "qedgeproxy", np.asarray(rtts[0]), tcfg,
        convert.key_to_torch(np.asarray(jkeys[0]), "cpu"),
        drivers=convert.drivers_to_torch(jax.tree.map(np.asarray, jd), "cpu"),
        warmup_steps=GRID["warm"], device="cpu")
    assert_stream_equal(want, got)
    table = ref._powf_table(jcfg.ring)
    assert np.array_equal(table[1:], np.asarray(
        jax.jit(lambda n: n ** -0.2)(np.arange(1, jcfg.ring + 1,
                                                dtype=np.float32))))
