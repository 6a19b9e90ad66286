"""The port's serving layer on the CPU against the JAX package: greedy
generation, the engine, the QEdgeProxy replica router, and the serve
launcher end to end.

Both routers run on one virtual clock (``_now`` patched) and take the
same latency feed, so their bandit states see the same inputs. Choices,
the membership ``events`` and greedy tokens must match exactly; router
weights and QoS estimates to ``rtol=1e-5`` (XLA reassociates the
maintenance window sums). The JAX decode is held to its naive path
(``REPRO_DECODE_IMPL=naive``), which scales q in float32 as the port does.
"""
import contextlib
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import BanditParams as JaxBanditParams
from repro.models import build_model as jax_build
from repro.serving import QEdgeRouter as JaxRouter
from repro.serving import generate as jax_generate
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.convert import model_params_to_torch
from repro_torch.core import BanditParams
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.serving import QEdgeRouter, ServingEngine, generate

RTOL = 1e-5


@pytest.fixture(autouse=True)
def naive_decode(monkeypatch):
    monkeypatch.setenv("REPRO_DECODE_IMPL", "naive")


def f32_pair():
    jcfg = dataclasses.replace(jax_config("qwen3-4b", reduced=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("qwen3-4b", reduced=True),
                              dtype="float32")
    jm = jax_build(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    return jm, params, model_params_to_torch(jax.tree.map(np.asarray, params),
                                             cfg, "cpu")


# ---------------------------------------------------------------------------
# Generation and the engine.
# ---------------------------------------------------------------------------

def test_greedy_generate_matches_the_reference():
    jm, params, tm = f32_pair()
    prompt = np.random.default_rng(1).integers(0, 256, (2, 8)).astype(np.int32)
    want = jax_generate(jm, params, jnp.asarray(prompt), steps=6)
    got = generate(tm, torch.from_numpy(prompt).long(), steps=6)
    assert got.dtype == torch.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampled_generate_follows_its_generator():
    model = build_model(get_config("qwen3-4b", reduced=True), device="cpu")
    prompt = torch.randint(0, 256, (2, 8),
                           generator=torch.Generator().manual_seed(5))
    runs = [generate(model, prompt, steps=5, greedy=False,
                     generator=torch.Generator().manual_seed(s))
            for s in (7, 7, 8)]
    assert torch.equal(runs[0], runs[1])
    assert all(((r >= 0) & (r < 256)).all() for r in runs)
    greedy = generate(model, prompt, steps=5)
    assert torch.equal(greedy, generate(model, prompt, steps=5, greedy=False))


def test_engine_times_prefill_and_decode():
    model = build_model(get_config("qwen3-4b", reduced=True), device="cpu")
    eng = ServingEngine(model, max_len=12, extra_latency=0.25)
    logits, cache, lat = eng.prefill({"tokens": torch.zeros(2, 8,
                                                            dtype=torch.long)})
    assert logits.shape == (2, 1, 256) and lat >= 0.25
    assert cache["layers"][0].shape[3] == 12
    tok = torch.zeros(2, 1, dtype=torch.int32)
    logits, cache, lat = eng.decode(cache, tok, 8)
    assert logits.shape == (2, 1, 256) and lat >= 0.25
    assert cache["layers"][0][:, :, :, 8].any()     # slot 8 now written


# ---------------------------------------------------------------------------
# The router.
# ---------------------------------------------------------------------------

def drive(router, steps, clock, rng, slow=1, events=()):
    """Route, feed latencies (the slow replica 0.5 s, others 10-50 ms),
    run maintenance every 10 steps; membership events at given steps.
    Returns the choices of every step."""
    chosen = []
    for step in range(steps):
        for at, kind, idx in events:
            if at == step:
                getattr(router, kind)(idx)
        choices = np.asarray(router.route())
        chosen.append(choices)
        lat = np.where(choices == slow, 0.5,
                       rng.uniform(0.01, 0.05, choices.shape))
        router.feedback(choices, lat.astype(np.float32))
        if step % 10 == 9:
            router.maintenance()
        clock[0] += 0.05
    return np.stack(chosen)


def test_router_matches_the_reference_on_one_clock():
    kw = dict(tau=0.1, rho=0.9, window=5.0, cooldown=2.0)
    jr = JaxRouter(4, 3, JaxBanditParams(**kw), seed=3)
    tr = QEdgeRouter(4, 3, BanditParams(**kw), seed=3, device="cpu")
    clocks = {}
    for name, r in (("jax", jr), ("port", tr)):
        clocks[name] = [0.0]
        r._now = (lambda c: lambda: c[0])(clocks[name])
    events = ((60, "replica_failed", 2), (90, "replica_joined", 2))
    want = drive(jr, 150, clocks["jax"], np.random.default_rng(0),
                 events=events)
    got = drive(tr, 150, clocks["port"], np.random.default_rng(0),
                events=events)
    np.testing.assert_array_equal(got, want)
    assert tr.events == jr.events and len(tr.events) == 4
    np.testing.assert_allclose(tr.weights, jr.weights, rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(tr.qos_estimates, jr.qos_estimates, rtol=RTOL,
                               atol=1e-7)
    np.testing.assert_array_equal(tr.in_cooldown(), jr.in_cooldown())
    assert (want[60:90] != 2).all()                 # the failed replica idles


def test_router_learns_to_avoid_slow_replica():
    """tests/test_serving.py's straggler check on the port (virtual time)."""
    router = QEdgeRouter(
        2, 3, BanditParams(tau=0.1, rho=0.9, window=5.0, cooldown=2.0),
        seed=0, device="cpu")
    clock = [0.0]
    router._now = lambda: clock[0]
    chosen = drive(router, 400, clock, np.random.default_rng(0))
    slow_share = (chosen[200:] == 1).mean()
    assert router.qos_estimates[:, 1].max() < 0.05
    assert slow_share < 0.15, slow_share


def test_router_failover_and_rejoin():
    router = QEdgeRouter(2, 3, BanditParams(), seed=1, device="cpu")
    router.replica_failed(2)
    w = router.weights
    assert np.abs(w[:, 2]).max() == 0.0
    np.testing.assert_allclose(w.sum(-1), 1.0, atol=1e-5)
    router.replica_joined(2)
    assert bool(router.state.active[2])
    assert np.abs(router.weights[:, 2]).max() == 0.0    # Alg 3 zero ramp
    assert [e[1] for e in router.events] == [
        "replica_failed", "replicas_changed", "replica_joined",
        "replicas_changed"]


def test_router_hooks_of_unported_layers_raise():
    # every hook is ported now: mesh_resized masks the replicas past the
    # surviving rows (tests/test_torch_elastic.py holds it to the reference)
    router = QEdgeRouter(2, 3, device="cpu")
    router.mesh_resized(2)
    assert router.state.active.tolist() == [True, True, False]
    assert [e[1] for e in router.events] == ["mesh_resized",
                                             "replicas_changed"]


# ---------------------------------------------------------------------------
# The launcher.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_serve_runs_to_the_end_on_the_cpu(arch):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        router = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                             "--requests", "6", "--frontends", "3",
                             "--batch", "2", "--prompt-len", "12",
                             "--decode-steps", "3", "--slow-replica", "2"])
    assert isinstance(router, QEdgeRouter) and router.weights.shape == (3, 3)
    report = json.loads(out.getvalue().strip().splitlines()[-1])
    assert report["arch"] == f"{arch}-smoke" and report["device"] == "cpu"
    assert report["microbatches"] == report["prefills"] == 18
    assert report["decodes"] == 18 * 3 == len(report["decode_s"])
    assert report["logits_finite"] and report["maintenance_calls"] >= 1
    assert 0 <= report["qos_ok"] <= 18


def test_serve_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--smoke", "--requests", "1"])
