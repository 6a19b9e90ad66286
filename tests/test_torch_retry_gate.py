"""Compare the graceful-degradation lane's retry counts of the JAX
package and the port on the CPU at one horizon.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/test_torch_retry_gate.py --horizon 60

Runs the lane's smoke probe (``retry_storm`` at 30 x 10, tau = 150 ms,
topology seed 1, compile key 600, run key 11, the first third of the
horizon as warm-up) under each named ``DEGRADE_POLICIES`` entry, once
in each package, as the suite runs its one lane. Prints each run's
``resilience_stats_stream`` and the first step at which the two
packages' per-step attempt counts part (``None``: never), then whether
``naive``'s retry rate is at least ``bounded``'s in each package (the
suite's gate). Like the parity tests, it imports both packages; its
test runs the comparison at a 3 s horizon, where every count must be
exact.
"""
import argparse
import contextlib
import dataclasses
import io
import json

import jax
import numpy as np

from benchmarks import scenario_suite as bsuite
from repro.continuum import library as jlib
from repro.continuum import metrics as jm
from repro.continuum import scenarios as jscn
from repro.continuum import simulator as js
from repro.continuum import topology as jtopo
from repro_torch import convert
from repro_torch.continuum import metrics as tm
from repro_torch.continuum import simulator as ts

K, M = 30, 10


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--horizon", type=float, default=60.0)
    ap.add_argument("--policies", nargs="+", default=["bounded", "naive"])
    args = ap.parse_args(argv)
    base = js.SimConfig(horizon=args.horizon, tau=bsuite.DEGRADE_TAU)
    warm = int(args.horizon / 3 / base.dt)
    sc = jlib.get_library(args.horizon, K, M)["retry_storm"]
    jdrv = jscn.compile_scenario(sc, base, jax.random.PRNGKey(600))
    rtt = jtopo.make_topology(jax.random.PRNGKey(1), K, M).lb_instance_rtt()
    key = jax.random.PRNGKey(11)
    tdrv = convert.drivers_to_torch(jax.tree.map(np.asarray, jdrv), "cpu")
    rates = {"jax": {}, "port": {}}
    for label in args.policies:
        knobs = dict(bsuite.DEGRADE_POLICIES)[label]
        want = js.run_sim_stream("qedgeproxy", rtt,
                                 dataclasses.replace(base, **knobs), key,
                                 drivers=jdrv, warmup_steps=warm)
        got = ts.run_sim_stream(
            "qedgeproxy", np.asarray(rtt),
            ts.SimConfig(horizon=args.horizon, tau=bsuite.DEGRADE_TAU,
                         **knobs),
            convert.key_to_torch(np.asarray(key), "cpu"), drivers=tdrv,
            warmup_steps=warm, device="cpu")
        a = np.asarray(want.series.attempts)
        b = got.series.attempts.numpy()
        part = np.flatnonzero(a != b)
        stats = {"jax": jm.resilience_stats_stream(want.acc),
                 "port": tm.resilience_stats_stream(got.acc)}
        for pkg in rates:
            rates[pkg][label] = stats[pkg]["retry_rate"]
        print(json.dumps({"policy": label, "horizon_s": args.horizon,
                          **stats,
                          "first_step_apart": (int(part[0]) if part.size
                                               else None)}), flush=True)
    if {"bounded", "naive"} <= set(args.policies):
        print(json.dumps({pkg: {"naive_ge_bounded": r["naive"]
                                >= r["bounded"], **r}
                          for pkg, r in rates.items()}))
    return 0


def test_the_comparison_is_exact_at_a_short_horizon():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(["--horizon", "3"]) == 0
    rows = [json.loads(line) for line in out.getvalue().splitlines()]
    assert [r["policy"] for r in rows[:2]] == ["bounded", "naive"]
    for r in rows[:2]:
        assert r["first_step_apart"] is None and r["jax"] == r["port"], r
        assert r["port"]["timeouts"] > 0
    assert rows[2]["jax"] == rows[2]["port"]


if __name__ == "__main__":
    raise SystemExit(main())
