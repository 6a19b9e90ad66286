"""Player sharding under the request lifecycle, the control plane, the
flight recorder and tenants: ``run_sim_players`` on gloo ranks against
the JAX package's unsharded ``run_sim_stream``, live, on the CPU (the
cases and checks of ``tests/test_torch_sharded_players.py``).

* A resilient run that trips timeouts (``hetero_slowdown``, timeout
  55 ms, two retries, breakers), under each strategy: the retries fold
  into the round's one all-reduce, and attempts, timeouts, drops and
  open breakers per player are exact.
* A closed-loop run that sheds (``metastable_overload`` with two
  standby instances): every control counter exact, the step
  observation summed over the shards.
* The flight recorder: one ring a shard, fleet events on the shard that
  holds player 0; the decoded events equal the reference's.
* Two tenants (``mt_tenant_surge``): the (S, NT, M) arrivals cross the
  shards in one all-reduce a round.
"""
import pytest

from test_torch_sharded_players import CASES, check_case, sharded_runs

HERE = [n for n in CASES if CASES[n]["kind"] is not None]


@pytest.fixture(scope="module")
def sharded():
    return sharded_runs(HERE)


@pytest.mark.parametrize("name", HERE)
def test_sharded_lifecycle_matches_the_reference(sharded, name):
    check_case(sharded, name)
