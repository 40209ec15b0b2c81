"""The port's MoE layer under the pipeline, held against the JAX
package's pipelined step: moe_debug at ``MeshSpec(data=2, stage=2,
expert=2)``, 2 microbatches, capacity factor 1.25 (0.5, with forced
drops, in tests/test_torch_sharded_step_moe_pp05.py: one capacity factor
a file, since JAX compiles each pipelined step in ~7 s here). Inside a
stage the MoE layer routes each global microbatch on its own (its
capacity from the microbatch's 256 tokens), as JAX's does, so the loss
differs from the unpipelined step's; each rank holds its share of every
microbatch's rows (``shard_batch``), gathered over the data group in
the global order. make_eval_step runs the whole batch as one
microbatch, as JAX's unpipelined eval step routes it. The tests are
tests/sharded_step_moe_cases.py's and the two below; one group of 8
gloo ranks (tests/torch_ranks.py).
"""

import pytest

import sharded_step_ref as R
from sharded_step_moe_cases import *  # noqa: F401,F403  (the tests)

SPEC = {"data": 2, "stage": 2, "expert": 2}
M = 2
CASES = ("cf125",)


@pytest.fixture(params=CASES)
def case(request):
    return request.param


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return R.moe_world(SPEC, tmp_path_factory.mktemp("ranks"), num_microbatches=M, cases=CASES)


def test_microbatch_routing_moves_the_loss(world, case):
    """The pipelined loss is JAX's pipelined loss, not the unpipelined
    one: routing per microbatch drops other entries (JAX: -0.0022 at
    capacity factor 1.25, +0.0051 at 0.5; tests/pipeline_numbers.py)."""
    got = world["ranks"][0][case]["grad_metrics"]["loss"]
    whole = world["jax"][case]["single"]["metrics"]["loss"]
    assert abs(got - world["jax"][case]["metrics"][0]["loss"]) <= R.ATOL
    assert abs(got - whole) > 1e-3
    assert all(r["capacity"] == max(4, int(R.CAPACITY[case] * 256 * 2 / 4))
               for r in world["ranks"][0][case]["routing"])


def test_sends_per_step(world, case):
    """M sends a rank a step: the first stage's outputs, the second's
    input grads."""
    for r in world["ranks"]:
        assert [c["send"] for c in r[case]["collectives"]] == [M] * R.STEPS
