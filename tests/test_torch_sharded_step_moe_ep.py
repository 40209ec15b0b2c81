"""The port's MoE layer under expert and tensor parallelism together,
held against the JAX package's sharded step: moe_debug at
``MeshSpec(data=2, expert=2, tensor=2)``, capacity factors 1.25 and 0.5.
Each rank holds two experts, each cut on ``mlp`` over tensor; the
expert outputs are summed over the (expert, tensor) group in one
all-reduce. The tests are tests/sharded_step_moe_cases.py's; one group
of 8 gloo ranks (tests/torch_ranks.py).
"""

import pytest

import sharded_step_ref as R
from sharded_step_moe_cases import *  # noqa: F401,F403  (the tests)

SPEC = {"data": 2, "expert": 2, "tensor": 2}


@pytest.fixture(params=list(R.CAPACITY))
def case(request):
    return request.param


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return R.moe_world(SPEC, tmp_path_factory.mktemp("ranks"))


def test_collectives_per_step(world, case):
    """moe_debug (no remat), U = 23: the design's count."""
    want = R.design_collectives(world["jax"][case]["tcfg"], 23, masked=False)
    assert all(r[case]["collectives"] == [want] * R.STEPS for r in world["ranks"])


def test_expert_leaves_cut_over_expert_and_tensor(world):
    for r in world["ranks"]:
        shapes = r["cf125"]["shapes"]["params"]
        assert shapes["blocks/wi_gate"] == (2, 2, 128, 128)
        assert shapes["blocks/wo_mlp"] == (2, 2, 128, 128)
        assert shapes["blocks/router"] == (2, 128, 4)
