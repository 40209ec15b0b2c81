"""The port's MoE layer under FSDP and tensor parallelism, held against
the JAX package's sharded step: moe_debug at ``MeshSpec(fsdp=4,
tensor=2)``, capacity factors 1.25 and 0.5. The expert leaves are
gathered over fsdp (in the remat re-run too) and reduce-scattered in the
backward; ``wi_gate``/``wi_up`` are cut on ``mlp`` over tensor
(column-parallel) and ``wo_mlp`` on its input (row-parallel), the expert
outputs summed over (expert, tensor); the router stays whole. The tests
are tests/sharded_step_moe_cases.py's; one group of 8 gloo ranks
(tests/torch_ranks.py).
"""

import pytest

import sharded_step_ref as R
from sharded_step_moe_cases import *  # noqa: F401,F403  (the tests)

SPEC = {"fsdp": 4, "tensor": 2}


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


def test_expert_leaves_cut_over_fsdp_and_tensor(world):
    """wi_gate [L, E, embed/4, mlp/2], wo_mlp [L, E, mlp/2, embed/4] and
    their moments; the router [L, embed/4, E] (cut over fsdp only)."""
    for r in world["ranks"]:
        for tree in ("params", "mu", "nu"):
            shapes = r["cf125"]["shapes"][tree]
            assert shapes["blocks/wi_gate"] == (2, 4, 32, 128)
            assert shapes["blocks/wo_mlp"] == (2, 4, 128, 32)
            assert shapes["blocks/router"] == (2, 32, 4)
