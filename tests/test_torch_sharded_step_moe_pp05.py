"""tests/test_torch_sharded_step_moe_pp.py at capacity factor 0.5
(forced drops): moe_debug at ``MeshSpec(data=2, stage=2, expert=2)``, 2
microbatches, against the JAX package's pipelined step; the same tests,
in a file of their own to keep each under 20 s; one group of 8 gloo
ranks (tests/torch_ranks.py).
"""

import pytest

import sharded_step_ref as R
from test_torch_sharded_step_moe_pp import *  # noqa: F401,F403  (the tests)
from test_torch_sharded_step_moe_pp import M, SPEC

CASES = ("cf05",)


@pytest.fixture(params=CASES)
def case(request):
    return request.param


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return R.moe_world(SPEC, tmp_path_factory.mktemp("ranks"), num_microbatches=M, cases=CASES)
