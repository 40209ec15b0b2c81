"""The port's MoE layer under the sequence axis, held against the JAX
package's sharded step: moe_debug at ``MeshSpec(data=2, sequence=4)``
(ring attention), capacity factors 1.25 and 0.5, with a loss_mask. The
token gather spans the sequence and batch groups, so routing and
capacity cover the global batch's 512 tokens and each rank takes its own
rows and sequence shard back. The tests are
tests/sharded_step_moe_cases.py's (one file a mesh, to keep each under
20 s: _moe_tp.py fsdp=4 x tensor=2, _moe_ep.py data=2 x expert=2 x
tensor=2, _moe_pp.py and _moe_pp05.py data=2 x stage=2 x expert=2); one
group of 8 gloo ranks (tests/torch_ranks.py).
"""

import numpy as np
import pytest

import sharded_step_ref as R
from sharded_step_moe_cases import *  # noqa: F401,F403  (the tests)

SPEC = {"data": 2, "sequence": 4}


def _mask(b=8, s=64):
    """Uneven across the sequence shards (16 positions each) and the data
    shards."""
    mask = np.ones((b, s), np.float32)
    mask[: b // 2, 24:] = 0
    mask[b // 2:, 40:50] = 0
    return mask


@pytest.fixture(params=list(R.CAPACITY))
def case(request):
    return request.param


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return R.moe_world(SPEC, tmp_path_factory.mktemp("ranks"), mask=_mask())


def test_collectives_per_step(world, case):
    """moe_debug (no remat), U = 23, masked; the ring's sends over 4 ranks."""
    want = R.design_collectives(world["jax"][case]["tcfg"], 23, masked=True,
                                n_seq=SPEC["sequence"])
    assert all(r[case]["collectives"] == [want] * R.STEPS for r in world["ranks"])
