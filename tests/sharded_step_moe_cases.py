"""The tests of the port's MoE layer under a mesh axis it took with the
pipeline slice (ray_tpu_torch/models/transformer.py ``_moe_mlp``), shared
by tests/test_torch_sharded_step_moe*.py: each of those files defines
the ``world`` fixture (``sharded_step_ref.moe_world`` at its mesh) and
the ``case`` fixture (the names of ``sharded_step_ref.CAPACITY`` it
runs) and imports these, so pytest collects them there. moe_debug at fp32,
capacity factors 1.25 and 0.5 (forced drops), 3 steps, held against the
JAX package's sharded step (pipelined under stage) and the port's
single-device step on the global batch (under stage: the port's
pipeline run in one process, whose MoE layers route each microbatch on
its own, as JAX's do). Tolerances: tests/sharded_step_ref.py.
"""

import numpy as np
import pytest

import sharded_step_ref as R



def _case(world, name):
    return [r[name] for r in world["ranks"]]


def _staged(world):
    return world["spec"].get("stage", 1) > 1


def _reference(world, case):
    """The port's single-device run the ranks' grads and routing equal:
    unpipelined, or under stage the pipeline run in one process."""
    return world["jax"][case]["staged" if _staged(world) else "single"]


def test_ranks_import_no_jax(world):
    assert all(r["jax_imported"] == [] for r in world["ranks"])


def test_losses_match_jax_sharded_step(world, case):
    """Each of 3 steps' loss, accuracy, grad_norm and tokens on every rank:
    JAX's sharded step's (2e-5)."""
    R.check_metrics(_case(world, case), world["jax"][case]["metrics"])


def test_params_match_after_steps(world, case):
    """Each rank's params after the steps: its shard of JAX's (under
    stage, of the port's pipeline in one process: see
    sharded_step_ref.port_steps)."""
    ref = (world["jax"][case]["staged_steps"] if _staged(world) else world["jax"][case])
    R.check_params_of_leaves(_case(world, case), ref["params"],
                             R.mesh_shard(world["jax"][case]["tcfg"], world["spec"]))


def test_grads_match_single_device(world, case):
    """Every rank's grads of the global loss: its shard of the
    single-device grads (5e-5, and 1e-4 of each leaf's largest)."""
    R.check_grads_scaled(_case(world, case), _reference(world, case),
                         R.mesh_shard(world["jax"][case]["tcfg"], world["spec"]))


def test_eval_step_matches_jax(world, case):
    """make_eval_step's metrics: JAX's eval step's under stage (the whole
    batch one microbatch, as JAX's eval runs unpipelined), else JAX's step
    0's (the same params, the same routing)."""
    ref = world["jax"][case]
    want = ref["eval"] if _staged(world) else {
        k: ref["metrics"][0][k] for k in ("loss", "accuracy", "tokens")}
    R.check_eval(_case(world, case), want)


def test_routing_matches_single_device(world, case):
    """Each MoE layer's routing (gate_idx, slot, keep, capacity) on every
    rank is the single-device run's: the routing group is the global
    batch (under stage, each global microbatch: a stage's ranks route
    its layer's microbatches in order); at capacity factor 0.5 entries
    are dropped."""
    ref = _reference(world, case)["routing"]
    if case == "cf05":
        assert not all(r["keep"].all() for r in ref)
    spec = world["spec"]
    n_stage = spec.get("stage", 1)
    per = len(ref) // n_stage
    for rank, got in enumerate(_case(world, case)):
        stage = rank // (spec.get("expert", 1) * spec.get("sequence", 1)
                         * spec.get("tensor", 1)) % n_stage
        want = ref[stage * per:(stage + 1) * per]
        assert len(got["routing"]) == len(want) > 0
        for i, (a, b) in enumerate(zip(got["routing"], want)):
            assert a["capacity"] == b["capacity"]
            for f in ("gate_idx", "slot", "keep"):
                np.testing.assert_array_equal(a[f], b[f], err_msg=f"rank {rank} call {i} {f}")
