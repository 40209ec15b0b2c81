"""The port's data-parallel train step (ray_tpu_torch.train under
``MeshSpec(data=8)``) held against the JAX package's step on the
8-device CPU mesh and against the port's single-device step: dense
``debug``, as tests/test_models_train.py's
test_parallelism_modes_agree[dp8] and test_loss_decreases_dp run it.

One of three files of the sharded step, split only to keep each under
20 s (tests/test_torch_sharded_step.py: mixture of experts;
tests/test_torch_sharded_step_lora.py: LoRA); each runs one group of 8
gloo ranks (tests/torch_ranks.py). Tolerances: tests/sharded_step_ref.py.

Collectives per step of the design for a dense config with no
loss_mask: U all-reduces of the grads over the data group (U grad
tensors: one a leaf, a stacked leaf one a layer), one for the metrics
and one over the expert group for the norm; no gather.
"""

import pytest

import sharded_step_ref as R


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return R.dp_world("debug", {}, tmp_path_factory.mktemp("ranks"))


def test_ranks_import_no_jax(world):
    assert world["jax_imported"] == [[]] * R.WORLD


def test_losses_match_jax_sharded_step(world):
    R.check_metrics(world["ranks"], world["jax"]["metrics"])


def test_params_match_jax_sharded_step(world):
    """Every leaf is whole on every rank (nothing is cut over data)."""
    R.check_params(world["ranks"], world["jax"]["params"], R.whole)


def test_grads_match_single_device(world):
    R.check_grads(world["ranks"], world["jax"]["single"], R.whole)


def test_eval_step_matches_jax(world):
    R.check_eval(world["ranks"], world["jax"]["eval"])


def test_collectives_per_step(world):
    """debug: U = 21 (9 block leaves x 2 layers + embed, ln_f, unembed)."""
    want = {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 21 + 2}
    assert all(r["collectives"] == [want] * R.STEPS for r in world["ranks"])
