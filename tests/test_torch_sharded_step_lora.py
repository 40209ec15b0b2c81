"""The port's data-parallel LoRA train step (``tiny`` with rank-8
adapters under ``MeshSpec(data=8)``) held against the JAX package's step
on the 8-device CPU mesh and against the port's single-device step, as
tests/test_models_train.py's test_lora_only_adapters_move runs it: the
frozen base bit-unchanged, every adapter moved, the numbers JAX's.

One of three files of the sharded step (see
tests/test_torch_sharded_step_dp.py); one group of 8 gloo ranks
(tests/torch_ranks.py). Tolerances: tests/sharded_step_ref.py.
"""

import pytest

import sharded_step_ref as R


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    # the eval step and the grads against the single-device step are held
    # in tests/test_torch_sharded_step_dp.py, at less cost
    return R.dp_world("tiny", {"lora_rank": 8}, tmp_path_factory.mktemp("ranks"),
                      references=False)


def test_ranks_import_no_jax(world):
    assert world["jax_imported"] == [[]] * R.WORLD


def test_losses_match_jax_sharded_step(world):
    R.check_metrics(world["ranks"], world["jax"]["metrics"])


def test_params_match_jax_sharded_step(world):
    R.check_params(world["ranks"], world["jax"]["params"], R.whole)


def test_lora_only_adapters_move(world):
    """The frozen base bit-unchanged after the steps on every rank, every
    adapter moved in every layer."""
    params0 = world["jax"]["params0"]
    for r in world["ranks"]:
        frozen = r["frozen_unchanged"]
        assert frozen and all(frozen.values()), frozen
        for path, a in R.items(r["params"]["lora"], "lora/"):
            assert (a != params0[path]).reshape(a.shape[0], -1).any(1).all(), path


def test_collectives_per_step(world):
    """tiny with LoRA: U = 63 (9 block and 6 adapter leaves x 4 layers +
    embed, ln_f, unembed); frozen leaves' grads are summed too."""
    want = {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 63 + 2}
    assert all(r["collectives"] == [want] * R.STEPS for r in world["ranks"])
