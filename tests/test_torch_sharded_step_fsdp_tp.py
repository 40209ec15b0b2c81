"""The port's sharded train step under FSDP and tensor parallelism held
against the JAX package's sharded step on the 8-device CPU mesh and
against the port's single-device step:

- ``fsdp4xtp2`` (``MeshSpec(fsdp=4, tensor=2)``, dense ``debug``,
  test_parallelism_modes_agree[fsdp4xtp2]): FSDP gathers and Megatron
  cuts, the vocab-parallel embedding and loss;
- ``tiny`` + LoRA at fsdp4xtp2: the grads of the port's single-device
  step, the frozen base bit-unchanged (from the port's own init: JAX's
  LoRA step is held at data=8 in tests/test_torch_sharded_step_lora.py,
  and the single-device LoRA grads against JAX's in
  tests/test_torch_loss.py).

One of two files of the new layouts (see
tests/test_torch_sharded_step_modes.py: dp2xsp4, fsdp8); one group of 8
gloo ranks (tests/torch_ranks.py). Tolerances:
tests/sharded_step_ref.py. Collectives per step: ``design_collectives``
there.
"""

import pytest

import sharded_step_ref as R
import torch_ranks
from ray_tpu.parallel.mesh import MeshSpec, build_mesh
from ray_tpu.train import step as JS

SPEC = {"fsdp": 4, "tensor": 2}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The ranks' results from one spawn group (spawned first, so they
    start up while JAX compiles), JAX's sharded runs and the port's
    single-device references."""
    world = torch_ranks.World(R.WORLD, tmp_path_factory.mktemp("ranks"))
    try:
        jcfg, tcfg = R.configs("debug")
        _, tlora = R.configs("tiny", lora_rank=8)
        toks, lora_toks = R.tokens(jcfg.vocab_size), R.tokens(tlora.vocab_size)
        mesh = build_mesh(MeshSpec(**SPEC))
        jstate = JS.init_state(jcfg, JS.default_optimizer(jcfg, lr=R.LR), mesh, seed=0)
        state0, lora0 = R.np_state(jstate), R.port_np_state(tlora)
        world.send({
            "tp": ("train", dict(preset="debug", overrides={}, spec=SPEC, state=state0,
                                 tokens=toks, steps=R.STEPS)),
            "lora": ("train", dict(preset="tiny", overrides={"lora_rank": 8}, spec=SPEC,
                                   state=lora0, tokens=lora_toks, steps=R.STEPS)),
        })
        ref = R.jax_run(jcfg, mesh, jstate, {"tokens": toks})
        single = R.single_device(tcfg, state0["params"], {"tokens": toks})
        single_lora = R.single_device(tlora, lora0["params"], {"tokens": lora_toks})
        return {"ranks": world.results(), "jax": ref, "single": single, "tcfg": tcfg,
                "tlora": tlora, "single_lora": single_lora, "lora0": lora0}
    finally:
        world.stop()


def _case(world, name):
    return [r[name] for r in world["ranks"]]


def test_ranks_import_no_jax(world):
    assert all(r["jax_imported"] == [] for r in world["ranks"])


def test_losses_match_jax_sharded_step(world):
    R.check_metrics(_case(world, "tp"), world["jax"]["metrics"])


def test_params_match_jax_sharded_step(world):
    """Each rank's params after the steps: its shard of JAX's."""
    R.check_params_of_leaves(_case(world, "tp"), world["jax"]["params"],
                             R.mesh_shard(world["tcfg"], SPEC))


def test_grads_match_single_device(world):
    """Every rank's grads of the global loss: its shard of the
    single-device grads (5e-5, and 1e-4 of each leaf's largest grad)."""
    R.check_grads_scaled(_case(world, "tp"), world["single"], R.mesh_shard(world["tcfg"], SPEC))


def test_eval_step_matches_jax(world):
    R.check_eval(_case(world, "tp"), world["jax"]["eval"])


def test_state_is_cut_over_fsdp_and_tensor(world):
    """Every leaf and both moments hold this rank's shard: ``embed``
    (vocab, embed) 1/2 x 1/4, ``wq`` (embed, heads) 1/4 x 1/2, ``wo_mlp``
    (mlp, embed) 1/2 x 1/4; JAX shards embed over (tensor, fsdp) too."""
    for r in _case(world, "tp"):
        for tree in ("params", "mu", "nu"):
            assert r["shapes"][tree]["embed"] == (256, 32)
            assert r["shapes"][tree]["blocks/wq"] == (2, 32, 2, 32)
            assert r["shapes"][tree]["blocks/wo_mlp"] == (2, 176, 32)
    assert tuple(world["jax"]["state"]["params"]["embed"].sharding.spec) == ("tensor", "fsdp")


def test_lora_only_adapters_move(world):
    """tiny + LoRA: every rank's grads are its shard of the single-device
    grads; over 3 steps the loss falls, the frozen base stays
    bit-unchanged on every rank and every adapter moves in every layer."""
    ranks = _case(world, "lora")
    shard = R.mesh_shard(world["tlora"], SPEC)
    R.check_grads_scaled(ranks, world["single_lora"], shard)
    params0 = dict(R.items(world["lora0"]["params"]))
    for rank, r in enumerate(ranks):
        assert r["metrics"][-1]["loss"] < r["metrics"][0]["loss"]
        frozen = r["frozen_unchanged"]
        assert frozen and all(frozen.values()), frozen
        for path, a in R.items(r["params"]["lora"], "lora/"):
            before = shard(path, params0[path], rank)
            assert (a != before).reshape(a.shape[0], -1).any(1).all(), path


@pytest.mark.parametrize("case,cfg,units", [("tp", "tcfg", 21), ("lora", "tlora", 63)])
def test_collectives_per_step(world, case, cfg, units):
    """The design's count: debug (no remat) U = 21; tiny + LoRA (remat)
    U = 63."""
    want = R.design_collectives(world[cfg], units, masked=False)
    assert all(r["collectives"] == [want] * R.STEPS for r in _case(world, case))
