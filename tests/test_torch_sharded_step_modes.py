"""The port's sharded train step held against the JAX package's sharded
step on the 8-device CPU mesh and against the port's single-device
step, dense ``debug`` at two of tests/test_models_train.py's layouts:

- ``dp2xsp4`` (``MeshSpec(data=2, sequence=4)``,
  test_parallelism_modes_agree[dp2xsp4]): ring attention, a loss_mask
  uneven across the sequence shards;
- ``fsdp8`` (test_grad_accumulation_sharding_kept): after the steps each
  rank holds 1/8 of ``embed``'s embed dim;

and moe_debug from every entry point under the meshes the pipeline slice
brought (fsdp, tensor, sequence, stage, microbatches), running, and
under stage and sequence together, raising, naming its ROADMAP row.

One of two files of the new layouts, split only to keep each under 20 s
(tests/test_torch_sharded_step_fsdp_tp.py: fsdp4xtp2, LoRA); each runs
one group of 8 gloo ranks (tests/torch_ranks.py). Tolerances:
tests/sharded_step_ref.py. Collectives per step: ``design_collectives``
there.
"""

import jax
import numpy as np
import pytest

import sharded_step_ref as R
import torch_ranks
from ray_tpu.parallel.mesh import MeshSpec, build_mesh
from ray_tpu.train import step as JS

SPEC = {"data": 2, "sequence": 4}
FSDP8 = {"fsdp": 8}


def _mask(b=8, s=64):
    """Uneven across the four sequence shards (16 positions each) and the
    two data shards: rows 0-3 keep positions 0-23 (two shards, one in
    part), rows 4-7 keep all but 40-49."""
    mask = np.ones((b, s), np.float32)
    mask[: b // 2, 24:] = 0
    mask[b // 2:, 40:50] = 0
    return mask


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The ranks' results from one spawn group (spawned first, so they
    start up while JAX compiles), JAX's sharded run and the port's
    single-device references."""
    world = torch_ranks.World(R.WORLD, tmp_path_factory.mktemp("ranks"))
    try:
        jcfg, tcfg = R.configs("debug")
        batch = {"tokens": R.tokens(jcfg.vocab_size), "loss_mask": _mask()}
        opt = JS.default_optimizer(jcfg, lr=R.LR)
        mesh, mesh8 = build_mesh(MeshSpec(**SPEC)), build_mesh(MeshSpec(**FSDP8))
        jstate = JS.init_state(jcfg, opt, mesh, seed=0)
        # the same state laid out for fsdp=8 (no second init to compile)
        jstate8 = jax.device_put(jstate, JS.state_shardings(jcfg, opt, mesh8))
        state0 = R.np_state(jstate)
        world.send({
            "sp": ("train", dict(preset="debug", overrides={}, spec=SPEC, state=state0,
                                 tokens=batch["tokens"], mask=batch["loss_mask"],
                                 steps=R.STEPS)),
            "fsdp8": ("train", dict(preset="debug", overrides={}, spec=FSDP8, state=state0,
                                    tokens=batch["tokens"], steps=R.STEPS)),
            "unported": ("unported", dict(preset="moe_debug")),
        })
        plain = {"tokens": batch["tokens"]}
        ref = R.jax_run(jcfg, mesh, jstate, batch)
        ref["fsdp8"] = R.jax_run(jcfg, mesh8, jstate8, plain, with_eval=False)
        single = {"sp": R.single_device(tcfg, state0["params"], batch),
                  "fsdp8": R.single_device(tcfg, state0["params"], plain)}
        return {"ranks": world.results(), "jax": ref, "single": single, "tcfg": tcfg}
    finally:
        world.stop()


def _case(world, name):
    return [r[name] for r in world["ranks"]]


def test_ranks_import_no_jax(world):
    assert all(r["jax_imported"] == [] for r in world["ranks"])


def test_losses_match_jax_sharded_step(world):
    R.check_metrics(_case(world, "sp"), world["jax"]["metrics"])


def test_params_match_jax_sharded_step(world):
    """Every leaf is whole on every rank (nothing is cut over data or
    sequence)."""
    R.check_params(_case(world, "sp"), world["jax"]["params"], R.whole)


def test_grads_match_single_device(world):
    """Every rank's grads of the global loss: the single-device grads,
    within 5e-5 and within 1e-4 of each leaf's largest grad."""
    R.check_grads_scaled(_case(world, "sp"), world["single"]["sp"], R.whole)


def test_eval_step_matches_jax(world):
    R.check_eval(_case(world, "sp"), world["jax"]["eval"])


def test_fsdp8_matches_jax_and_keeps_embed_sharded(world):
    """fsdp=8: 3 steps' metrics and each rank's params are JAX's (its
    shard), its grads its shard of the single-device grads; after the
    steps each rank holds 1/8 of embed's embed dim, its moments too."""
    ranks, ref = _case(world, "fsdp8"), world["jax"]["fsdp8"]
    R.check_metrics(ranks, ref["metrics"])
    shard = R.mesh_shard(world["tcfg"], FSDP8)
    R.check_params_of_leaves(ranks, ref["params"], shard)
    R.check_grads_scaled(ranks, world["single"]["fsdp8"], shard)
    for r in ranks:
        assert r["params"]["embed"].shape == (512, 128 // 8)
        assert r["shapes"]["mu"]["embed"] == r["shapes"]["nu"]["embed"] == (512, 16)
    assert tuple(ref["state"]["params"]["embed"].sharding.spec) == (None, "fsdp")


def test_collectives_per_step(world):
    """debug (no remat), U = 21, masked; the ring's sends over 4 ranks."""
    want = R.design_collectives(world["tcfg"], 21, masked=True, n_seq=SPEC["sequence"])
    assert all(r["collectives"] == [want] * R.STEPS for r in _case(world, "sp"))


@pytest.mark.parametrize("axis,item", [("fsdp", "4b"), ("tensor", "4b"), ("sequence", "4b"),
                                       ("stage", "4 "), ("num_microbatches", "4 "),
                                       ("stage+sequence", "C")])
def test_unported_raise(world, axis, item):
    """moe_debug from every entry point under each mesh the port took with
    ROADMAP.md Queue A ``item``: fsdp, tensor and sequence (item 4b, MoE
    under them) and stage and microbatches (item 4, the pipeline) now run;
    under stage and sequence together (``item`` C) it raises
    NotImplementedError naming its Queue C row."""
    got = {k: v for k, v in world["ranks"][0]["unported"].items() if k[0] == axis}
    if item == "C":
        assert got and all(v is not None and "ROADMAP.md Queue C, MoE under stage and "
                           "sequence" in v for v in got.values()), got
    else:
        assert got and all(v is None for v in got.values()), got
