"""The port's pipelined train step held against the JAX package's
pipelined step on the 8-device CPU mesh and against the port's
single-device step, dense ``debug`` at fp32, 2 microbatches:

- ``pp_dp`` (``MeshSpec(stage=2, data=4)``,
  tests/test_moe_pipeline.py's test_pp_params_sharded_over_stage): each
  rank holds its stage's layer before and after the steps;
- ``pp_sp`` (``MeshSpec(data=2, stage=2, sequence=2)``,
  test_pp_sp_matches_reference_numerics): ring attention inside each
  stage, the sequence shard's global positions per microbatch, and a
  loss_mask uneven across the microbatches and the sequence shards (the
  loss divides by the whole batch's mask sum, not per microbatch). JAX's
  make_eval_step fails at this mesh (its ring needs the pipeline's
  manual region), so the port's eval is held against JAX's step 0.

One of two files of the pipeline's layouts (tests/test_torch_pipeline.py:
data=2 x stage=2 x tensor=2); one group of 8 gloo ranks
(tests/torch_ranks.py). Tolerances: tests/sharded_step_ref.py.
"""

import jax
import numpy as np
import pytest

import sharded_step_ref as R
import torch_ranks
from ray_tpu.parallel.mesh import MeshSpec, build_mesh
from ray_tpu.train import step as JS

PP_DP = {"stage": 2, "data": 4}
PP_SP = {"data": 2, "stage": 2, "sequence": 2}
M = 2


def _mask(b=8, s=64):
    """Uneven across the two microbatches (rows 0-3, 4-7), the data shards
    within each and the two sequence shards (32 positions each): rows 0-1
    keep positions 0-19, rows 2-7 all but 40-49."""
    mask = np.ones((b, s), np.float32)
    mask[:2, 20:] = 0
    mask[2:, 40:50] = 0
    return mask


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The ranks' results from one spawn group (spawned first, so they
    start up while JAX compiles), JAX's pipelined runs and the port's
    single-device references."""
    world = torch_ranks.World(R.WORLD, tmp_path_factory.mktemp("ranks"))
    try:
        jcfg, tcfg = R.configs("debug")
        toks = R.tokens(jcfg.vocab_size)
        masked = {"tokens": toks, "loss_mask": _mask()}
        opt = JS.default_optimizer(jcfg, lr=R.LR)
        mesh_dp, mesh_sp = build_mesh(MeshSpec(**PP_DP)), build_mesh(MeshSpec(**PP_SP))
        jstate = JS.init_state(jcfg, opt, mesh_dp, seed=0)
        # the same state laid out for the other mesh (no second init to compile)
        jstate_sp = jax.device_put(jstate, JS.state_shardings(jcfg, opt, mesh_sp))
        state0 = R.np_state(jstate)
        world.send({
            "pp_dp": ("train", dict(preset="debug", overrides={}, spec=PP_DP, state=state0,
                                    tokens=toks, steps=R.STEPS, num_microbatches=M)),
            "pp_sp": ("train", dict(preset="debug", overrides={}, spec=PP_SP, state=state0,
                                    tokens=toks, mask=masked["loss_mask"], steps=R.STEPS,
                                    num_microbatches=M)),
            "init_dp": ("init", dict(preset="debug", overrides={}, spec=PP_DP)),
            "init_sp": ("init", dict(preset="debug", overrides={}, spec=PP_SP)),
        })
        ref = {"pp_dp": R.jax_run(jcfg, mesh_dp, jstate, {"tokens": toks}, num_microbatches=M),
               "pp_sp": R.jax_run(jcfg, mesh_sp, jstate_sp, masked, with_eval=False,
                                  num_microbatches=M)}
        single = {"pp_dp": R.single_device(tcfg, state0["params"], {"tokens": toks}),
                  "pp_sp": R.single_device(tcfg, state0["params"], masked)}
        steps = {"pp_dp": R.port_steps(tcfg, state0, {"tokens": toks}),
                 "pp_sp": R.port_steps(tcfg, state0, masked)}
        return {"ranks": world.results(), "jax": ref, "single": single, "steps": steps,
                "tcfg": tcfg}
    finally:
        world.stop()


def _case(world, name):
    return [r[name] for r in world["ranks"]]


CASES = {"pp_dp": PP_DP, "pp_sp": PP_SP}


def test_ranks_import_no_jax(world):
    assert all(r["jax_imported"] == [] for r in world["ranks"])


@pytest.mark.parametrize("case", list(CASES))
def test_losses_match_jax_pipelined_step(world, case):
    R.check_metrics(_case(world, case), world["jax"][case]["metrics"])


@pytest.mark.parametrize("case", list(CASES))
def test_params_match_single_device_step(world, case):
    """After 3 steps each rank holds its stage's layer of every stacked
    leaf, the unpipelined single-device step's (sharded_step_ref.port_steps
    says why not JAX's pipelined params)."""
    R.check_params_of_leaves(_case(world, case), world["steps"][case]["params"],
                             R.mesh_shard(world["tcfg"], CASES[case]))


@pytest.mark.parametrize("case", list(CASES))
def test_grads_match_single_device(world, case):
    R.check_grads_scaled(_case(world, case), world["single"][case],
                         R.mesh_shard(world["tcfg"], CASES[case]))


def test_eval_step_matches_jax(world):
    """pp_dp against JAX's make_eval_step; pp_sp against JAX's step 0
    (the same params: its loss, accuracy and tokens)."""
    R.check_eval(_case(world, "pp_dp"), world["jax"]["pp_dp"]["eval"])
    step0 = world["jax"]["pp_sp"]["metrics"][0]
    R.check_eval(_case(world, "pp_sp"), {k: step0[k] for k in ("loss", "accuracy", "tokens")})


def test_each_rank_holds_its_stage(world):
    """Before and after the steps: one of the two layers on each rank, and
    the embedding whole on every stage; JAX cuts ``layers`` over stage."""
    for r in _case(world, "pp_dp"):
        for tree in ("params", "mu", "nu"):
            assert r["shapes"][tree]["blocks/wq"] == (1, 128, 4, 32)
            assert r["shapes"][tree]["embed"] == (512, 128)
        assert r["params"]["blocks"]["wq"].shape == (1, 128, 4, 32)
    assert tuple(world["jax"]["pp_dp"]["state"]["params"]["blocks"]["wq"].sharding.spec) == (
        "stage",)


@pytest.mark.parametrize("case", list(CASES))
def test_init_state_takes_jax_positional_order(world, case):
    """init_state(cfg, opt, mesh): each leaf is this rank's shard of the
    single-device init from the same seed, the moments shaped as the
    params; state_shardings gives wi_gate JAX's spec."""
    want = tuple(world["jax"][case]["state"]["params"]["blocks"]["wi_gate"].sharding.spec)
    for r in _case(world, "init_" + case[3:]):
        assert all(r["leaf_is_shard"].values()), r["leaf_is_shard"]
        assert r["moments_like_params"]
        assert r["spec_of_wi_gate"] == want == ("stage",)


def test_sends_per_step(world):
    """pp_dp: M sends a rank a step (the first stage's outputs, the second
    stage's input grads). pp_sp adds the ring's, per microbatch and layer:
    2(n-1) = 2 K/V sends a forward run (debug has no remat) and
    2(n-1) + 2n = 6 in the backward."""
    for r in _case(world, "pp_dp"):
        assert [c["send"] for c in r["collectives"]] == [M] * R.STEPS
    ring = M * (2 + 6)  # one layer a stage
    for r in _case(world, "pp_sp"):
        assert [c["send"] for c in r["collectives"]] == [M + ring] * R.STEPS
