"""The port's sharded train step (ray_tpu_torch.train under a mesh) held
against the JAX package's sharded step and against the port's own
single-device step on the global batch: mixture-of-experts at
``MeshSpec(data=2, expert=4)``, as tests/test_moe_pipeline.py's
test_ep_sharded_training_step runs it, with a loss_mask uneven across
the two data shards.

One group of 8 gloo ranks (tests/torch_ranks.py) runs every case of this
file; the JAX reference runs here on the 8-device CPU mesh
(tests/conftest.py). tests/test_torch_sharded_step_dp.py and
tests/test_torch_sharded_step_lora.py hold the data-parallel cases
(files of their own only to keep each under 20 s). Tolerances:
tests/sharded_step_ref.py.

Collectives per step of the design (ray_tpu_torch/parallel/collectives.py),
as tests/sharded_step_ref.py's ``design_collectives`` counts them: each
MoE layer gathers the data group's tokens (reduce-scatter in the
backward), sums its experts' outputs over the expert group and, in the
backward, its input's grad; the FSDP gathers of every leaf with an embed
dim, the tensor group's sums and the loss's reductions run at size one;
the U grads are summed over the data group, the norm's squares over
(fsdp, expert, tensor).
"""

import numpy as np
import pytest

import sharded_step_ref as R
import torch_ranks
from ray_tpu.parallel.mesh import MeshSpec, build_mesh
from ray_tpu.parallel.sharding import spec_for as jax_spec_for
from ray_tpu.train import step as JS
from ray_tpu_torch.models import transformer as T

SPEC = {"data": 2, "expert": 4}
REPLICA_SPEC = {"replica": 2, "data": 2, "expert": 2}
EXPERTS_PER_RANK = 1  # moe_debug's 4 experts over expert=4
EXPERT_LEAVES = ("wi_gate", "wi_up", "wo_mlp")


def _mask(b=8, s=64):
    """Uneven across the two data shards (rows 0-3, 4-7): the first keeps
    35 of 64 positions a row, the second all, so the mean of per-shard
    means is not the loss."""
    mask = np.ones((b, s), np.float32)
    mask[: b // 2, 35:] = 0
    return mask


def _shard(path, a, rank):
    """Rank ``rank``'s shard of the whole leaf ``a``: expert leaves
    [L, E, ...] cut over expert (the mesh coordinate rank % 4)."""
    if path.split("/")[-1] in EXPERT_LEAVES and path.startswith("blocks/"):
        e = rank % SPEC["expert"] * EXPERTS_PER_RANK
        return a[:, e:e + EXPERTS_PER_RANK]
    return a


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The ranks' results from one spawn group (spawned first, so they
    start up while JAX compiles), JAX's sharded run and the port's
    single-device references."""
    world = torch_ranks.World(R.WORLD, tmp_path_factory.mktemp("ranks"))
    try:
        jcfg, tcfg = R.configs("moe_debug")
        batch = {"tokens": R.tokens(jcfg.vocab_size), "loss_mask": _mask()}
        mesh = build_mesh(MeshSpec(**SPEC))
        jstate = JS.init_state(jcfg, JS.default_optimizer(jcfg, lr=R.LR), mesh, seed=0)
        state0 = R.np_state(jstate)
        common = dict(preset="moe_debug", spec=SPEC, state=state0, tokens=batch["tokens"],
                      mask=batch["loss_mask"])
        world.send({
            "ep": ("train", dict(common, overrides={}, steps=R.STEPS)),
            "cf05": ("train", dict(common, overrides={"capacity_factor": 0.5}, steps=1,
                                   routing=True)),
            "init": ("init", dict(preset="moe_debug", overrides={}, spec=SPEC)),
            "unported": ("unported", dict(preset="moe_debug")),
            # the batch cut over two axes (a group over replica x data)
            "eval_replica": ("evaluate", dict(preset="moe_debug", overrides={},
                                              spec=REPLICA_SPEC, params=state0["params"],
                                              tokens=batch["tokens"],
                                              mask=batch["loss_mask"])),
        })
        ref = R.jax_run(jcfg, mesh, jstate, batch)
        ref["eval_replica"] = {k: float(v) for k, v in JS.make_eval_step(
            jcfg, build_mesh(MeshSpec(**REPLICA_SPEC)))(jstate["params"], batch).items()}
        ref["wi_gate_spec"] = tuple(
            ref.pop("state")["params"]["blocks"]["wi_gate"].sharding.spec)
        single = {name: R.single_device(T.config(tcfg, capacity_factor=cf), state0["params"],
                                        batch, record_routing=True)
                  for name, cf in (("ep", 1.25), ("cf05", 0.5))}
        return {"ranks": world.results(), "jax": ref, "single": single}
    finally:
        world.stop()


def _case(world, name):
    return [r[name] for r in world["ranks"]]


def test_ranks_import_no_jax(world):
    assert all(r["jax_imported"] == [] for r in world["ranks"])


def test_losses_match_jax_sharded_step(world):
    R.check_metrics(_case(world, "ep"), world["jax"]["metrics"])


def test_params_match_jax_sharded_step(world):
    """Each rank's params after the steps: its shard of JAX's."""
    R.check_params(_case(world, "ep"), world["jax"]["params"], _shard)


@pytest.mark.parametrize("case", ["ep", "cf05"])
def test_grads_match_single_device(world, case):
    """Every rank's grads of the global loss (value_and_grad under the
    mesh) against the matching slice of the single-device grads, at
    capacity factor 1.25 and 0.5."""
    R.check_grads(_case(world, case), world["single"][case], _shard)


def test_capacity_drops_match_single_device(world):
    """At capacity factor 0.5: each MoE layer's routing (gate_idx, slot,
    keep; the capacity from the global T = 512) on every rank is the
    single-device step's, and entries are dropped."""
    single = world["single"]["cf05"]["routing"]
    assert len(single) == 2 and not single[0]["keep"].all()
    for rank, got in enumerate(_case(world, "cf05")):
        assert len(got["routing"]) == len(single)
        for layer, (a, b) in enumerate(zip(got["routing"], single)):
            assert a["capacity"] == b["capacity"] == max(4, int(0.5 * 512 * 2 / 4))
            for f in ("gate_idx", "slot", "keep"):
                np.testing.assert_array_equal(a[f], b[f],
                                              err_msg=f"rank {rank} layer {layer} {f}")


def test_expert_leaves_are_local_shards(world):
    """Expert leaves and their Adam moments are [L, E/4, ...] on each
    rank, every other leaf whole; JAX shards wi_gate on expert too."""
    shapes = dict(R.items(T.param_shapes(T.config("moe_debug"))))
    for r in _case(world, "ep"):
        for tree in ("params", "mu", "nu"):
            for path, shape in r["shapes"][tree].items():
                want = shapes[path][0]
                if path.split("/")[-1] in EXPERT_LEAVES:
                    want = (want[0], EXPERTS_PER_RANK) + want[2:]
                assert shape == want, (tree, path)
    assert world["jax"]["wi_gate_spec"] == (None, "expert")


def test_init_state_takes_jax_positional_order(world):
    """init_state(cfg, opt, mesh): each leaf is this rank's shard of the
    single-device init from the same seed; state_shardings gives the
    expert leaves JAX's spec."""
    want = tuple(jax_spec_for(("layers", "expert", "embed", "mlp"), None,
                              build_mesh(MeshSpec(**SPEC))))
    for r in _case(world, "init"):
        assert all(r["leaf_is_shard"].values()), r["leaf_is_shard"]
        assert r["moments_like_params"]
        assert r["spec_of_wi_gate"] == want


def test_eval_step_matches_jax(world):
    R.check_eval(_case(world, "ep"), world["jax"]["eval"])


def test_eval_over_replica_and_data_matches_jax(world):
    """make_eval_step at replica=2 x data=2 x expert=2: the batch cut over
    a group of two axes, two experts a rank."""
    for r in _case(world, "eval_replica"):
        for k, v in world["jax"]["eval_replica"].items():
            np.testing.assert_allclose(r[k], v, atol=R.ATOL, err_msg=k)


def test_collectives_per_step(world):
    """The calls each step issues, by kind, as the module docstring
    states the design: moe_debug, no remat, U=23 (10 block leaves x 2
    layers + embed, ln_f, unembed), masked."""
    want = R.design_collectives(T.config("moe_debug"), 23, masked=True)
    assert all(r["collectives"] == [want] * R.STEPS for r in _case(world, "ep"))


@pytest.mark.parametrize("axis,item", [("fsdp", "4b"), ("tensor", "4b"), ("sequence", "4b"),
                                       ("stage", "4 "), ("num_microbatches", "4 "),
                                       ("stage+sequence", "C")])
def test_unported_axes_raise(world, axis, item):
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
