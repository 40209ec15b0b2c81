"""The port's pipelined train step (the ``stage`` mesh axis, GPipe
microbatches: ray_tpu_torch/ops/pipeline.py) held against the JAX
package's pipelined step on the 8-device CPU mesh and against the port's
single-device step, dense ``debug`` at fp32:

- ``pp_tp`` (``MeshSpec(data=2, stage=2, tensor=2)``, 4 microbatches,
  tests/test_moe_pipeline.py's test_pp_matches_reference_numerics): each
  stage holds one of the two layers, cut over tensor; each rank's grads
  are its shard of the unpipelined single-device grads (JAX's pipelined
  grads equal its unpipelined ones);
- ``tied`` (the same mesh, ``tie_embeddings``): ``embed``'s grad is the
  lookup's (first stage) and the unembedding's (last stage) summed over
  the stages, from the port's own init against its single-device step;
- params after the steps against the port's unpipelined single-device
  step (``port_steps`` there says why);
- the microbatch count that does not divide the batch raising
  ValueError (test_microbatch_divisibility_enforced);
- positions microbatched, [S] and [B, S], with every stage in this
  process (no ranks): the unpipelined stack's output and grads.

One of two files of the pipeline's layouts, split only to keep each
under 20 s (tests/test_torch_pipeline_sp.py: stage=2 x data=4 and the
ring inside a stage); one group of 8 gloo ranks (tests/torch_ranks.py).
Tolerances: tests/sharded_step_ref.py.
"""

import pytest
import torch

import sharded_step_ref as R
import torch_ranks
from ray_tpu.parallel.mesh import MeshSpec, build_mesh
from ray_tpu.train import step as JS
from ray_tpu_torch.ops.pipeline import pipelined_layers

SPEC = {"data": 2, "stage": 2, "tensor": 2}
M = 4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The ranks' results from one spawn group (spawned first, so they
    start up while JAX compiles), JAX's pipelined run and the port's
    single-device references."""
    world = torch_ranks.World(R.WORLD, tmp_path_factory.mktemp("ranks"))
    try:
        jcfg, tcfg = R.configs("debug")
        _, ttied = R.configs("debug", tie_embeddings=True)
        toks = R.tokens(jcfg.vocab_size)
        mesh = build_mesh(MeshSpec(**SPEC))
        jstate = JS.init_state(jcfg, JS.default_optimizer(jcfg, lr=R.LR), mesh, seed=0)
        state0, tied0 = R.np_state(jstate), R.port_np_state(ttied)
        world.send({
            "pp_tp": ("train", dict(preset="debug", overrides={}, spec=SPEC, state=state0,
                                    tokens=toks, steps=R.STEPS, num_microbatches=M)),
            "tied": ("train", dict(preset="debug", overrides={"tie_embeddings": True},
                                   spec=SPEC, state=tied0, tokens=toks, steps=R.STEPS,
                                   num_microbatches=M)),
            "divisible": ("divisibility", dict(spec=SPEC)),
            "init": ("init", dict(preset="debug", overrides={}, spec=SPEC)),
        })
        ref = R.jax_run(jcfg, mesh, jstate, {"tokens": toks}, num_microbatches=M)
        batch = {"tokens": toks}
        single = R.single_device(tcfg, state0["params"], batch)
        single_tied = R.single_device(ttied, tied0["params"], batch)
        return {"ranks": world.results(), "jax": ref, "single": single, "tcfg": tcfg,
                "ttied": ttied, "single_tied": single_tied,
                "steps": R.port_steps(tcfg, state0, batch),
                "tied_steps": R.port_steps(ttied, tied0, batch)}
    finally:
        world.stop()


def _case(world, name):
    return [r[name] for r in world["ranks"]]


def _stage(rank):
    """The stage coordinate of ``rank`` at SPEC (data, stage, tensor)."""
    return rank // SPEC["tensor"] % SPEC["stage"]


def test_ranks_import_no_jax(world):
    assert all(r["jax_imported"] == [] for r in world["ranks"])


def test_losses_match_jax_pipelined_step(world):
    """Each of 3 steps' loss, accuracy, grad_norm and tokens on every rank:
    JAX's pipelined step's (2e-5)."""
    R.check_metrics(_case(world, "pp_tp"), world["jax"]["metrics"])


def test_params_match_single_device_step(world):
    """After 3 steps each rank's params are its shard (its stage's layer,
    cut over tensor) of the unpipelined single-device step's: see
    sharded_step_ref.port_steps for why not JAX's pipelined params."""
    R.check_params_of_leaves(_case(world, "pp_tp"), world["steps"]["params"],
                             R.mesh_shard(world["tcfg"], SPEC))


def test_grads_match_single_device(world):
    """Every rank's grads of the global loss (value_and_grad, 4
    microbatches): its shard of the unpipelined single-device grads
    (5e-5, and 1e-4 of each leaf's largest grad: a grad summed twice over
    the stages would show), metrics within 2e-5."""
    R.check_grads_scaled(_case(world, "pp_tp"), world["single"],
                         R.mesh_shard(world["tcfg"], SPEC))


def test_eval_step_matches_jax(world):
    R.check_eval(_case(world, "pp_tp"), world["jax"]["eval"])


def test_state_is_cut_over_stage(world):
    """Each rank holds its stage's layer of every stacked leaf and its
    moments (``wq`` [1, 128, 2, 32]: one layer, two heads), and the whole
    embedding's vocab half on every stage; JAX cuts ``layers`` over stage
    too."""
    for r in _case(world, "pp_tp"):
        for tree in ("params", "mu", "nu"):
            assert r["shapes"][tree]["blocks/wq"] == (1, 128, 2, 32)
            assert r["shapes"][tree]["blocks/ln_attn"] == (1, 128)
            assert r["shapes"][tree]["embed"] == (256, 128)
    assert tuple(world["jax"]["state"]["params"]["blocks"]["wq"].sharding.spec)[0] == "stage"


def test_sends_per_step(world):
    """Each step, the first stage sends each microbatch's output forward
    and the second each microbatch's input grad back: M sends a rank."""
    for r in _case(world, "pp_tp"):
        assert [c["send"] for c in r["collectives"]] == [M] * R.STEPS


def test_tied_embeddings(world):
    """tie_embeddings: every rank's grads are its shard of the
    single-device ones (``embed``: the lookup's grad from the first
    stage and the unembedding's from the last, summed once over the
    stages); 3 steps' metrics are the single-device step's."""
    ranks = _case(world, "tied")
    shard = R.mesh_shard(world["ttied"], SPEC)
    R.check_grads_scaled(ranks, world["single_tied"], shard)
    R.check_metrics(ranks, world["tied_steps"]["metrics"])
    R.check_params_of_leaves(ranks, world["tied_steps"]["params"], shard)


def test_init_state_takes_jax_positional_order(world):
    """init_state(cfg, opt, mesh): each leaf is this rank's shard (its
    stage's layer) of the single-device init from the same seed, the
    moments shaped as the params; state_shardings gives wi_gate JAX's
    spec, ``layers`` over stage."""
    want = tuple(world["jax"]["state"]["params"]["blocks"]["wi_gate"].sharding.spec)
    for r in _case(world, "init"):
        assert all(r["leaf_is_shard"].values()), r["leaf_is_shard"]
        assert r["moments_like_params"]
        assert r["spec_of_wi_gate"] == want == ("stage", None, "tensor")


def test_microbatches_must_divide_the_batch(world):
    got = world["ranks"][0]["divisible"]
    assert "not divisible by microbatches 3" in got["step"]
    assert "batch 7 not divisible by microbatches 3" in got["pipelined_layers"]


@pytest.mark.parametrize("per_row", [False, True], ids=["positions_S", "positions_BS"])
def test_positions_are_microbatched(per_row):
    """pipelined_layers in one process (3 stages of one layer, 4
    microbatches of 3 rows): each stage's layers see their microbatch's
    positions, shared [S] or per row [B, S] (JAX's pipelined_layers
    :108-118), and the output and the grads of the input and of every
    layer's weight are the unpipelined stack's; [B, S] positions of
    another batch raise ValueError."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(12, 5, 4, generator=gen, requires_grad=True)
    pos = (torch.randn(12, 5, generator=gen) if per_row else torch.randn(5, generator=gen))
    ws = [torch.randn(4, 4, generator=gen, requires_grad=True) for _ in range(3)]

    def stack(layers, h, p):
        for (w,) in layers:
            h = torch.tanh(h @ w + p[..., None])
        return h

    layers = [(w,) for w in ws]
    got = pipelined_layers(stack, layers, x, pos, 4, 3)
    want = stack(layers, x, pos)
    torch.testing.assert_close(got, want)
    g = torch.randn(want.shape, generator=gen)
    grads = torch.autograd.grad(got, [x, *ws], g)
    for a, b in zip(grads, torch.autograd.grad(want, [x, *ws], g)):
        torch.testing.assert_close(a, b)
    if per_row:
        with pytest.raises(ValueError, match="positions batch dim 12 != batch 8"):
            pipelined_layers(stack, layers, x[:8], pos, 4, 3)
