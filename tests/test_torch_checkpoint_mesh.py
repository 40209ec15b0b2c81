"""The port's sharded checkpoint across ranks: a ``debug`` train state
saved by 8 gloo ranks at ``fsdp=8`` and restored at ``fsdp=4 x tensor=2``
and at ``data=2 x stage=2 x tensor=2`` (``layers`` cut over stage),
held against the JAX package's orbax restore onto the same meshes
(tests/test_models_train.py::test_restore_onto_different_mesh as a
parity test): each rank's leaves equal, bit for bit, the shard JAX's
device r holds. The ranks save each restored state again under its
mesh. Then this process, with no process group, restores each of the
three directories whole (8 writers, one reader) and must get the
unsharded state.

The state is JAX's init at fsdp=8 after one JAX step (moments, count and
step not zero), converted with ``state_from_jax``. One group of 8 gloo
ranks (tests/torch_ranks.py).
"""

import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

import sharded_step_ref as R
import torch_ranks
from ray_tpu.parallel.mesh import MeshSpec, build_mesh
from ray_tpu.train import checkpoint as JC
from ray_tpu.train import step as JS
from ray_tpu_torch import train as S
from ray_tpu_torch.models.convert import state_from_jax


def _device_shard(arr, rank):
    """The shard of a jax.Array that device ``rank`` holds."""
    return next(np.asarray(s.data) for s in arr.addressable_shards if s.device.id == rank)


def _port_paths(jstate):
    """A JAX train state's leaves by the port's paths (as torch_ranks'
    ``_items`` names them), the optax moments pulled out."""
    opt = jstate["opt_state"]
    tree = {"params": jstate["params"],
            "opt_state": {"mu": optax.tree_utils.tree_get(opt, "mu"),
                          "nu": optax.tree_utils.tree_get(opt, "nu"),
                          "count": optax.tree_utils.tree_get(opt, "count")},
            "step": jstate["step"]}
    return dict(R.items(tree))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The ranks' restores (spawned first, so they start up while JAX
    compiles), JAX's restores onto the same meshes, and the directory
    the ranks wrote."""
    out = tmp_path_factory.mktemp("ranks")
    world = torch_ranks.World(R.WORLD, out)
    try:
        jcfg, tcfg = R.configs("debug")
        jopt = JS.default_optimizer(jcfg, lr=R.LR)
        m1 = build_mesh(MeshSpec(fsdp=-1))
        jstate = JS.init_state(jcfg, jopt, m1, seed=0)
        jstate, _ = JS.make_train_step(jcfg, jopt, m1)(
            jstate, {"tokens": R.tokens(jcfg.vocab_size)})
        state0 = R.np_state(jstate)
        directory = str(out / "ckpt")
        world.send({"ckpt": ("checkpoint", dict(preset="debug", state=state0,
                                                directory=directory))})
        JC.save_state(jstate, str(out / "jax"))
        jax_restores = {}
        for name, spec in torch_ranks.CHECKPOINT_MESHES.items():
            m2 = build_mesh(MeshSpec(**spec))
            jax_restores[name] = _port_paths(JC.restore_state(
                str(out / "jax"), target=jstate, shardings=JS.state_shardings(jcfg, jopt, m2)))
        ranks = world.results()
    finally:
        world.stop()
    return {"ranks": ranks, "jax": jax_restores, "state0": state0, "tcfg": tcfg,
            "directory": directory}


def test_ranks_import_no_jax(world):
    assert all(r["jax_imported"] == [] for r in world["ranks"])


@pytest.mark.parametrize("mesh", list(torch_ranks.CHECKPOINT_MESHES))
def test_restore_onto_other_mesh_matches_jax(world, mesh):
    """Every rank's every leaf: the shard of JAX's resharded restore that
    device r holds, bit for bit, dtype and shape included."""
    for rank, r in enumerate(world["ranks"]):
        ours, theirs = r["ckpt"][mesh], world["jax"][mesh]
        assert ours.keys() == theirs.keys()
        for path, a in ours.items():
            b = _device_shard(theirs[path], rank)
            assert a.dtype == b.dtype and a.shape == b.shape, (rank, path)
            np.testing.assert_array_equal(a, b, err_msg=f"rank {rank} {path}")


def test_layouts_cut_as_asked(world):
    """wq's spec at each mesh: fsdp on embed and tensor on heads; under
    stage, layers over stage too (the leaf a stage holds is its layers)."""
    r = world["ranks"][0]["ckpt"]
    assert r["fsdp4_tp2_spec_of_wq"] == (None, "fsdp", "tensor")
    assert r["dp2_st2_tp2_spec_of_wq"] == ("stage", None, "tensor")
    assert r["dp2_st2_tp2"]["params/blocks/wq"].shape[0] == 1  # 2 layers over 2 stages


def test_two_mesh_axes_on_one_dim_raise(world):
    msg = world["ranks"][0]["ckpt"]["two_axes"]
    assert "('data', 'tensor')" in msg


@pytest.mark.parametrize("saved_at", ["fsdp8", *torch_ranks.CHECKPOINT_MESHES])
def test_one_process_restores_what_8_ranks_wrote(world, saved_at):
    """No process group here: the whole state, equal to the unsharded one,
    from the fsdp=8 save and from the saves at the other two layouts."""
    assert not dist.is_initialized()
    directory = world["directory"] + ("" if saved_at == "fsdp8" else f"_{saved_at}")
    whole = S.restore_state(directory, device="cpu")
    want = state_from_jax(world["state0"], world["tcfg"], device="cpu")
    got, ref = dict(R.items(whole)), dict(R.items(want))
    assert got.keys() == ref.keys()
    for path, t in got.items():
        assert t.dtype == ref[path].dtype and torch.equal(t, ref[path]), path
    assert int(whole["step"]) == 1 and int(whole["opt_state"]["count"]) == 1
