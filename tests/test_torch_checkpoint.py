"""The port's checkpoints (ray_tpu_torch.train.checkpoint) held against the
JAX package's (ray_tpu.train.checkpoint) on the CPU, in this process (no
spawn; the 8-rank save and resharded restore are
tests/test_torch_checkpoint_mesh.py).

- ``Checkpoint`` and ``CheckpointManager``: the same operations in two
  directories give the same listings, metadata and index (storage
  prefix stripped), keep-K eviction and ``best``;
- ``save_state`` / ``restore_state``: a train state round-trips bit for
  bit (dtype too: bf16 leaves, int32 0-d ``step`` and ``count``) for
  ``debug`` in fp32 and bf16, ``tiny`` + LoRA and ``moe_debug``, with no
  target, a target, a meta target and a gloo world of one's shardings;
  a saved dtype is cast to the target's; a stale ``.tmp`` is replaced;
- a JAX state through JAX's orbax save and restore, converted with
  ``state_from_jax``, equals the port's restore of the port's save of
  the same state, bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import sharded_step_ref as R
from ray_tpu.models import transformer as JT
from ray_tpu.parallel.mesh import MeshSpec, build_mesh
from ray_tpu.train import checkpoint as JC
from ray_tpu.train import step as JS
from ray_tpu_torch import train as S
from ray_tpu_torch.models import transformer as T
from ray_tpu_torch.models.convert import state_from_jax
from ray_tpu_torch.parallel import single_device_mesh
from ray_tpu_torch.train import checkpoint as C

# name -> (preset, overrides, param dtype)
STATES = {"debug": ("debug", {}, torch.float32),
          "debug_bf16": ("debug", {}, torch.bfloat16),
          "lora": ("tiny", {"lora_rank": 8}, torch.float32),
          "moe": ("moe_debug", {}, torch.float32)}
TARGETS = ("none", "target", "meta", "shardings")


def _items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _items(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _state(name):
    """The port's init on the CPU with seeded random moments and distinct
    step and count, so no leaf is zeros."""
    preset, kw, dtype = STATES[name]
    cfg = T.config(preset, param_dtype=dtype, **kw)
    opt = S.default_optimizer(cfg)
    st = S.init_state(cfg, opt, seed=1, device="cpu")
    rng = np.random.RandomState(0)
    for _, t in _items(st["opt_state"]):
        if t.ndim:
            t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)))
    st["opt_state"]["count"].fill_(7)
    st["step"].fill_(9)
    return cfg, opt, st


def _assert_equal(a, b):
    assert dict(_items(a)).keys() == dict(_items(b)).keys()
    for (p, x), (_, y) in zip(sorted(_items(a)), sorted(_items(b))):
        assert x.dtype == y.dtype and x.shape == y.shape, p
        assert torch.equal(x, y), p


def _manager_ops(mod, root):
    """The same operations on one package's Checkpoint/CheckpointManager
    under ``root``: what each leaves behind, storage prefix stripped."""
    out = {}
    c = mod.Checkpoint.from_directory(str(root / "loose"))
    os.makedirs(c.as_directory())
    c.update_metadata({"a": 1})
    c.update_metadata({"b": 2})
    out["merged"] = c.get_metadata()
    c.set_metadata({"c": 3})
    out["set"] = c.get_metadata()
    out["empty"] = mod.Checkpoint(str(root / "nowhere")).get_metadata()
    copy = c.to_directory(str(root / "copy"))
    out["copied"] = sorted(os.listdir(copy))
    store = root / "store"
    mgr = mod.CheckpointManager(str(store), num_to_keep=2)
    out["latest_empty"] = mgr.latest()
    for i in range(4):
        d = root / f"c{i}"
        d.mkdir()
        (d / "x.txt").write_text(str(i))
        managed = mgr.register(mod.Checkpoint(str(d)), {"loss": 10 - i, "acc": i % 3})
        out[f"registered{i}"] = os.path.relpath(managed.path, store)
    mgr.register(mod.Checkpoint(str(root / "loose")))  # no metrics
    out["listing"] = sorted(os.listdir(store))
    out["best_loss_min"] = os.path.relpath(mgr.best("loss").path, store)
    out["best_acc_max"] = os.path.relpath(mgr.best("acc", "max").path, store)
    out["best_missing"] = os.path.relpath(mgr.best("nope").path, store)
    meta = mod.Checkpoint(str(store / "checkpoint_000003")).get_metadata()
    out["metadata"] = {k: v for k, v in meta.items() if k != "time"}
    reopened = mod.CheckpointManager(str(store), num_to_keep=2)
    out["index"] = [{**h, "path": os.path.relpath(h["path"], store)}
                    for h in reopened._history]
    out["latest"] = os.path.relpath(reopened.latest().path, store)
    out["x"] = (store / "checkpoint_000003" / "x.txt").read_text()
    return out


def test_checkpoint_and_manager_match_jax(tmp_path):
    ours = _manager_ops(C, tmp_path / "port")
    theirs = _manager_ops(JC, tmp_path / "jax")
    assert ours == theirs
    assert ours["listing"] == [".ckpt_index.json", "checkpoint_000003", "checkpoint_000004"]


@pytest.fixture
def world_of_one():
    """A gloo world of one in this process, destroyed after the test."""
    assert not dist.is_initialized()
    mesh = single_device_mesh("cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("how", TARGETS)
@pytest.mark.parametrize("name", list(STATES))
def test_save_restore_round_trip(tmp_path, name, how, request):
    cfg, opt, st = _state(name)
    d = str(tmp_path / "state")
    if how == "shardings":
        mesh = request.getfixturevalue("world_of_one")
        sh = S.state_shardings(cfg, opt, mesh)
        S.save_state(st, d, shardings=sh, mesh=mesh)
        out = S.restore_state(d, _map(lambda t: t.to("meta"), st), sh, mesh=mesh)
    else:
        S.save_state(st, d)
        target = {"none": None, "target": st,
                  "meta": _map(lambda t: t.to("meta"), st)}[how]
        out = S.restore_state(d, target, device="cpu")
    _assert_equal(out, st)
    # DCP's own metadata beside Checkpoint's sidecar
    C.Checkpoint(d).update_metadata({"step": 9})
    assert {".metadata", ".metadata.json"} <= set(os.listdir(d))
    assert C.Checkpoint(d).get_metadata() == {"step": 9}
    _assert_equal(S.restore_state(d, device="cpu"), st)


def test_restore_params_from_param_shapes_and_cast(tmp_path):
    """A ``param_shapes`` target takes the saved dtypes; a tensor target's
    dtype wins over the saved one (cast, as orbax casts)."""
    cfg, _, st = _state("debug_bf16")
    d = str(tmp_path / "params")
    S.save_state(st["params"], d)
    _assert_equal(S.restore_state(d, T.param_shapes(cfg), device="cpu"), st["params"])
    as32 = S.restore_state(d, _map(lambda t: t.float().to("meta"), st["params"]),
                           device="cpu")
    _assert_equal(as32, _map(torch.Tensor.float, st["params"]))


def test_stale_tmp_and_old_directory_are_replaced(tmp_path):
    _, _, st = _state("debug")
    d = tmp_path / "state"
    (tmp_path / "state.tmp").mkdir()
    (tmp_path / "state.tmp" / "junk").write_text("stale")
    d.mkdir()
    (d / "old").write_text("an earlier save")
    S.save_state(st, str(d))
    assert not (tmp_path / "state.tmp").exists()
    assert "junk" not in os.listdir(d) and "old" not in os.listdir(d)
    _assert_equal(S.restore_state(str(d), device="cpu"), st)


def test_layout_arguments_go_together(tmp_path, world_of_one):
    cfg, opt, st = _state("debug")
    with pytest.raises(ValueError, match="together"):
        S.save_state(st, str(tmp_path / "a"), shardings=S.state_shardings(cfg, opt, None))
    with pytest.raises(ValueError, match="together"):
        S.restore_state(str(tmp_path / "a"), mesh=world_of_one)


def test_jax_save_restore_equals_port_save_restore(tmp_path):
    jcfg = JT.config("debug", dtype=jnp.float32, param_dtype=jnp.float32)
    tcfg = T.config("debug", dtype=torch.float32, param_dtype=torch.float32)
    jopt = JS.default_optimizer(jcfg)
    mesh = build_mesh(MeshSpec(), [jax.devices()[0]])
    jstate = JS.init_state(jcfg, jopt, mesh, seed=0)
    jstate, _ = JS.make_train_step(jcfg, jopt, mesh, donate=False)(
        jstate, {"tokens": jnp.asarray(R.tokens(jcfg.vocab_size, b=2, s=16))})
    JC.save_state(jstate, str(tmp_path / "jax"))
    jback = JC.restore_state(str(tmp_path / "jax"),
                             target=jax.tree.map(jnp.zeros_like, jstate))
    from_jax = state_from_jax(R.np_state(jback), tcfg, device="cpu")
    port = state_from_jax(R.np_state(jstate), tcfg, device="cpu")
    S.save_state(port, str(tmp_path / "port"))
    _assert_equal(S.restore_state(str(tmp_path / "port"), device="cpu"), from_jax)
    assert int(from_jax["step"]) == 1 and int(from_jax["opt_state"]["count"]) == 1
