"""The port's mesh and sharding rules (ray_tpu_torch.parallel) held
against the JAX package's (ray_tpu.parallel) on the CPU, and the sharded
step on a mesh of one rank held against the single-device step.

No spawned ranks: MeshSpec, spec_for, mesh_axis_size and flat_axes take
a MeshSpec or a sizes mapping, so they meet JAX's on 8-way layouts
without 8 ranks. The mesh of one rank is a gloo world of one in this
process (single_device_mesh); on it the sharded step issues every
collective (each a copy) and must give the single-device step's numbers
bit for bit, as on the card (chip_smoke.py's moe_mesh_train_steps).
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ray_tpu.models import transformer as JT
from ray_tpu.parallel import mesh as JM
from ray_tpu.parallel import sharding as JSH
from ray_tpu_torch import parallel as P
from ray_tpu_torch import train as S
from ray_tpu_torch.models import transformer as T

SPECS = [  # (kwargs, devices): the mesh tests' layouts, -1 and mismatches
    ({"data": -1}, 8), ({"data": 2, "expert": 4}, 8), ({"fsdp": 4, "tensor": 2}, 8),
    ({"data": 2, "sequence": 4}, 8), ({"replica": 2, "fsdp": -1}, 8), ({}, 1),
    ({"data": 2, "stage": 2, "tensor": 2}, 8), ({"data": 3}, 8), ({"data": -1}, 7),
    ({"data": -1, "fsdp": -1}, 8), ({"expert": 3, "data": -1}, 8), ({"tensor": 8}, 4),
]
LAYOUTS = [{"data": 8}, {"data": 2, "expert": 4}, {"fsdp": 4, "tensor": 2},
           {"data": 2, "sequence": 4}]
MODELS = [("debug", {}), ("moe_debug", {}), ("tiny", {"lora_rank": 8})]


def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("ValueError", str(e))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("kw,n", SPECS, ids=[f"{k}-{n}" for k, n in SPECS])
def test_meshspec_matches_jax(kw, n):
    """resolve, num_devices and sizes, with the same errors (text too)."""
    j, t = JM.MeshSpec(**kw), P.MeshSpec(**kw)
    assert P.AXIS_ORDER == JM.AXIS_ORDER and P.DCN_AXES == JM.DCN_AXES
    assert t.sizes() == j.sizes()
    jr, tr = _outcome(lambda: j.resolve(n).sizes()), _outcome(lambda: t.resolve(n).sizes())
    assert tr == jr
    assert _outcome(lambda: t.num_devices) == _outcome(lambda: j.num_devices)
    if jr[0] == "ok":
        assert t.resolve(n).num_devices == j.resolve(n).num_devices == n


@pytest.mark.parametrize("name,kw", MODELS, ids=[m for m, _ in MODELS])
def test_param_axes_match_jax(name, kw):
    assert T.param_axes(T.config(name, **kw)) == JT.param_axes(JT.config(name, **kw))


@pytest.mark.parametrize("layout", LAYOUTS, ids=["x".join(f"{a}{n}" for a, n in l.items())
                                                 for l in LAYOUTS])
def test_spec_for_matches_jax(layout):
    """Every leaf of debug, moe_debug and tiny+LoRA (and the batch), with
    and without the mesh (size-1 axes dropped), against JAX's spec_for on
    the same 8-device layout; mesh_axis_size and flat_axes too."""
    jmesh = JM.build_mesh(JM.MeshSpec(**layout))
    tmesh = P.MeshSpec(**layout)
    for name, kw in MODELS:
        for path, axes in _leaves(JT.param_axes(JT.config(name, **kw))):
            for jm, tm in ((None, None), (jmesh, tmesh), (jmesh, dict(layout))):
                assert P.spec_for(axes, None, tm) == tuple(JSH.spec_for(axes, None, jm)), \
                    (name, path, layout)
    for axes in (("batch",), ("batch", "seq"), ("batch", "seq", "embed")):
        assert P.spec_for(axes, None, tmesh) == tuple(JSH.spec_for(axes, None, jmesh))
    assert S.batch_sharding(tmesh) == tuple(JSH.spec_for(("batch", "seq"), None, jmesh))
    for axis in P.AXIS_ORDER + ("absent",):
        assert P.mesh_axis_size(tmesh, axis) == JM.mesh_axis_size(jmesh, axis)
    assert P.flat_axes(tmesh, *P.AXIS_ORDER) == JM.flat_axes(jmesh, *JM.AXIS_ORDER)


def test_build_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        P.build_mesh(P.MeshSpec(), "cpu")


@pytest.fixture
def world_of_one():
    """single_device_mesh on the CPU: a gloo world of one in this process,
    destroyed after the test."""
    assert not dist.is_initialized()
    mesh = P.single_device_mesh("cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def test_single_device_mesh(world_of_one):
    mesh = world_of_one
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    assert mesh.mesh_dim_names == P.AXIS_ORDER and mesh.device_type == "cpu"
    assert all(P.mesh_axis_size(mesh, a) == 1 for a in P.AXIS_ORDER)
    with pytest.raises(ValueError, match="device count 1"):
        P.build_mesh(P.MeshSpec(data=2), "cpu")
    # the backend follows the device: no CUDA mesh over a gloo group
    with pytest.raises(RuntimeError, match="nccl"):
        P.build_mesh(P.MeshSpec(), "cuda")
    assert P.build_mesh(P.MeshSpec(data=-1), "cpu").mesh.tolist() == [[[[[[[0]]]]]]]


@pytest.mark.parametrize("name", ["moe_debug", "debug"])
def test_mesh_of_one_is_the_single_device_step(world_of_one, name):
    """The sharded step on a mesh of one rank (JAX's positional order:
    init_state(cfg, opt, mesh), make_train_step(cfg, opt, mesh, rules))
    against the single-device step, remat on, with a loss_mask: every
    metric of 3 steps and the whole state after them bit-identical
    (deterministic algorithms and one thread: else the CPU's embedding
    backward sums in a varying order, and a BLAS may split its sums by
    the machine's load), and the collectives each step issues: per
    MoE layer 2 all-gathers (forward and remat re-run), 1 reduce-scatter,
    3 all-reduces (2 combines, 1 input grad); U grad all-reduces, the
    norm's, the metrics' and the mask sum's."""
    mesh = world_of_one
    cfg = T.config(name, dtype=torch.float32, param_dtype=torch.float32, remat=True)
    opt = S.default_optimizer(cfg, lr=1e-2)
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (8, 64))
    mask = np.ones((8, 64), np.float32)
    mask[:4, 20:] = 0
    batch = {"tokens": toks, "loss_mask": mask}
    was, threads = torch.are_deterministic_algorithms_enabled(), torch.get_num_threads()
    torch.use_deterministic_algorithms(True)
    torch.set_num_threads(1)  # a BLAS may pick its thread count by the load
    try:
        plain = S.init_state(cfg, opt, seed=0, device="cpu")
        sharded = S.init_state(cfg, opt, mesh)
        run_plain = S.make_train_step(cfg, opt, device="cpu")
        run_mesh = S.make_train_step(cfg, opt, mesh, P.DEFAULT_RULES)
        moe = cfg.layers if cfg.num_experts else 0
        units = len(S.step._units(plain["params"]))
        want = {"all_gather": 2 * moe, "reduce_scatter": moe,
                "all_reduce": 3 * moe + units + 3}
        for i in range(3):
            plain, m = run_plain(plain, batch)
            P.reset_collectives()
            sharded, sm = run_mesh(sharded, batch)
            assert P.read_collectives() == want
            assert {k: float(v) for k, v in sm.items()} == {k: float(v) for k, v in m.items()}
        for a, b in zip(S.step._flatten(plain), S.step._flatten(sharded)):
            assert torch.equal(a, b)
        ev = S.make_eval_step(cfg, mesh, P.DEFAULT_RULES)(sharded["params"], batch)
        ev_plain = S.make_eval_step(cfg, device="cpu")(plain["params"], batch)
        assert {k: float(v) for k, v in ev.items()} == {k: float(v) for k, v in ev_plain.items()}
    finally:
        torch.use_deterministic_algorithms(was)
        torch.set_num_threads(threads)
