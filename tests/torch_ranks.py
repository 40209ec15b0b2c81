"""The ranks of the port's multi-rank tests (tests/test_torch_sharded_step*.py,
tests/test_torch_pipeline*.py, tests/test_torch_ring_attention.py,
tests/test_torch_collective.py, tests/test_torch_checkpoint_mesh.py), and
the loops and actors of its worker-group tests
(tests/test_torch_worker_group.py: ``group_train``, ``group_resume``,
``CollectiveMember``), which run in the worker processes of the port's
cluster.

``World`` spawns one group of gloo ranks on the CPU, brought up over a
FileStore in a temporary directory (no TCP port) or, when the cases
carry ``BOOTSTRAP`` (one HostGroupSpec a rank), through the port's
``initialize_host`` over TCP on localhost, and runs every case of
a test file in it: a case is a function of this module, named with its
keyword arguments (numpy inputs: tokens, masks, the JAX train state).
Each rank returns its results as numpy, collected per rank. A group
that has not finished within ``World.DEADLINE`` seconds is ended and its
file fails, naming the ranks still alive.
This module imports only torch, numpy and ray_tpu_torch: the JAX
reference runs in the pytest process.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ray_tpu_torch import train as S
from ray_tpu_torch.models import transformer as T
from ray_tpu_torch.models.convert import params_from_jax, state_from_jax
from ray_tpu_torch.ops.pipeline import pipelined_layers
from ray_tpu_torch.ops.ring_attention import ring_attention
from ray_tpu_torch.parallel import bootstrap
from ray_tpu_torch.parallel import (
    DEFAULT_RULES, MeshSpec, build_mesh, local_shard, mesh_groups, read_collectives,
    reset_collectives, shard_batch,
)
from ray_tpu_torch.parallel.sharding import placements
from ray_tpu_torch.rllib.convert import params_from_jax as rl_params, to_numpy
from ray_tpu_torch.rllib.podracer import anakin as A

LR = 3e-4
BOOTSTRAP = "bootstrap"  # cases key: the HostGroupSpecs to bring the ranks up with
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ray_tpu")


class World:
    """``world`` spawned gloo ranks. They import torch and the port while
    the caller computes their inputs, then run the cases ``send`` hands
    them ({name: (function name, kwargs)}, passed through a file) and
    write their results; ``results`` waits for them and gives each
    rank's {name: result}, by rank. ``stop`` ends any rank still
    running."""

    DEADLINE = 180.0  # seconds from the spawn to the last rank's exit

    def __init__(self, world: int, tmp_path, deadline: float = DEADLINE):
        self.world, self.out, self.limit = world, str(tmp_path), deadline
        self.deadline = time.monotonic() + deadline
        self.ctx = mp.start_processes(_rank, args=(world, self.out), nprocs=world,
                                      start_method="spawn", join=False)

    def send(self, cases: dict) -> None:
        path = os.path.join(self.out, "cases.pkl")
        with open(path + ".tmp", "wb") as f:
            pickle.dump(cases, f)
        os.replace(path + ".tmp", path)

    def results(self) -> list:
        while not self.ctx.join(timeout=1):
            if time.monotonic() > self.deadline:
                alive = [r for r, p in enumerate(self.ctx.processes) if p.is_alive()]
                self.stop()
                raise TimeoutError(f"ranks {alive} of {self.world} still running "
                                   f"{self.limit:.0f} s after the spawn")
        loaded = []
        for r in range(self.world):
            with open(os.path.join(self.out, f"rank{r}.pkl"), "rb") as f:
                loaded.append(pickle.load(f))
        return loaded

    def stop(self) -> None:
        for p in self.ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(timeout=30)


def _rank(rank, world, out):
    torch.set_num_threads(1)
    path, deadline = os.path.join(out, "cases.pkl"), time.monotonic() + 600
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no cases in {path}")
        time.sleep(0.02)
    with open(path, "rb") as f:
        cases = pickle.load(f)
    specs = cases.pop(BOOTSTRAP, None)
    if specs is not None:
        bootstrap.initialize_host(specs[rank], "gloo")
    else:
        dist.init_process_group("gloo", store=dist.FileStore(os.path.join(out, "store"), world),
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=120))
    try:
        results = {name: globals()[fn](**kw) for name, (fn, kw) in cases.items()}
        results["jax_imported"] = sorted(m for m in sys.modules
                                         if m.split(".")[0] in FORBIDDEN)
    finally:
        if specs is not None:
            bootstrap.shutdown_host()
        else:
            dist.destroy_process_group()
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


def sleep(seconds):
    """A rank that hangs (for the deadline's test)."""
    time.sleep(seconds)


def _cfg(preset, overrides):
    return T.config(preset, dtype=torch.float32, param_dtype=torch.float32, **overrides)


def _np(tree):
    return {k: _np(v) if isinstance(v, dict) else v.detach().numpy().copy()
            for k, v in tree.items()}


def batch(tokens, mask=None):
    """A batch of tensors from numpy tokens and an optional loss_mask."""
    out = {"tokens": torch.from_numpy(tokens).long()}
    if mask is not None:
        out["loss_mask"] = torch.from_numpy(mask)
    return out


def train(preset, overrides, spec, state, tokens, mask=None, steps=3, routing=False,
          num_microbatches=None):
    """From the JAX train state ``state`` (numpy, state_from_jax under the
    mesh): the grads of the global loss at it (value_and_grad under the
    mesh, pipelined in ``num_microbatches`` under stage; with
    ``routing``, each MoE layer's routing of that forward),
    make_eval_step's metrics at it, then ``steps`` steps of
    make_train_step, with each step's metrics and collectives by kind,
    the params after the last step, and whether the leaves the step must
    leave alone (LoRA's base) are bit-unchanged."""
    cfg = _cfg(preset, overrides)
    mesh = build_mesh(MeshSpec(**spec), "cpu")
    opt = S.default_optimizer(cfg, lr=LR)
    st = state_from_jax(state, cfg, mesh=mesh)
    data = batch(tokens, mask)
    out = {"shapes": {"params": _shapes(st["params"]),
                      "mu": _shapes(st["opt_state"]["mu"]),
                      "nu": _shapes(st["opt_state"]["nu"])}}
    with record_routing(routing) as seen:
        (_, m), grads = S.value_and_grad(cfg, st["params"], data, mesh=mesh,
                                         num_microbatches=num_microbatches)
    out.update(grads=_np(grads), grad_metrics={k: float(v) for k, v in m.items()},
               routing=seen)
    out["eval"] = {k: float(v) for k, v in
                   S.make_eval_step(cfg, mesh, DEFAULT_RULES)(st["params"], data).items()}
    before = _np(st["params"])
    # JAX's positional order
    run = S.make_train_step(cfg, opt, mesh, DEFAULT_RULES, True, num_microbatches)
    out["metrics"], out["collectives"] = [], []
    for _ in range(steps):
        reset_collectives()
        st, m = run(st, data)
        out["collectives"].append(read_collectives())
        out["metrics"].append({k: float(v) for k, v in m.items()})
    out["params"] = _np(st["params"])
    out["frozen_unchanged"] = {
        p: bool(np.array_equal(a, _get(out["params"], p)))
        for p, a in _items(before) if cfg.lora_rank and not p.startswith("lora/")}
    out["step"] = (int(st["step"]), int(st["opt_state"]["count"]))
    return out


@contextlib.contextmanager
def record_routing(on=True):
    """While open (if ``on``), each MoE layer's routing (gate_idx, slot,
    keep as numpy, capacity) is appended to the list it yields."""
    seen, plain = [], T.moe_routing

    def spy(cfg_, x, router):
        r = plain(cfg_, x, router)
        seen.append({"gate_idx": r.gate_idx.numpy(), "slot": r.slot.numpy(),
                     "keep": r.keep.numpy(), "capacity": r.capacity})
        return r

    if on:
        T.moe_routing = spy
    try:
        yield seen
    finally:
        T.moe_routing = plain


def evaluate(preset, overrides, spec, params, tokens, mask=None):
    """make_eval_step's metrics under the mesh at the JAX params
    ``params`` (numpy, params_from_jax under the mesh)."""
    cfg = _cfg(preset, overrides)
    mesh = build_mesh(MeshSpec(**spec), "cpu")
    tparams = params_from_jax(params, cfg, mesh=mesh)
    return {k: float(v) for k, v in
            S.make_eval_step(cfg, mesh)(tparams, batch(tokens, mask)).items()}


def init(preset, overrides, spec, seed=0):
    """init_state(cfg, opt, mesh) with JAX's positional order: whether
    each leaf equals this rank's shard of the single-device init from the
    same seed, and the moments' shapes equal the params'."""
    cfg = _cfg(preset, overrides)
    mesh = build_mesh(MeshSpec(**spec), "cpu")
    opt = S.default_optimizer(cfg)
    st = S.init_state(cfg, opt, mesh)
    whole = S.init_state(cfg, opt, seed=seed, device="cpu")["params"]
    axes = T.param_axes(cfg)
    return {"leaf_is_shard": {p: bool(torch.equal(t, local_shard(mesh, _get(whole, p),
                                                                 _get(axes, p))))
                              for p, t in _items(st["params"])},
            "moments_like_params": _shapes(st["opt_state"]["mu"]) == _shapes(st["params"]),
            "spec_of_wi_gate": S.state_shardings(cfg, opt, mesh)["params"]["blocks"].get(
                "wi_gate")}


UNPORTED_MESHES = {"fsdp": {"fsdp": 8}, "tensor": {"data": 4, "tensor": 2},
                   "sequence": {"sequence": 8}, "stage": {"data": 4, "stage": 2},
                   "stage+sequence": {"stage": 2, "sequence": 4}}


def unported(preset):
    """The meshes the port took only with the pipeline slice, and the one
    it does not take, for the MoE ``preset`` (8 ranks), from every entry
    point: (axis, entry point) → the NotImplementedError's message, or
    None where it runs (``loss_fn`` on init_state's params and a batch of
    16 x 16 tokens). fsdp, tensor, sequence and stage run, and so does
    ``num_microbatches`` at data=8 (ignored without stages, as in JAX);
    "stage+sequence" raises, naming its ROADMAP row."""
    cfg = _cfg(preset, {})
    opt = S.default_optimizer(cfg)
    toks = torch.from_numpy(np.random.RandomState(0).randint(0, cfg.vocab_size, (16, 16)))
    out = {}
    for axis, spec in UNPORTED_MESHES.items():
        mesh = build_mesh(MeshSpec(**spec), "cpu")

        def loss():
            st = S.init_state(cfg, opt, mesh)
            m = 2 * spec["stage"] if "stage" in spec else None  # the default microbatches
            T.loss_fn(cfg, st["params"], shard_batch(mesh, {"tokens": toks}, None, m), mesh=mesh)

        calls = {"init_state": lambda: S.init_state(cfg, opt, mesh),
                 "make_train_step": lambda: S.make_train_step(cfg, opt, mesh),
                 "make_eval_step": lambda: S.make_eval_step(cfg, mesh),
                 "loss_fn": loss}
        for name, call in calls.items():
            try:
                call()
                out[(axis, name)] = None
            except NotImplementedError as e:
                out[(axis, name)] = str(e)
    mesh = build_mesh(MeshSpec(data=dist.get_world_size()), "cpu")
    try:
        S.make_train_step(cfg, opt, mesh, num_microbatches=2)
        out[("num_microbatches", "make_train_step")] = None
    except NotImplementedError as e:
        out[("num_microbatches", "make_train_step")] = str(e)
    return out


def divisibility(spec):
    """The ValueErrors of a pipeline at ``spec`` whose microbatches do not
    divide the batch: the step at 3 microbatches of 8 rows, and
    pipelined_layers on 7 rows (tests/test_moe_pipeline.py's call)."""
    cfg = _cfg("debug", {})
    mesh = build_mesh(MeshSpec(**spec), "cpu")
    opt = S.default_optimizer(cfg)
    out = {}
    try:
        S.make_train_step(cfg, opt, mesh, None, True, 3)(
            S.init_state(cfg, opt, mesh), {"tokens": np.zeros((8, 8), np.int32)})
    except ValueError as e:
        out["step"] = str(e)
    try:
        pipelined_layers(lambda p, x, pos: x, [{"w": torch.zeros(3)}], torch.zeros(7, 4, 8),
                         torch.arange(4), 3, 2)
    except ValueError as e:
        out["pipelined_layers"] = str(e)
    return out


def ring(q, k, v, do, causal=True):
    """ring_attention over the sequence group of ``MeshSpec(sequence=world)``
    on this rank's shard of the global q, k, v (numpy): its O, the grads
    of (O * do).sum() for its q, k, v shards, and the tensors it sent in
    the forward and in the backward."""
    world, rank = dist.get_world_size(), dist.get_rank()
    group = mesh_groups(build_mesh(MeshSpec(sequence=world), "cpu")).seq
    s = q.shape[1] // world

    def mine(a):
        return torch.from_numpy(np.ascontiguousarray(a[:, rank * s:(rank + 1) * s]))

    tq, tk, tv = (mine(a).requires_grad_() for a in (q, k, v))
    reset_collectives()
    o = ring_attention(tq, tk, tv, group, causal)
    sent_fwd = read_collectives()["send"]
    reset_collectives()
    (o * mine(do)).sum().backward()
    return {"o": o.detach().numpy(), "dq": tq.grad.numpy(), "dk": tk.grad.numpy(),
            "dv": tv.grad.numpy(), "sent": (sent_fwd, read_collectives()["send"])}


CHECKPOINT_MESHES = {"fsdp4_tp2": {"fsdp": 4, "tensor": 2},
                     "dp2_st2_tp2": {"data": 2, "stage": 2, "tensor": 2}}


def checkpoint(preset, state, directory):
    """The train state ``state`` (numpy, as state_from_jax takes it)
    under ``MeshSpec(fsdp=world)``, saved with its shardings to
    ``directory``, then restored onto each mesh of CHECKPOINT_MESHES with
    that mesh's shardings (the first from DCP's metadata, the second
    into a meta target): this rank's leaves of each, by path, as numpy.
    Each restored state is saved again under its mesh, to ``directory``
    + "_" + the mesh's name (shards replicated over data and cut over
    stage). Also the error of a layout that cuts one dim over two mesh
    axes."""
    cfg = _cfg(preset, {})
    opt = S.default_optimizer(cfg, lr=LR)
    m1 = build_mesh(MeshSpec(fsdp=dist.get_world_size()), "cpu")
    S.save_state(state_from_jax(state, cfg, mesh=m1), directory,
                 shardings=S.state_shardings(cfg, opt, m1), mesh=m1)
    meta = state_from_jax(state, cfg, device="meta")
    out = {}
    for i, (name, spec) in enumerate(CHECKPOINT_MESHES.items()):
        m2 = build_mesh(MeshSpec(**spec), "cpu")
        sh = S.state_shardings(cfg, opt, m2)
        st = S.restore_state(directory, meta if i else None, sh, mesh=m2)
        out[name] = {p: t.numpy() for p, t in _items(st)}
        S.save_state(st, f"{directory}_{name}", shardings=sh, mesh=m2)
        out[name + "_spec_of_wq"] = sh["params"]["blocks"]["wq"]
    try:
        placements((("data", "tensor"),), m2)
    except NotImplementedError as e:
        out["two_axes"] = str(e)
    return out


def collective_input(seed, rank, shape=(8, 3)):
    """Rank ``rank``'s input to the collective cases: float32 in [0.5, 1.5)
    (a product of a few stays near 1)."""
    return (np.random.RandomState(seed + rank).random_sample(shape) + 0.5).astype(np.float32)


def collectives(seed):
    """Every op of ray_tpu_torch.util.collective over the world, on two
    named groups at once, with each rank's ``collective_input``: results
    as numpy, by (op, reduce op). Also send/recv round the ring, async
    allreduces mixed with sync ops (each async input overwritten right
    after its submission), a destroyed and re-made group, and the typed
    errors, each as its type name and message."""
    from ray_tpu_torch.util import collective as col

    world, rank = dist.get_world_size(), dist.get_rank()
    col.init_collective_group(world, rank, "gloo", "a")
    col.init_collective_group(world, rank, "gloo", "b")
    x = collective_input(seed, rank)
    parts = [x, 2 * x]
    out = {"rank": (col.get_rank("a"), col.get_collective_group_size("b"),
                    col.is_group_initialized("a"), col.get_rank("nope"))}
    for op in ("sum", "product", "max", "min", "mean"):
        out[("allreduce", op)] = col.allreduce(x, "a", op).numpy()
        out[("reducescatter", op)] = col.reducescatter(x, "b", op).numpy()
        out[("allreduce_parts", op)] = col.allreduce(parts, "b", op).numpy()
        out[("reducescatter_parts", op)] = col.reducescatter(parts, "a", op).numpy()
    out["allgather"] = col.allgather(torch.from_numpy(x), "a").numpy()
    out["allgather_parts"] = col.allgather(parts, "b").numpy()
    out["allreduce_int"] = col.allreduce(np.arange(4, dtype=np.int32) + rank, "a").numpy()
    out["broadcast"] = col.broadcast(x, 2, "a").numpy()
    out["x_unchanged"] = bool(np.array_equal(x, collective_input(seed, rank)))
    # send/recv round the ring: even ranks send first, odd ranks receive first
    nxt, prv = (rank + 1) % world, (rank - 1) % world
    if rank % 2 == 0:
        col.send(x[rank], nxt, "a")
        out["recv"] = col.recv(prv, "a").numpy()
    else:
        out["recv"] = col.recv(prv, "a").numpy()
        col.send(x[rank], nxt, "a")
    # async allreduces between sync ops, on one group, in submission order
    buf = x.copy()
    h1 = col.async_allreduce(buf, "b")
    buf[:] = 0  # the op took a snapshot
    mid = col.allreduce(3 * x, "b", "max")
    tb = torch.from_numpy(5 * x)
    h2 = col.async_allreduce(tb, "b", "min")
    tb.zero_()
    col.barrier("b")
    out["async"] = (h1.result(60).numpy(), mid.numpy(), h2.result(60).numpy(),
                    h1.done() and h2.done())
    col.destroy_collective_group("a")
    out["destroyed"] = (col.is_group_initialized("a"), col.get_rank("a"))
    col.init_collective_group(world, rank, "gloo", "a")
    out["remade"] = col.allreduce(x, "a").numpy()
    errors = {}
    for name, call in (("uninitialized", lambda: col.allreduce(x, "nope")),
                       ("wrong_rank", lambda: col.init_collective_group(
                           world, (rank + 1) % world, "gloo", "c")),
                       ("too_big", lambda: col.init_collective_group(world + 1, rank, "gloo", "c")),
                       ("twice", lambda: col.init_collective_group(world, rank, "gloo", "a")),
                       ("objstore", lambda: col.init_collective_group(world, rank, "objstore", "c")),
                       ("actors", lambda: col.create_collective_group([], world, [],
                                                                      "objstore", "c")),
                       ("reducescatter_shape", lambda: col.reducescatter(x[:3], "a"))):
        try:
            call()
            errors[name] = None
        except Exception as e:  # noqa: BLE001 — the test reads the type
            errors[name] = (type(e).__name__, str(e))
    out["errors"] = errors
    out["c_initialized"] = col.is_group_initialized("c")
    col.barrier("a")
    col.destroy_collective_group("a")
    col.destroy_collective_group("b")
    return out


def anakin(cfg, params, traj):
    """Anakin over the data axis of the world (``cfg``: AnakinConfig's
    fields): ``learn`` from ``params`` (numpy) on this rank's envs of the
    global trajectory ``traj`` (numpy [T, num_envs], last_obs [num_envs,
    4]), its params after and its metrics; then one ``train()`` of its
    own (rollout of this rank's envs from the broadcast init), its params
    after and what it reports; the ValueError of envs that do not split
    over the ranks; an Anakin at max_devices=1, alone; and the error of
    a data axis over part of the group."""
    world, rank = dist.get_world_size(), dist.get_rank()
    algo = A.Anakin(A.AnakinConfig(**cfg), device="cpu")
    per = cfg["num_envs"] // world
    cut = slice(rank * per, (rank + 1) * per)
    mine = {k: torch.from_numpy(np.ascontiguousarray(v[cut] if k == "last_obs" else v[:, cut]))
            for k, v in traj.items()}
    params = rl_params(params, "cpu")
    metrics = algo.learn(params, algo.tx.init(params), mine)
    out = {"params": to_numpy(params), "metrics": {k: float(v) for k, v in metrics.items()},
           "num_devices": algo.num_devices, "envs": tuple(algo._env[0].shape),
           "init": to_numpy(algo.params)}
    report = algo.train()
    out["trained"] = to_numpy(algo.params)
    out["report"] = {k: v for k, v in report.items() if k != "stage_s"}
    try:
        A.Anakin(A.AnakinConfig(**dict(cfg, num_envs=cfg["num_envs"] + 2)), device="cpu")
    except ValueError as e:
        out["indivisible"] = str(e)
    out["alone"] = A.Anakin(A.AnakinConfig(**dict(cfg, num_envs=3, max_devices=1)),
                            device="cpu").num_devices
    try:
        A.Anakin(A.AnakinConfig(**dict(cfg, max_devices=2)), device="cpu")
    except NotImplementedError as e:
        out["part_of_the_group"] = str(e)
    return out


def _items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _items(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _shapes(tree):
    return {p: tuple(t.shape) for p, t in _items(tree)}


# ---------------------------------------------------------------------------
# Worker groups on the port's cluster (tests/test_torch_worker_group.py)
# ---------------------------------------------------------------------------
def _dump(directory, name, obj):
    path = os.path.join(directory, f"{name}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(obj, f)
    os.replace(path + ".tmp", path)


def group_train(config):
    """TorchTrainer's loop in each TrainWorker of a group: ``train``'s case
    ``config["case"]`` at this worker's rank, with what the worker saw
    (its context's rank and world size, the process group's backend,
    rank and size, its CUDA_VISIBLE_DEVICES, the forbidden modules it
    imported), written to ``config["out"]/rank{r}.pkl``; rank 0's last
    loss reported."""
    torch.set_num_threads(1)
    ctx = S.get_context()
    out = train(**config["case"])
    out["seen"] = {"rank": ctx.get_world_rank(), "world": ctx.get_world_size(),
                   "backend": dist.get_backend(), "dist": (dist.get_rank(), dist.get_world_size()),
                   "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                   "jax_imported": sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)}
    _dump(config["out"], f"rank{ctx.get_world_rank()}", out)
    S.report({"loss": out["metrics"][-1]["loss"], "rank": ctx.get_world_rank()})


def state_np(tree):
    """A train state's leaves as numpy copies, by path."""
    return {p: t.detach().numpy().copy() for p, t in _items(tree)}


def group_resume(config):
    """A loop over the group's data mesh that saves the train state after
    every step (every rank calls save_state; rank 0 reports the
    checkpoint) and, on the first attempt only, raises on rank
    ``config["fail_rank"]`` after step ``config["fail_after"]``'s save; a
    retry restores the latest checkpoint. Each rank records each attempt
    (the first step it ran, its losses, the state it started from and
    each state it saved, as numpy) in
    ``config["out"]/rank{r}_attempt{a}.pkl``."""
    torch.set_num_threads(2)
    torch.use_deterministic_algorithms(True)  # the CPU embedding backward
    ctx = S.get_context()
    rank, world = ctx.get_world_rank(), ctx.get_world_size()
    cfg = _cfg(config["preset"], {})
    mesh = build_mesh(MeshSpec(data=world), "cpu")
    opt = S.default_optimizer(cfg, lr=LR)
    sh = S.state_shardings(cfg, opt, mesh)
    ck = S.get_checkpoint()
    st = (state_from_jax(config["state"], cfg, mesh=mesh) if ck is None
          else S.restore_state(os.path.join(ck.path, "state"), None, sh, mesh=mesh))
    run = S.make_train_step(cfg, opt, mesh)
    data = batch(config["tokens"])
    rec = {"start": int(st["step"]), "restored_from": ck.path if ck else None,
           "start_state": state_np(st), "losses": [], "saved": []}
    attempt = 0 if ck is None else 1
    marker = os.path.join(config["out"], "failed_once")
    try:
        for i in range(int(st["step"]), config["steps"]):
            st, m = run(st, data)
            rec["losses"].append(float(m["loss"]))
            d = os.path.join(config["out"], f"step{i}")
            S.save_state(st, os.path.join(d, "state"), shardings=sh, mesh=mesh)
            rec["saved"].append(state_np(st))
            S.report({"loss": rec["losses"][-1], "step": i},
                     checkpoint=S.Checkpoint(d) if rank == 0 else None)
            if i == config["fail_after"] and rank == config["fail_rank"] \
                    and not os.path.exists(marker):
                open(marker, "w").close()
                raise RuntimeError(f"rank {rank} preempted after step {i}")
    finally:
        _dump(config["out"], f"rank{rank}_attempt{attempt}", rec)


class CollectiveMember:
    """An actor of ``create_collective_group``'s tests: its rank's
    ``collective_input`` through every op of ray_tpu_torch.util.collective
    on the group it was made a member of (an OBJSTORE group answers in
    numpy and stands on no process group)."""

    def ops(self, group, seed):
        from ray_tpu_torch.util import collective as col

        def host(t):
            if isinstance(t, torch.Tensor):
                return t.numpy()
            return np.stack(t) if isinstance(t, list) else t

        rank, world = col.get_rank(group), col.get_collective_group_size(group)
        x = collective_input(seed, rank)
        out = {"rank": rank, "world": world, "pid": os.getpid(),
               "backend": dist.get_backend() if dist.is_initialized() else None}
        for op in ("sum", "product", "max", "min", "mean"):
            out[("allreduce", op)] = host(col.allreduce(x, group, op))
            out[("reducescatter", op)] = host(col.reducescatter(x, group, op))
        out["allgather"] = host(col.allgather(x, group))
        out["broadcast"] = host(col.broadcast(x, world - 1, group))
        nxt, prv = (rank + 1) % world, (rank - 1) % world
        if rank % 2 == 0:
            col.send(x[rank], nxt, group)
            out["recv"] = host(col.recv(prv, group))
        else:
            out["recv"] = host(col.recv(prv, group))
            col.send(x[rank], nxt, group)
        col.barrier(group)
        col.destroy_collective_group(group)
        out["destroyed"] = col.is_group_initialized(group)
        return out
