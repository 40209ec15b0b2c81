"""The ranks of the port's sharded-step tests (tests/test_torch_sharded_step*.py).

``World`` spawns one group of gloo ranks on the CPU, brought up over a
FileStore in a temporary directory (no TCP port), and runs every case of
a test file in it: a case is a function of this module, named with its
keyword arguments (numpy inputs: tokens, masks, the JAX train state).
Each rank returns its results as numpy, collected per rank.
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
from ray_tpu_torch.parallel import (
    DEFAULT_RULES, MeshSpec, build_mesh, local_shard, read_collectives,
    reset_collectives,
)

LR = 3e-4
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ray_tpu")


class World:
    """``world`` spawned gloo ranks. They import torch and the port while
    the caller computes their inputs, then run the cases ``send`` hands
    them ({name: (function name, kwargs)}, passed through a file) and
    write their results; ``results`` waits for them and gives each
    rank's {name: result}, by rank. ``stop`` ends any rank still
    running."""

    def __init__(self, world: int, tmp_path):
        self.world, self.out = world, str(tmp_path)
        self.ctx = mp.start_processes(_rank, args=(world, self.out), nprocs=world,
                                      start_method="spawn", join=False)

    def send(self, cases: dict) -> None:
        path = os.path.join(self.out, "cases.pkl")
        with open(path + ".tmp", "wb") as f:
            pickle.dump(cases, f)
        os.replace(path + ".tmp", path)

    def results(self) -> list:
        while not self.ctx.join():
            pass
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
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(out, "store"), world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        results = {name: globals()[fn](**kw) for name, (fn, kw) in cases.items()}
        results["jax_imported"] = sorted(m for m in sys.modules
                                         if m.split(".")[0] in FORBIDDEN)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


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


def train(preset, overrides, spec, state, tokens, mask=None, steps=3, routing=False):
    """From the JAX train state ``state`` (numpy, state_from_jax under the
    mesh): the grads of the global loss at it (value_and_grad under the
    mesh; with ``routing``, each MoE layer's routing of that forward),
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
        (_, m), grads = S.value_and_grad(cfg, st["params"], data, mesh=mesh)
    out.update(grads=_np(grads), grad_metrics={k: float(v) for k, v in m.items()},
               routing=seen)
    out["eval"] = {k: float(v) for k, v in
                   S.make_eval_step(cfg, mesh, DEFAULT_RULES)(st["params"], data).items()}
    before = _np(st["params"])
    run = S.make_train_step(cfg, opt, mesh, DEFAULT_RULES)  # JAX's positional order
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


def unported(preset):
    """The error each mesh the port does not take yet raises, from every
    entry point: (axis, entry point) → the message."""
    cfg = _cfg(preset, {})
    opt = S.default_optimizer(cfg)
    world = dist.get_world_size()
    toks = torch.zeros((world, 8), dtype=torch.long)
    out = {}
    for axis in ("fsdp", "tensor", "sequence", "stage"):
        mesh = build_mesh(MeshSpec(**{axis: world}), "cpu")
        calls = {"init_state": lambda: S.init_state(cfg, opt, mesh),
                 "make_train_step": lambda: S.make_train_step(cfg, opt, mesh),
                 "make_eval_step": lambda: S.make_eval_step(cfg, mesh),
                 "loss_fn": lambda: T.loss_fn(cfg, {}, {"tokens": toks}, mesh=mesh)}
        for name, call in calls.items():
            try:
                call()
                out[(axis, name)] = None
            except NotImplementedError as e:
                out[(axis, name)] = str(e)
    mesh = build_mesh(MeshSpec(data=world), "cpu")
    try:
        S.make_train_step(cfg, opt, mesh, num_microbatches=2)
        out[("num_microbatches", "make_train_step")] = None
    except NotImplementedError as e:
        out[("num_microbatches", "make_train_step")] = str(e)
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
