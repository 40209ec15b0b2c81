"""The pytest-process half of the port's sharded-step tests
(tests/test_torch_sharded_step*.py): the JAX reference on the 8-device
CPU mesh, the port's single-device references, and the checks that hold
the ranks (tests/torch_ranks.py) to them. fp32 params and compute.

Tolerances: loss, accuracy and grad_norm 2e-5; grads 5e-5
(tests/test_ops.py's fp32 tolerances); params after the steps as
tests/test_torch_train.py holds them (2e-7 abs + 1e-5 rel, with elements
at reassociation noise bounded by 2·lr·steps and under 0.1%).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

import torch_ranks
from ray_tpu.models import transformer as JT
from ray_tpu.parallel.mesh import MeshSpec, build_mesh
from ray_tpu.train import step as JS
from ray_tpu_torch import train as S
from ray_tpu_torch.models import transformer as T
from ray_tpu_torch.models.convert import params_from_jax, state_from_jax
from ray_tpu_torch.parallel import AXIS_ORDER, spec_for
from ray_tpu_torch.parallel.sharding import effective_rules

ATOL, GRAD_ATOL = 2e-5, 5e-5
LR, STEPS, WORLD = torch_ranks.LR, 3, 8


def tokens(vocab, b=8, s=64, seed=0):
    """tests/test_models_train.py's and tests/test_moe_pipeline.py's tokens."""
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(np.int32)


def configs(preset, **kw):
    return (JT.config(preset, dtype=jnp.float32, param_dtype=jnp.float32, **kw),
            T.config(preset, dtype=torch.float32, param_dtype=torch.float32, **kw))


def np_state(jstate, lora=False):
    """The JAX train state as state_from_jax takes it (LoRA: the moments
    of the adapters only, the MaskedNodes of the frozen leaves pruned)."""
    opt = jstate["opt_state"]
    mu, nu = (jax.tree.map(np.array, optax.tree_utils.tree_get(opt, n)) for n in ("mu", "nu"))
    if lora:
        mu, nu = {"lora": mu["lora"]}, {"lora": nu["lora"]}
    return {"params": jax.tree.map(np.array, jstate["params"]), "mu": mu, "nu": nu,
            "count": np.asarray(optax.tree_utils.tree_get(opt, "count")),
            "step": np.asarray(jstate["step"])}


def port_np_state(tcfg, seed=0):
    """The port's own init (init_state on the CPU) as state_from_jax
    takes a state: numpy params, moments of the trainable leaves, count
    and step."""
    st = S.init_state(tcfg, S.default_optimizer(tcfg, lr=LR), seed=seed, device="cpu")

    def np_tree(t):
        return {k: np_tree(v) if isinstance(v, dict) else v.numpy() for k, v in t.items()}

    opt = st["opt_state"]
    return {"params": np_tree(st["params"]), "mu": np_tree(opt["mu"]),
            "nu": np_tree(opt["nu"]), "count": opt["count"].numpy(),
            "step": st["step"].numpy()}


def items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from items(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def jax_run(jcfg, mesh, jstate, batch, steps=STEPS, with_eval=True, num_microbatches=None):
    """JAX's eval metrics at ``jstate`` (unless not ``with_eval``) and each
    of ``steps`` steps' metrics (pipelined in ``num_microbatches`` under a
    stage axis); the params after them."""
    ev = JS.make_eval_step(jcfg, mesh)(jstate["params"], batch) if with_eval else {}
    step = JS.make_train_step(jcfg, JS.default_optimizer(jcfg, lr=LR), mesh, donate=False,
                              num_microbatches=num_microbatches)
    metrics = []
    for _ in range(steps):
        jstate, m = step(jstate, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"eval": {k: float(v) for k, v in ev.items()}, "metrics": metrics,
            "params": dict(items(jax.tree.map(np.array, jstate["params"]))),
            "state": jstate}


def single_device(tcfg, np_params, batch, record_routing=False, stages=1,
                  num_microbatches=None):
    """The port's single-device value_and_grad on the global batch: its
    metrics, grads by path and (optionally) each MoE layer's routing.
    With ``stages``, of the pipeline of that many stages run in one
    process (``num_microbatches``)."""
    tbatch = torch_ranks.batch(batch["tokens"], batch.get("loss_mask"))
    with torch_ranks.record_routing(record_routing) as seen:
        (_, m), grads = S.value_and_grad(tcfg, params_from_jax(np_params, tcfg, "cpu"), tbatch,
                                         num_microbatches=num_microbatches, stages=stages)
    return {"metrics": {k: float(v) for k, v in m.items()}, "grads": dict(items(grads)),
            "routing": seen}


def port_steps(tcfg, state, batch, steps=STEPS, **kw):
    """``steps`` steps of the port's single-device step (``kw``: its
    options, a pipeline run in one process among them) from ``state``
    (numpy, as state_from_jax takes it): each step's metrics and the
    params after them, by path.

    The reference for params after a pipelined step: JAX's pipelined
    step reaches its unpipelined step's params only within its own
    reassociation noise, with 0.16% of ``debug``'s wq elements an Adam
    step apart at data=2 x stage=2 x tensor=2 (more than
    ``params_close`` allows), where the port's pipelined step puts
    0.009% of them apart from JAX's unpipelined one
    (tests/pipeline_numbers.py measures both)."""
    st = state_from_jax(state, tcfg, device="cpu")
    run = S.make_train_step(tcfg, S.default_optimizer(tcfg, lr=LR), device="cpu", **kw)
    tbatch = torch_ranks.batch(batch["tokens"], batch.get("loss_mask"))
    metrics = [{k: float(v) for k, v in run(st, tbatch)[1].items()} for _ in range(steps)]
    return {"metrics": metrics,
            "params": {p: t.numpy() for p, t in items(st["params"])}}


def dp_world(preset, kw, tmp_path, references=True):
    """A data-parallel case at MeshSpec(data=8): the ranks' train case
    (spawned first, so they start up while JAX compiles), JAX's run and,
    with ``references``, JAX's eval and the single-device grads."""
    world = torch_ranks.World(WORLD, tmp_path)
    try:
        jcfg, tcfg = configs(preset, **kw)
        mesh = build_mesh(MeshSpec(data=-1))
        jstate = JS.init_state(jcfg, JS.default_optimizer(jcfg, lr=LR), mesh, seed=0)
        state0, toks = np_state(jstate, bool(tcfg.lora_rank)), tokens(jcfg.vocab_size)
        world.send({"case": ("train", dict(preset=preset, overrides=kw, spec={"data": WORLD},
                                           state=state0, tokens=toks, steps=STEPS))})
        ref = jax_run(jcfg, mesh, jstate, {"tokens": toks}, with_eval=references)
        if references:
            ref["single"] = single_device(tcfg, state0["params"], {"tokens": toks})
        ref["params0"] = dict(items(state0["params"]))
        done = world.results()
    finally:
        world.stop()
    return {"ranks": [r["case"] for r in done], "jax": ref,
            "jax_imported": [r["jax_imported"] for r in done]}


def params_close(a, b, steps):
    d = np.abs(a - b)
    noisy = d > 2e-7 + 1e-5 * np.abs(b)
    return d.max() <= 2 * LR * steps + 1e-6 and noisy.mean() < 1e-3


def check_metrics(ranks, jax_metrics):
    """Each step's loss, accuracy, grad_norm and tokens, on every rank,
    against JAX's sharded step; the loss falls."""
    for rank, r in enumerate(ranks):
        for i, (m, jm) in enumerate(zip(r["metrics"], jax_metrics)):
            for k in ("loss", "accuracy", "grad_norm", "tokens"):
                np.testing.assert_allclose(m[k], jm[k], atol=ATOL,
                                           err_msg=f"rank {rank} step {i} {k}")
        assert r["metrics"][-1]["loss"] < r["metrics"][0]["loss"]
        assert r["step"] == (len(jax_metrics),) * 2


def check_params(ranks, jax_params, shard, steps=STEPS):
    """Each rank's params after the steps: ``shard(path, whole, rank)`` of
    JAX's."""
    for rank, r in enumerate(ranks):
        for path, a in items(r["params"]):
            b = shard(path, jax_params[path], rank)
            assert a.shape == b.shape, (rank, path)
            assert params_close(a, b, steps), (rank, path)


def check_params_of_leaves(ranks, jax_params, shard, steps=STEPS):
    """``check_params`` for leaves cut into small shards: each rank's
    shard has JAX's shape, every element is within the per-element
    bounds of ``params_close``, and the share of elements at
    reassociation noise is taken over all ranks' shards of a leaf
    together (the whole leaf, as tests/test_torch_train.py counts it),
    not over each shard, where a few such elements of a 2,048-element
    shard would exceed it."""
    pairs = {}
    for rank, r in enumerate(ranks):
        for path, a in items(r["params"]):
            b = shard(path, jax_params[path], rank)
            assert a.shape == b.shape, (rank, path)
            pairs.setdefault(path, []).append((a.ravel(), b.ravel()))
    for path, ab in pairs.items():
        a, b = (np.concatenate(x) for x in zip(*ab))
        assert params_close(a, b, steps), path


def check_grads(ranks, single, shard):
    """Every rank's global loss and grads (value_and_grad under the mesh)
    against ``shard(path, whole, rank)`` of the single-device ones."""
    for rank, r in enumerate(ranks):
        for k in ("loss", "accuracy", "tokens"):
            np.testing.assert_allclose(r["grad_metrics"][k], single["metrics"][k],
                                       atol=ATOL, err_msg=f"rank {rank} {k}")
        for path, g in items(r["grads"]):
            np.testing.assert_allclose(g, shard(path, single["grads"][path].numpy(), rank),
                                       atol=GRAD_ATOL, err_msg=f"rank {rank} {path}")


def check_grads_scaled(ranks, single, shard):
    """``check_grads``, and every grad within 1e-4 of its leaf's largest
    (single-device) grad: a grad summed twice over a group shows on
    leaves whose grads are too small for the absolute bound."""
    check_grads(ranks, single, shard)
    for rank, r in enumerate(ranks):
        for path, g in items(r["grads"]):
            ref = shard(path, single["grads"][path].numpy(), rank)
            assert np.abs(g - ref).max() <= 1e-4 * np.abs(ref).max(), (rank, path)


def check_eval(ranks, jax_eval):
    for r in ranks:
        for k, v in jax_eval.items():
            np.testing.assert_allclose(r["eval"][k], v, atol=ATOL, err_msg=k)


def design_collectives(cfg, units, masked, n_seq=1):
    """The collectives a train step issues by kind under a mesh, as the
    design lays them out (ray_tpu_torch/parallel/collectives.py), for L
    layers each run R times forward (2 under remat: the re-run) and U
    grad tensors (one a leaf, a stacked leaf one a layer):

    - all_gather: per block run, each leaf cut over fsdp the block reads
      (wq, wk, wv, wo, wi_gate, wi_up, wo_mlp; MoE's router; LoRA's
      wq_a, wv_a and, dense only, wi_a), and MoE's tokens (over the
      sequence group, then the batch group); the embedding
      table twice (lookup and unembedding: unembed, or embed when tied);
      the sequence shards' first tokens for the loss;
    - reduce_scatter: one per gather of a leaf or of MoE's tokens, in the
      backward;
    - all_reduce: per block run, attention's ``wo`` and the MLP's
      ``wo_mlp`` partials (MoE: the expert combine), but for the dense
      MLP's in the re-run, which stops once it has recomputed what the
      backward saved (torch's non-reentrant checkpoint stops early, and
      nothing saves that sum's output); per block in the
      backward, the attention and MLP inputs' grads (MoE: the expert
      input's) and LoRA's x·A grads; the embedding's vocab partials and
      the unembedding input's grad; the loss's max, partial sums and
      argmax min over tensor, its metrics and, with a loss_mask, the mask
      sum; U grads; the norm;
    - send: ring attention over n_seq ranks, per layer 2(n-1) tensors
      (K, V) a forward run and 2(n-1) + 2n in the backward (dK, dV
      accumulators home too).
    """
    R, L = (2 if cfg.remat else 1), cfg.layers
    moe = bool(cfg.num_experts)
    lora = (2 if moe else 3) if cfg.lora_rank else 0
    leaves = 7 + moe + lora
    ring = 0 if n_seq == 1 else R * 2 * (n_seq - 1) + 4 * n_seq - 2
    return {"all_gather": R * L * (leaves + 2 * moe) + 3,
            "reduce_scatter": L * (leaves + 2 * moe) + 2,
            "all_reduce": (2 * R - (R - 1) * (not moe)) * L + (2 + lora) * L + 2 + 4
            + int(masked) + units + 1,
            "send": L * ring}


def mesh_shard(tcfg, spec):
    """``shard(path, whole, rank)``: rank ``rank``'s shard of a whole leaf
    (numpy) of ``tcfg``'s params at the mesh ``spec`` (a sizes mapping),
    ranks laid out as build_mesh lays them (a reshape in AXIS_ORDER); a
    layer-stacked leaf cut over stage when it is above 1."""
    sizes = {a: spec.get(a, 1) for a in AXIS_ORDER}
    axes = dict(items(T.param_axes(tcfg)))
    rules = effective_rules(sizes)

    def shard(path, a, rank):
        coord = dict(zip(AXIS_ORDER, np.unravel_index(rank, [sizes[x] for x in AXIS_ORDER])))
        for dim, entry in enumerate(spec_for(axes[path], rules, sizes)):
            if entry is None:
                continue
            index, count = 0, 1
            for name in (entry,) if isinstance(entry, str) else entry:
                index, count = index * sizes[name] + coord[name], count * sizes[name]
            part = a.shape[dim] // count
            a = np.take(a, np.arange(index * part, (index + 1) * part), axis=dim)
        return a

    return shard


def whole(path, a, rank):
    """No leaf is cut over data."""
    return a


CAPACITY = {"cf125": 1.25, "cf05": 0.5}  # case name → moe_debug's capacity factor


def moe_world(spec, tmp_path, num_microbatches=None, mask=None, cases=tuple(CAPACITY)):
    """moe_debug at the mesh ``spec`` at the capacity factors of
    ``cases`` (names of CAPACITY: 1.25, and 0.5 with forced drops), from
    one JAX init: each case's ranks (spawned first),
    JAX's sharded step (pipelined in ``num_microbatches`` under stage) and
    eval, and the port's single-device grads and routing on the global
    batch; under stage also those of the port's pipeline run in one
    process (its stages in turn), whose MoE layers route each microbatch
    on its own, as JAX's pipeline does (with its params after the steps:
    ``port_steps``)."""
    world = torch_ranks.World(WORLD, tmp_path)
    try:
        jcfg, _ = configs("moe_debug")
        mesh = build_mesh(MeshSpec(**spec))
        jstate = JS.init_state(jcfg, JS.default_optimizer(jcfg, lr=LR), mesh, seed=0)
        state0 = np_state(jstate)
        batch = {"tokens": tokens(jcfg.vocab_size)}
        if mask is not None:
            batch["loss_mask"] = mask
        world.send({name: ("train", dict(preset="moe_debug", overrides={"capacity_factor": cf},
                                         spec=spec, state=state0, tokens=batch["tokens"],
                                         mask=mask, steps=STEPS, routing=True,
                                         num_microbatches=num_microbatches))
                    for name, cf in CAPACITY.items() if name in cases})
        ref = {}
        for name in cases:
            cf = CAPACITY[name]
            jc, tc = configs("moe_debug", capacity_factor=cf)
            # JAX's eval outside a pipeline is its step 0's metrics (the same
            # params and routing): compiled only under stage, where its eval
            # routes the whole batch and its step each microbatch
            ref[name] = jax_run(jc, mesh, jstate, batch, with_eval=spec.get("stage", 1) > 1,
                                num_microbatches=num_microbatches)
            ref[name]["tcfg"] = tc
            ref[name]["single"] = single_device(tc, state0["params"], batch, True)
            if spec.get("stage", 1) > 1:
                ref[name]["staged"] = single_device(tc, state0["params"], batch, True,
                                                    spec["stage"], num_microbatches)
                ref[name]["staged_steps"] = port_steps(tc, state0, batch, stages=spec["stage"],
                                                       num_microbatches=num_microbatches)
        return {"ranks": world.results(), "jax": ref, "spec": spec}
    finally:
        world.stop()
