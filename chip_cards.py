"""Four-card run of the PyTorch/CUDA port's multi-rank paths, through its
own entry points, on one host of NVIDIA GPUs.

    python3 chip_cards.py          # needs 4 cards

Builds the port's CUDA kernels from this checkout, starts a one-node
cluster (ray_tpu_torch.init(): its raylet leases the cards, one a
worker, through CUDA_VISIBLE_DEVICES) and holds:

- cards: TorchTrainer(num_workers=4, use_gpu=True) gives each TrainWorker
  a distinct card (CUDA_VISIBLE_DEVICES and card UUID), and the workers
  one NCCL process group of 4;
- the fp32 cases of tests/torch_ranks.py at world 4, run in those
  workers over NCCL: debug at data=4, fsdp=2 x tensor=2, data=2 x stage=2
  (2 microbatches) and sequence=4, and moe_debug at data=2 x expert=2,
  each from one init (the port's, seed 0) on tests/sharded_step_ref.py's
  tokens: the global loss's metrics and grads at the init (2e-5 on
  metrics, 5e-5 on grads, tests/test_ops.py's fp32 tolerances) and the
  params after 3 steps (the tests' rule: every element within 2·lr·steps
  of the reference, under 0.1% of a leaf's elements past 2e-7 + 1e-5
  relative), each rank's shard against the single-card run on this
  process's card; step 0's metrics within 2e-5 and the later steps'
  losses printed;
- the collectives: create_collective_group over 4 num_gpus=1 actors on
  NCCL, every op of ray_tpu_torch.util.collective against numpy
  (allreduce SUM/PRODUCT/MIN/MAX/MEAN, allgather, reducescatter,
  broadcast from rank 2, send/recv round the ring, barrier), and a 256 MB
  bf16 allreduce's time and bus bandwidth, 2·(n−1)/n·bytes/time;
- elastic sizing: ScalingConfig(num_workers=8, min_workers=2,
  use_gpu=True) sized to 4 from the cluster's totals, and that fit:
  llama2_7b_lora at full width (bf16, remat) at MeshSpec(data=4), 8 rows
  of 2,048 tokens a rank, 2 warm-up, 3 timed and 1 profiled step a rank:
  step ms, tokens/s, MFU (6·N·tokens/s over 4 cards' peak), flash
  launches a step (64/32/32) and the NCCL device ms of a step, per rank;
  against one card's step in this process first (the same model, seed
  and 8 rows);
- disaggregated prefill on two cards: a STRICT_PACK placement group of
  two {"GPU": 1} bundles, llama3_8b's prefill replica on one card and its
  decode replica on another (DisaggPrefillEngine, each replica a worker
  process drawing the seed-0 weights), the 8 serving prompts' fp32 KV
  rows (536,870,912 B) crossing processes through the shared-memory
  TensorChannel: tokens equal a single-process PagedBatcher's, no
  prefill in the decode replica, 32 x 8 flash launches all in the
  prefill replica's process; ms a row hand-off;
- Sebulba with two learners (sebulba_two_learners): the JAX package's
  4-actor point (4 pod actors, 2 learners, each learner on a card it
  leases, a cross-learner broadcast over the OBJSTORE backend every 2nd
  train()): both learners' params bit-equal after each sync, no order or
  app errors, and a kill of learner 1 right before a broadcast giving one
  group rotation and one restart with no app error; env steps/s beside
  the one-learner 2-actor point (chip_smoke.SEBULBA) measured in the same
  run;
- batch inference over two nodes of one card each (data_cluster_two_cards,
  a Cluster of its own after the one-node cluster above): llama3_8b
  through build_llm_processor with one pool actor, then two, each engine
  on its own physical card: rows bit-equal, rows/s of two against one.

Prints JSON lines and the cards' names and power limits; any failed gate
raises and the script exits non-zero. Without 4 CUDA devices it exits 1
before doing anything. Send its output to a file: the log is long.
"""

from __future__ import annotations

import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

import chip_smoke as C

WORLD = 4
LR = 3e-4  # tests/torch_ranks.py's
STEPS = 3  # fp32 steps a case
GRAD_TOL, OUT_TOL = 5e-5, 2e-5  # tests/test_ops.py's fp32 tolerances
FP32_CASES = {  # name: (preset, mesh spec, microbatches)
    "debug_data4": ("debug", {"data": 4}, None),
    "debug_fsdp2_tensor2": ("debug", {"fsdp": 2, "tensor": 2}, None),
    "debug_data2_stage2": ("debug", {"data": 2, "stage": 2}, 2),
    "debug_sequence4": ("debug", {"sequence": 4}, None),
    "moe_debug_data2_expert2": ("moe_debug", {"data": 2, "expert": 2}, None),
}
ELASTIC_ASK, ELASTIC_MIN = 8, 2  # the elastic group asked for, and its floor
ROWS_A_RANK = C.TRAIN_BATCH  # full width: 8 rows of MAX_LEN tokens a rank
WARMUP, TIMED = 2, 3
COLLECTIVE_BYTES = C.COLLECTIVE_BYTES  # the timed bf16 allreduce, 256 MB
COLLECTIVE_ITERS = 10
FIT_DEADLINE = 600.0  # seconds a group's fit may take: a hung collective fails the run


def dump(directory: str, name: str, obj) -> None:
    path = os.path.join(directory, f"{name}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(obj, f)
    os.replace(path + ".tmp", path)


def load(directory: str, name: str):
    with open(os.path.join(directory, f"{name}.pkl"), "rb") as f:
        return pickle.load(f)


def fit_within(trainer, what: str):
    """``trainer.fit()`` within FIT_DEADLINE seconds; a fit that returns
    an error raises it."""
    out = {}
    t = threading.Thread(target=lambda: out.update(res=trainer.fit()), daemon=True)
    t.start()
    t.join(FIT_DEADLINE)
    if t.is_alive():
        raise TimeoutError(f"{what}: the group's fit ran past {FIT_DEADLINE:.0f} s")
    if "res" not in out:
        raise RuntimeError(f"{what}: the fit raised (its traceback is above)")
    if out["res"].error is not None:
        raise out["res"].error
    return out["res"]


def np_tree(tree):
    return {k: np_tree(v) if isinstance(v, dict) else v.detach().cpu().numpy()
            for k, v in tree.items()}


def items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from items(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def fp32_config(preset):
    from ray_tpu_torch.models import transformer as T

    return T.config(preset, dtype=torch.float32, param_dtype=torch.float32)


def init_np_state(cfg):
    """The port's init (seed 0, on the CPU) as state_from_jax takes a
    state: numpy params, moments, count and step."""
    from ray_tpu_torch import train as S

    st = S.init_state(cfg, S.default_optimizer(cfg, lr=LR), seed=0, device="cpu")
    opt = st["opt_state"]
    return {"params": np_tree(st["params"]), "mu": np_tree(opt["mu"]),
            "nu": np_tree(opt["nu"]), "count": opt["count"].numpy(),
            "step": st["step"].numpy()}


def fp32_tokens(cfg):
    """tests/sharded_step_ref.py's tokens: 8 rows of 64."""
    return np.random.RandomState(0).randint(0, cfg.vocab_size, (8, 64)).astype(np.int32)


def single_card_case(preset, device):
    """The single-card run of a case on ``device``: the global loss's
    metrics and grads at the init, 3 steps' metrics, the params after."""
    from ray_tpu_torch import train as S
    from ray_tpu_torch.models.convert import state_from_jax

    cfg = fp32_config(preset)
    state = init_np_state(cfg)
    tokens = fp32_tokens(cfg)
    st = state_from_jax(state, cfg, device=device)
    data = {"tokens": torch.from_numpy(tokens).long().to(device)}
    (_, m), grads = S.value_and_grad(cfg, st["params"], data)
    run = S.make_train_step(cfg, S.default_optimizer(cfg, lr=LR), device=device)
    metrics = []
    for _ in range(STEPS):
        st, mm = run(st, data)
        metrics.append({k: float(v) for k, v in mm.items()})
    return {"state": state, "tokens": tokens,
            "grad_metrics": {k: float(v) for k, v in m.items()},
            "grads": np_tree(grads), "metrics": metrics, "params": np_tree(st["params"])}


def rank_case(preset, spec, microbatches, ref, device):
    """One fp32 case on this rank of the group: its shards' errors against
    ``ref`` (single_card_case's), and its own metrics."""
    from ray_tpu_torch import parallel as P
    from ray_tpu_torch import train as S
    from ray_tpu_torch.models import transformer as T
    from ray_tpu_torch.models.convert import state_from_jax
    from ray_tpu_torch.ops import attention as A

    cfg = fp32_config(preset)
    mesh = P.build_mesh(P.MeshSpec(**spec), device)
    opt = S.default_optimizer(cfg, lr=LR)
    st = state_from_jax(ref["state"], cfg, mesh=mesh)
    data = {"tokens": torch.from_numpy(ref["tokens"]).long().to(device)}
    axes = T.param_axes(cfg)
    (_, m), grads = S.value_and_grad(cfg, st["params"], data, mesh=mesh,
                                     num_microbatches=microbatches)
    want = dict(items(P.shard_tree(mesh, ref["grads"], axes)))
    grad_err = {p: float(np.abs(g.detach().cpu().numpy() - want[p]).max())
                for p, g in items(grads)}
    run = S.make_train_step(cfg, opt, mesh, None, True, microbatches)
    metrics, launches = [], []
    for _ in range(STEPS):
        C.reset_launches(A)
        st, mm = run(st, data)
        metrics.append({k: float(v) for k, v in mm.items()})
        launches.append(C.read_launches(A))
    want = dict(items(P.shard_tree(mesh, ref["params"], axes)))
    params = {}
    for p, t in items(st["params"]):
        a, b = t.detach().cpu().numpy(), want[p]
        d = np.abs(a - b)
        params[p] = (float(d.max()), float((d > 2e-7 + 1e-5 * np.abs(b)).mean()),
                     tuple(a.shape) == tuple(b.shape))
    return {"grad_metrics": {k: float(v) for k, v in m.items()}, "grad_err": grad_err,
            "metrics": metrics, "params": params, "launches": launches}


def card_facts(device):
    """What a worker sees: its card, its process group."""
    import torch.distributed as dist

    facts = {"visible": os.environ.get("CUDA_VISIBLE_DEVICES"), "pid": os.getpid(),
             "backend": dist.get_backend(), "dist": (dist.get_rank(), dist.get_world_size())}
    if device == "cuda":
        props = torch.cuda.get_device_properties(0)
        facts.update(uuid=str(props.uuid), name=props.name,
                     device_count=torch.cuda.device_count())
    return facts


def cases_loop(config):
    """TorchTrainer's loop in each TrainWorker of the 4-card group: the
    worker's card facts, then every fp32 case, written to
    ``config["out"]/rank{r}.pkl``."""
    from ray_tpu_torch import train as S

    torch.set_float32_matmul_precision("highest")  # no TF32: fp32 references in full fp32
    rank = S.get_context().get_world_rank()
    out = {"facts": card_facts(config["device"]), "world": S.get_context().get_world_size()}
    for name, (preset, spec, microbatches) in config["cases"].items():
        out[name] = rank_case(preset, spec, microbatches, config["refs"][name],
                              config["device"])
    dump(config["out"], f"rank{rank}", out)
    S.report({"rank": rank})


def full_width_loop(config):
    """TorchTrainer's loop in each worker of the elastic group: the config's
    model at MeshSpec(data=world) from seed 0, ``rows`` rows a rank of
    the global batch, WARMUP + TIMED steps and one profiled, each step's
    ms (host clock, synchronized) and flash launches, written to
    ``config["out"]/full{r}.pkl``."""
    from ray_tpu_torch import parallel as P
    from ray_tpu_torch import train as S
    from ray_tpu_torch.models import transformer as T
    from ray_tpu_torch.ops import attention as A

    ctx = S.get_context()
    rank, world, device = ctx.get_world_rank(), ctx.get_world_size(), config["device"]
    cfg = T.config(config["preset"], param_dtype=torch.bfloat16)
    opt = S.default_optimizer(cfg)
    mesh = P.build_mesh(P.MeshSpec(data=world), device)
    state = S.init_state(cfg, opt, mesh, seed=C.SEED)
    tokens = torch.from_numpy(np.random.RandomState(C.SEED).randint(
        0, cfg.vocab_size, (config["rows"] * world, config["seq"]))).to(device)
    run = S.make_train_step(cfg, opt, mesh)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    out = {"facts": card_facts(device), "world": world, "steps": []}
    for i in range(WARMUP + TIMED):
        C.reset_launches(A)
        sync()
        t0 = time.perf_counter()
        state, m = run(state, {"tokens": tokens})
        sync()
        out["steps"].append({"ms": 1e3 * (time.perf_counter() - t0),
                             "loss": float(m["loss"]), "launches": C.read_launches(A)})
    if device == "cuda":
        out["profile"] = C.profiled(lambda: run(state, {"tokens": tokens}), top=12)
        out["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
    dump(config["out"], f"full{rank}", out)
    S.report({"rank": rank, "world": world})


class CollectiveMember:
    """An actor of the collectives' group: its rank's input through every
    op of ray_tpu_torch.util.collective, and the timed allreduce."""

    def ops(self, group, seed, device):
        import torch.distributed as dist

        from ray_tpu_torch.util import collective as col

        rank, world = col.get_rank(group), col.get_collective_group_size(group)
        x = collective_input(seed, rank)
        out = {"rank": rank, "world": world, "backend": dist.get_backend(),
               "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}
        for op in ("sum", "product", "max", "min", "mean"):
            out[("allreduce", op)] = col.allreduce(x, group, op).cpu().numpy()
            out[("reducescatter", op)] = col.reducescatter(x, group, op).cpu().numpy()
        out["allgather"] = col.allgather(x, group).cpu().numpy()
        out["broadcast"] = col.broadcast(x, 2, group).cpu().numpy()
        nxt, prv = (rank + 1) % world, (rank - 1) % world
        if rank % 2 == 0:
            col.send(x[rank], nxt, group)
            out["recv"] = col.recv(prv, group).cpu().numpy()
        else:
            out["recv"] = col.recv(prv, group).cpu().numpy()
            col.send(x[rank], nxt, group)
        col.barrier(group)
        return out

    def timed_allreduce(self, group, nbytes, iters):
        """ms of one bf16 allreduce of ``nbytes`` (the mean of ``iters``
        between CUDA events, after one warm-up) and the result's error
        against the sum of the ranks' inputs."""
        from ray_tpu_torch.util import collective as col

        rank, world = col.get_rank(group), col.get_collective_group_size(group)
        x = torch.full((nbytes // 2,), float(rank + 1), device="cuda", dtype=torch.bfloat16)
        out = col.allreduce(x, group)
        err = float((out.float() - world * (world + 1) / 2).abs().max())
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        col.barrier(group)
        start.record()
        for _ in range(iters):
            col.allreduce(x, group)
        end.record()
        end.synchronize()
        return {"rank": rank, "ms": start.elapsed_time(end) / iters, "max_abs_err": err}


def collective_input(seed, rank, shape=(8, 3)):
    """tests/torch_ranks.py's: float32 in [0.5, 1.5)."""
    return (np.random.RandomState(seed + rank).random_sample(shape) + 0.5).astype(np.float32)


def cards_and_cases(rt, S, out, device, smi):
    """The 4-card group: distinct cards, and the fp32 cases against the
    single-card runs made here first."""
    with C.phase("fp32_single_card"):
        refs = {}
        for name, (preset, _, _) in FP32_CASES.items():
            if preset not in refs:
                refs[preset] = single_card_case(preset, device)
        refs = {name: refs[preset] for name, (preset, _, _) in FP32_CASES.items()}
    with C.phase("cards_and_fp32_cases"):
        t0 = time.perf_counter()
        fit_within(S.TorchTrainer(
            cases_loop, train_loop_config={"cases": FP32_CASES, "refs": refs, "out": out,
                                           "device": device},
            scaling_config=S.ScalingConfig(num_workers=WORLD, use_gpu=True),
            run_config=S.RunConfig(name="cards", storage_path=os.path.join(out, "cards"))),
            "cards_and_fp32_cases")
        ranks = [load(out, f"rank{r}") for r in range(WORLD)]
        facts = [r["facts"] for r in ranks]
        C.emit({"workers": facts, "fit_s": time.perf_counter() - t0, "card": smi})
        distinct = (len({f["visible"] for f in facts}) == WORLD
                    and all(f["dist"] == (r, WORLD) for r, f in enumerate(facts))
                    and {f["backend"] for f in facts} == {"nccl" if device == "cuda" else "gloo"})
        if device == "cuda":
            distinct = distinct and len({f["uuid"] for f in facts}) == WORLD and \
                all(f["device_count"] == 1 for f in facts)
        if not distinct:
            raise AssertionError(f"the group's workers do not hold 4 distinct cards: {facts}")
        bad = {}
        for name in FP32_CASES:
            ref = refs[name]
            worst = {"grad": 0.0, "metric0": 0.0, "param": 0.0, "noisy": 0.0, "loss_later": 0.0}
            shapes_ok = True
            for rk in ranks:
                c = rk[name]
                worst["grad"] = max(worst["grad"], max(c["grad_err"].values()))
                worst["metric0"] = max(worst["metric0"], *(
                    abs(c["grad_metrics"][k] - ref["grad_metrics"][k])
                    for k in ("loss", "accuracy", "tokens")), *(
                    abs(c["metrics"][0][k] - ref["metrics"][0][k])
                    for k in ("loss", "accuracy", "grad_norm", "tokens")))
                worst["param"] = max(worst["param"], max(v[0] for v in c["params"].values()))
                worst["noisy"] = max(worst["noisy"], max(v[1] for v in c["params"].values()))
                worst["loss_later"] = max(worst["loss_later"], max(
                    abs(m["loss"] - rm["loss"]) for m, rm in zip(c["metrics"], ref["metrics"])))
                shapes_ok = shapes_ok and all(v[2] for v in c["params"].values())
            row = {"case": name, "spec": FP32_CASES[name][1], "microbatches": FP32_CASES[name][2],
                   "max_grad_err": worst["grad"], "max_step0_metric_err": worst["metric0"],
                   "max_param_err": worst["param"], "max_noisy_share": worst["noisy"],
                   "max_loss_err_any_step": worst["loss_later"],
                   "launches_per_step_rank0": ranks[0][name]["launches"],
                   "tol": {"grad": GRAD_TOL, "metrics": OUT_TOL,
                           "param": 2 * LR * STEPS + 1e-6, "noisy_share": 1e-3},
                   "card": smi}
            C.emit(row)
            if not (shapes_ok and worst["grad"] <= GRAD_TOL and worst["metric0"] <= OUT_TOL
                    and worst["param"] <= 2 * LR * STEPS + 1e-6 and worst["noisy"] < 1e-3):
                bad[name] = row
        if bad:
            raise AssertionError(f"fp32 world-4 cases off the single-card run: {bad}")


def collectives(rt, device, smi):
    """create_collective_group over 4 num_gpus=1 actors; every op against
    numpy, and the timed 256 MB allreduce."""
    from ray_tpu_torch.util import collective as col

    with C.phase("collective_actors_4"):
        member = rt.remote(num_gpus=1)(CollectiveMember)
        actors = [member.remote() for _ in range(WORLD)]
        backend = "nccl" if device == "cuda" else "gloo"
        try:
            col.create_collective_group(actors, WORLD, list(range(WORLD)), backend, "cards")
            out = rt.get([a.ops.remote("cards", 3, device) for a in actors], timeout=600)
            timed = rt.get([a.timed_allreduce.remote("cards", COLLECTIVE_BYTES, COLLECTIVE_ITERS)
                            for a in actors], timeout=600) if device == "cuda" else []
        finally:
            for a in actors:
                rt.kill(a)
        x = np.stack([collective_input(3, r) for r in range(WORLD)])
        chunk = len(x[0]) // WORLD
        errs = {}
        for r, o in enumerate(out):
            for op, f in C.NP_REDUCE.items():
                errs[f"allreduce_{op}"] = max(errs.get(f"allreduce_{op}", 0.0), float(
                    np.abs(o[("allreduce", op)] - f(x)).max()))
                errs[f"reducescatter_{op}"] = max(errs.get(f"reducescatter_{op}", 0.0), float(
                    np.abs(o[("reducescatter", op)] - f(x)[None, r * chunk:(r + 1) * chunk]).max()))
            for k, want in (("allgather", x), ("broadcast", x[2]),
                            ("recv", x[(r - 1) % WORLD][(r - 1) % WORLD])):
                errs[k] = max(errs.get(k, 0.0), float(np.abs(o[k] - want).max()))
        ms = max((t["ms"] for t in timed), default=None)
        row = {"world": WORLD, "backend": {o["backend"] for o in out} == {backend},
               "visible": [o["visible"] for o in out], "max_abs_err": errs,
               "allreduce_bytes": COLLECTIVE_BYTES, "allreduce_ms_by_rank": [t["ms"] for t in timed],
               "allreduce_max_abs_err": max((t["max_abs_err"] for t in timed), default=None),
               "bus_bandwidth_GBps": (2 * (WORLD - 1) / WORLD * COLLECTIVE_BYTES / (ms / 1e3) / 1e9
                                      if ms else None),
               "clock": "CUDA events, the slowest rank", "card": smi}
        C.emit(row)
        bad = C.collective_misses(errs)
        if bad or not row["backend"] or len(set(row["visible"])) != WORLD or \
                (timed and row["allreduce_max_abs_err"] != 0.0):
            raise AssertionError(f"collectives over 4 actors: {row}; misses {bad}")


def _replica_launches(instance, reset=False):
    """Run in a replica's process through ``__ray_call__``: its flash
    launch counts (set to 0 first when ``reset``)."""
    from ray_tpu_torch.ops import attention as A

    if reset:
        C.reset_launches(A)
    return C.read_launches(A)


def disagg_two_cards(rt, device, smi, preset="llama3_8b", max_len=C.MAX_LEN):
    """Disaggregated prefill across two cards in cluster mode: a STRICT_PACK
    placement group of two {"GPU": 1} bundles, DisaggPrefillEngine's
    prefill replica in bundle 0 and its decode replica in bundle 1, each a
    worker process leasing its card and drawing the seed-0 weights there;
    the KV rows cross processes through the shared-memory TensorChannel.
    The 8 serving prompts; gates: tokens equal a single-process
    PagedBatcher's on this process's card (same weights and prompts),
    the decode replica's prefill_tokens 0 and admitted 8, two distinct
    cards, and on the card flash launches L x 8 in the prefill replica's
    process and 0 in the decode replica's. Hand-off ms from the replicas'
    timings."""
    import functools

    from ray_tpu_torch.llm import LLMConfig
    from ray_tpu_torch.models import transformer as T
    from ray_tpu_torch.models.decoding import SamplingParams
    from ray_tpu_torch.models.disagg_prefill import DisaggPrefillEngine
    from ray_tpu_torch.models.paged_kv import PagedBatcher
    from ray_tpu_torch.util import placement_group, remove_placement_group

    cfg = T.config(preset, param_dtype=torch.bfloat16)
    tok = LLMConfig(model=cfg).get_tokenizer()
    # the serving prompts (100 to 1,500 bytes at max_len 2,048), scaled with max_len
    lengths = (np.linspace(100, 1500, 8) * max_len / C.MAX_LEN).astype(int).tolist()
    ids8 = [tok.encode(p) for p in C.prompt_texts(lengths, C.SEED + 1)]
    greedy = SamplingParams(max_tokens=C.MAX_TOKENS)
    with C.phase("disagg_prefill_two_cards"):
        params = C.seeded_params(preset, C.SEED, device)
        pb = PagedBatcher(cfg, params, max_len=max_len, slots=8, page_size=C.PAGE_SIZE,
                          seed=C.SEED, device=device)
        try:
            t0 = time.perf_counter()
            want = [f.result(timeout=600) for f in [pb.submit(i, greedy) for i in ids8]]
            paged_s = time.perf_counter() - t0
        finally:
            pb.shutdown()
        del pb, params
        torch.cuda.empty_cache()
        pg = placement_group([{"CPU": 1, "GPU": 1}, {"CPU": 1, "GPU": 1}], strategy="STRICT_PACK")
        if not pg.ready(timeout=120):
            raise AssertionError("the two-card placement group is not ready")
        eng = None
        try:
            eng = DisaggPrefillEngine(cfg, functools.partial(C.seeded_params, preset, C.SEED,
                                                              device),
                                      max_len=max_len, slots=8, page_size=C.PAGE_SIZE,
                                      num_cpus=1, num_gpus=1, device=device,
                                      placement_group=pg)
            replicas = (eng.prefiller, eng.decoder)
            visible = rt.get([a.__ray_call__.remote(
                lambda _: os.environ.get("CUDA_VISIBLE_DEVICES")) for a in replicas],
                timeout=900)
            rt.get([a.__ray_call__.remote(_replica_launches, True) for a in replicas],
                   timeout=60)
            t0 = time.perf_counter()
            outs = [rt.get(r, timeout=900) for r in [eng.generate(i, greedy) for i in ids8]]
            disagg_s = time.perf_counter() - t0
            launches = rt.get([a.__ray_call__.remote(_replica_launches) for a in replicas],
                              timeout=60)
            stats = eng.stats()
            pre = rt.get(eng.prefiller.timings.remote(), timeout=60)
            dec = rt.get(eng.decoder.timings.remote(), timeout=60)
        finally:
            if eng is not None:
                eng.shutdown()
            remove_placement_group(pg)
        handoff = [p["stage_ms"] + p["write_ms"] + d["read_ms"] + d["to_device_ms"]
                   for p, d in zip(pre, dec)]
        row = {"visible": visible, "tokens_equal_paged": outs == want, "stats": stats,
               "prefill_launches": launches[0], "decode_launches": launches[1],
               "disagg_s": disagg_s, "paged_s": paged_s, "disagg_over_paged": disagg_s / paged_s,
               "handoff_ms_median": float(np.median(handoff)), "handoff_ms": handoff,
               **{f"{k}_median": float(np.median([t[k] for t in pre]))
                  for k in ("prefill_ms", "stage_ms", "write_ms")},
               **{f"{k}_median": float(np.median([t[k] for t in dec]))
                  for k in ("read_ms", "to_device_ms")},
               "row_bytes": 2 * cfg.layers * max_len * cfg.kv_heads * cfg.hd * 4,
               "clock": "host", "card": smi}
        C.emit(row)
        zero = {name: 0 for name in C.COUNTERS}
        if outs != want or stats["prefill_tokens"] != 0 or stats["admitted"] != len(ids8) or \
                len(set(visible)) != 2 or (device == "cuda" and (
                    launches[0] != {**zero, "flash_fwd": cfg.layers * len(ids8)} or
                    launches[1] != zero)):
            raise AssertionError(f"disaggregated prefill on two cards: {row}")


def data_cluster_two_cards(smi, device="cuda", preset="llama3_8b", max_len=C.MAX_LEN):
    """Batch inference over two nodes of one card each: a Cluster whose
    head and second node each own one host card (Cluster.add_node(
    num_gpus=1): ids [0] and [1]); data_llm_batch's 12 rows in 3 blocks
    through build_llm_processor(LLMConfig(preset, seed 0), batch_size=4)
    first with one pool actor (one engine), then with two (concurrency=2:
    one engine a card, each drawn from the seed in its own worker). Gates:
    the two engines on different physical cards (their workers'
    CUDA_VISIBLE_DEVICES), one engine a worker, the two-engine rows
    bit-equal to the one-engine rows (chip_smoke.py's data_cluster_llm_batch
    holds one engine against the direct engine), rows in order; on the
    card, flash launches L a batch. Prints rows/s of two engines against
    one. ``device="cpu"`` (fake cards, ``RAY_TPU_FAKE_GPUS=2``) rehearses
    it at a small preset."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import data as D
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.llm import LLMConfig, SamplingParams, build_llm_processor
    from ray_tpu_torch.models import transformer as T

    cfg = T.config(preset, param_dtype=torch.bfloat16)
    prompts = C.data_prompts()
    per_block = len(prompts) // C.DATA_BLOCKS
    config = LLMConfig(model=cfg, max_len=max_len, seed=C.SEED, tokenizer=C.IdsTokenizer(),
                       sampling=SamplingParams(max_tokens=C.MAX_TOKENS))
    with C.phase("data_cluster_two_cards"):
        cluster = Cluster()
        try:
            cluster.add_node(num_cpus=4, num_gpus=1)
            cluster.add_node(num_cpus=4, num_gpus=1)
            cluster.wait_for_nodes()
            rt.init(address=cluster.address)
            runs = {}
            for pool in (1, 2):
                ds = D.from_items([{"prompt": p, "row": i} for i, p in enumerate(prompts)],
                                  override_num_blocks=C.DATA_BLOCKS)
                process = build_llm_processor(
                    config, batch_size=per_block, concurrency=pool, _stats_column="stage",
                    **({} if device == "cuda" else {"device": device, "num_gpus": 1}))
                t0 = time.perf_counter()
                rows = process(ds).take_all()
                runs[pool] = (rows, time.perf_counter() - t0)
        finally:
            try:
                rt.shutdown()
            finally:
                cluster.shutdown()
        (one, one_s), (two, two_s) = runs[1], runs[2]
        stages = {(r["stage"]["pid"], r["stage"]["batch"]): r["stage"] for r in two}
        cards = {s["pid"]: s["visible"] for s in stages.values()}
        launches = {pid: sum(s["launches"]["flash_fwd"] for s in stages.values()
                            if s["pid"] == pid) for pid in cards}
        row = {"rows": len(two), "one_engine_s": one_s, "two_engines_s": two_s,
               "rows_per_s_one": len(one) / one_s, "rows_per_s_two": len(two) / two_s,
               "two_over_one": one_s / two_s, "cards_by_worker": cards,
               "engines_built": sorted({s["engines_built"] for s in stages.values()}),
               "flash_fwd_by_worker": launches,
               "tokens_equal_one_engine": [r["generated"] for r in two]
               == [r["generated"] for r in one],
               "rows_in_order": [r["row"] for r in two] == list(range(len(prompts))),
               "clock": "host, synchronized", "card": smi}
        C.emit({"data_cluster_two_cards": row})
        if not (row["tokens_equal_one_engine"] and row["rows_in_order"]
                and len(cards) == 2 and len(set(cards.values())) == 2
                and row["engines_built"] == [1]
                and (device != "cuda" or all(
                    n == cfg.layers * sum(1 for s in stages.values() if s["pid"] == pid)
                    for pid, n in launches.items()))):
            raise AssertionError(f"data_cluster_two_cards: {row}")


def one_card_step(device, smi, preset, rows, seq):
    """One card's step in this process: the model at full width (bf16,
    remat), ``rows`` rows, WARMUP + TIMED steps; its median ms and the
    step-0 loss. Frees the card after."""
    from ray_tpu_torch import train as S
    from ray_tpu_torch.models import transformer as T

    with C.phase("one_card_step"):
        cfg = T.config(preset, param_dtype=torch.bfloat16)
        opt = S.default_optimizer(cfg)
        state = S.init_state(cfg, opt, seed=C.SEED, device=device)
        tokens = torch.from_numpy(np.random.RandomState(C.SEED).randint(
            0, cfg.vocab_size, (rows, seq))).to(device)
        run = S.make_train_step(cfg, opt, device=device)
        ms, losses = [], []
        for _ in range(WARMUP + TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = run(state, {"tokens": tokens})
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        med = float(np.median(ms[WARMUP:]))
        row = {"model": preset, "rows": rows, "seq": seq, "step_ms": ms, "step_ms_median": med,
               "tokens_per_s": rows * seq / (med / 1e3), "losses": losses,
               "mfu_6n": 6 * cfg.num_params() * rows * seq / (med / 1e3) / C.PEAK_FLOPS[
                   torch.bfloat16], "clock": "host, synchronized", "card": smi}
        C.emit(row)
        del state, run
        torch.cuda.empty_cache()
    return row


def elastic_full_width(rt, S, out, device, smi, preset, rows, seq, single):
    """ScalingConfig(num_workers=8, min_workers=2, use_gpu=True) sized to
    4 on this node, and its fit at full width (full_width_loop)."""
    from ray_tpu_torch.models import transformer as T
    from ray_tpu_torch.train.scaling_policy import decide_num_workers

    with C.phase("elastic_full_width"):
        scaling = S.ScalingConfig(num_workers=ELASTIC_ASK, min_workers=ELASTIC_MIN, use_gpu=True)
        sized = decide_num_workers(scaling)
        C.emit({"cluster_resources": rt.cluster_resources(), "asked": ELASTIC_ASK,
                "min_workers": ELASTIC_MIN, "sized_to": sized})
        if sized != WORLD:
            raise AssertionError(f"elastic sizing gave {sized} workers, expected {WORLD}")
        t0 = time.perf_counter()
        res = fit_within(S.TorchTrainer(
            full_width_loop, train_loop_config={"out": out, "device": device, "preset": preset,
                                                "rows": rows, "seq": seq},
            scaling_config=scaling,
            run_config=S.RunConfig(name="elastic", storage_path=os.path.join(out, "elastic"))),
            "elastic_full_width")
        cfg = T.config(preset)
        want = {"flash_fwd": 2 * cfg.layers, "flash_bwd_dq": cfg.layers,
                "flash_bwd_dkv": cfg.layers}
        ranks = [load(out, f"full{r}") for r in range(WORLD)]
        per_rank = []
        for r, rk in enumerate(ranks):
            timed = [s_["ms"] for s_ in rk["steps"][WARMUP:]]
            med = float(np.median(timed))
            prof = rk.get("profile", {})
            per_rank.append({"rank": r, "visible": rk["facts"]["visible"],
                             "step_ms": [s_["ms"] for s_ in rk["steps"]], "step_ms_median": med,
                             "losses": [s_["loss"] for s_ in rk["steps"]],
                             "launches": [s_["launches"] for s_ in rk["steps"]],
                             "nccl_device_ms": prof.get("device_ms_by_kind", {}).get(
                                 "NCCL collectives"),
                             "profile": prof,
                             "peak_allocated_bytes": rk.get("peak_allocated_bytes")})
        med = max(p["step_ms_median"] for p in per_rank)  # the group steps at its slowest rank
        tok_s = rows * WORLD * seq / (med / 1e3)
        row = {"model": preset, "mesh": {"data": WORLD}, "rows_a_rank": rows, "seq": seq,
               "world": res.metrics.get("world"), "fit_s": time.perf_counter() - t0,
               "step_ms_median": med, "tokens_per_s": tok_s,
               "mfu_6n": 6 * cfg.num_params() * tok_s / (WORLD * C.PEAK_FLOPS[torch.bfloat16]),
               "one_card": {k: single[k] for k in ("step_ms_median", "tokens_per_s", "mfu_6n")},
               "step0_loss_vs_one_card": [per_rank[0]["losses"][0], single["losses"][0]],
               "per_rank": per_rank, "clock": "host, synchronized", "card": smi}
        C.emit(row)
        ok = (res.metrics.get("world") == WORLD
              and all(s_ == want for p in per_rank for s_ in p["launches"])
              and all(np.isfinite(p["losses"]).all() for p in per_rank)
              and len({p["visible"] for p in per_rank}) == WORLD)
        if not ok:
            raise AssertionError(f"the elastic full-width fit: {row}")
    return row


SEBULBA_TWO = dict(C.SEBULBA, num_actors=4, num_learners=2, sync_every_iterations=2)
SEBULBA_SYNCED_TRAINS = 4  # train() calls held for bit-equal params after each sync


def sebulba_two_learners(rt, device, smi):
    """SEBULBA_TWO on this node (``device=None``: each learner leases a
    card; "cpu": a rehearsal under RAY_TPU_FAKE_GPUS, no lease). Gates:
    after every train() that synced, the two learners' params bit-equal;
    0 order and app errors throughout; each learner's process on its own
    card; learner 1 killed right before a broadcast: one group rotation,
    one restart, no app error, and the next train() clean. Prints env
    steps/s (chip_smoke.rl_measure) beside the one-learner point
    (chip_smoke.SEBULBA) timed in this call."""
    from ray_tpu_torch.rllib.podracer import SebulbaConfig

    def params_equal(algo):
        a, b = rt.get([ln.get_params_np.remote() for ln in algo.learners], timeout=300)
        return all(np.array_equal(a[n][k], b[n][k]) for n in a for k in a[n])

    with C.phase("sebulba_two_learners"):
        one = SebulbaConfig(**C.SEBULBA).build(device=device)
        try:
            one_m = C.rl_measure(one, C.SEBULBA_FRAMES)
            one_m.pop("results")
        finally:
            one.stop()
        cfg = SebulbaConfig(**SEBULBA_TWO)
        algo = cfg.build(device=device)
        try:
            facts = rt.get([ln.__ray_call__.remote(C.learner_facts) for ln in algo.learners],
                           timeout=300)
            synced = []
            for _ in range(SEBULBA_SYNCED_TRAINS):
                r = algo.train()
                if (r["training_iteration"] - 1) % cfg.sync_every_iterations == 0:
                    synced.append({"iteration": r["training_iteration"],
                                   "params_bit_equal": params_equal(algo),
                                   "order_errors": r["order_errors"],
                                   "app_errors": r["app_errors"]})
            two_m = C.rl_measure(algo, C.SEBULBA_FRAMES)
            results = two_m.pop("results")
            algo.kill_learner(1)
            t0 = time.perf_counter()
            algo._sync_learners()  # a broadcast with a dead counterpart
            kill_sync_s = time.perf_counter() - t0
            after = {"group_rotations": algo.group_rotations,
                     "learner_restarts": algo.learner_restarts, "app_errors": algo.app_errors}
            post = algo.train()
            if (post["training_iteration"] - 1) % cfg.sync_every_iterations:
                post = algo.train()  # the next one that syncs
            post_equal = params_equal(algo)
            respawned = rt.get(algo.learners[1].__ray_call__.remote(C.learner_facts),
                               timeout=300)
        finally:
            algo.stop()
        row = {"config": SEBULBA_TWO, "env_steps_per_s": two_m["steps_per_s"],
               "frames": two_m["frames"], "wall_s": two_m["wall_s"],
               "one_learner_env_steps_per_s": one_m["steps_per_s"],
               "two_vs_one": two_m["steps_per_s"] / one_m["steps_per_s"],
               "synced": synced, "learners": facts, "kill_sync_s": kill_sync_s,
               "after_kill_sync": after,
               "post": {k: post[k] for k in ("training_iteration", "num_updates", "order_errors",
                                             "app_errors", "group_rotations",
                                             "learner_restarts")},
               "post_params_bit_equal": post_equal, "respawned": respawned,
               "clock": "host", "card": smi}
        C.emit(row)
        cards = {f["visible"] for f in facts + [respawned]}
        bad = [r for r in results if r["order_errors"] or r["app_errors"]]
        if bad or not synced or not all(x["params_bit_equal"] and not x["order_errors"]
                                        and not x["app_errors"] for x in synced) \
                or after != {"group_rotations": 1, "learner_restarts": 1, "app_errors": 0} \
                or post["app_errors"] or post["order_errors"] or not post_equal \
                or (device is None and (len({f["visible"] for f in facts}) != 2
                                        or not all(f["param_device"] == "cuda:0"
                                                   for f in facts + [respawned])
                                        or len(cards) != 2)):
            raise AssertionError(f"sebulba_two_learners: {row}; bad results {bad}")
    return row


def main() -> int:
    if torch.cuda.device_count() < WORLD:
        print(f"chip_cards: {torch.cuda.device_count()} CUDA devices; this script needs "
              f"{WORLD} cards", file=sys.stderr)
        return 1
    import ray_tpu_torch as rt
    from ray_tpu_torch import train as S
    from ray_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 references in full fp32
    torch.backends.cudnn.allow_tf32 = False
    with C.phase("device"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
        print(smi, flush=True)
        C.emit({"devices": [torch.cuda.get_device_name(i) for i in range(WORLD)],
                "count": torch.cuda.device_count(), "nvidia_smi": smi.splitlines(),
                "torch": torch.__version__, "cuda": torch.version.cuda})
        smi = smi.splitlines()[0]
    with C.phase("build"):
        t0 = time.perf_counter()
        _build.load_extension()  # the workers load this build
        C.emit({"build_s": time.perf_counter() - t0})
    out = tempfile.mkdtemp(prefix="chip_cards_")
    single = one_card_step("cuda", smi, "llama2_7b_lora", ROWS_A_RANK, C.MAX_LEN)
    rt.init()
    try:
        C.emit({"cluster_resources": rt.cluster_resources()})
        cards_and_cases(rt, S, out, "cuda", smi)
        collectives(rt, "cuda", smi)
        elastic_full_width(rt, S, out, "cuda", smi, "llama2_7b_lora", ROWS_A_RANK, C.MAX_LEN,
                           single)
        disagg_two_cards(rt, "cuda", smi)
        sebulba_two_learners(rt, None, smi)
    finally:
        rt.shutdown()
        shutil.rmtree(out, ignore_errors=True)
    data_cluster_two_cards(smi)  # a Cluster of its own: two nodes, a card each
    alive = C.cluster_processes()
    if alive:
        raise AssertionError(f"processes left after shutdown: {alive!r}")
    C.emit({"ok": True, "cards": WORLD, "card": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
