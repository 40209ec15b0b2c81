"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout and
holds each kernel against its plain PyTorch version on the card: bf16
inputs run the forward, dQ and dK/dV on the tensor cores (wgmma + TMA),
fp32 inputs the CUDA-core kernels. Then it drives the port's paths
at full width, each with the kernels' launch counts set to 0 just
before it and read just after:

- serving: llama3_8b (all 32 layers, random bf16 weights from seed 0)
  through ray_tpu_torch.llm.LLMEngine and ContinuousLLMEngine, and one
  prompt through Generator.generate_stream;
- the actor runtime in local mode: the same weights put in the object
  store of ray_tpu_torch.init(local_mode=True) and served from an actor
  (num_gpus=1, max_concurrency=8) holding an LLMEngine and a
  ContinuousLLMEngine over them (storage shared with the caller's): the
  4 prompts (tokens bit-identical to the direct engine's), the 8 prompts
  as 8 concurrent calls, a streaming method (tokens equal to the direct
  stream), a num_gpus=1 task running the flash kernel at the prefill
  shape (its CUDA output bit-identical to the direct call's, traced
  through ray_tpu_torch.gpu_profile), a rejected request surfacing as
  the engine's exception; µs per actor call and per put/get of a 64 MB
  CUDA tensor;
- paged serving: the same model and prompts through
  ray_tpu_torch.models.paged_kv.PagedBatcher (tokens held equal to the
  slot-dense batcher's), 8 requests over a shared 1,024-token prefix
  (prefix hits and prefilled tokens exact, the warm prefill's logits
  held against the cold one's) and an overcommitted pool (preemptions,
  every request complete); decode at batch 8 timed paged against dense;
- Data batch inference: the same model's weights (seed 0) built by
  ray_tpu_torch.llm.build_llm_processor over a ray_tpu_torch.data
  Dataset of the 12 serving prompts in 3 blocks, in local mode (tokens
  bit-identical to the cached engine's own generate on the same
  batches; rows/s and completion tokens/s against the direct calls);
- training: llama2_7b_lora (all 32 layers, bf16 params, B=8 x 2048,
  remat) through ray_tpu_torch.train.make_train_step, 2 warm-up and 5
  timed steps, after a two-layer fp32 step held against the same step
  with attention through the plain versions; then 3 more steps on the
  same state fed by Data (24 rows of tokens through
  random_shuffle().iter_torch_batches(): each batch bit-equal to the
  plan's iter_batches rows, int32 on the card; ingest ms a batch);
- mixture-of-experts training: mixtral_8x7b at full width with its 32
  layers cut to 4 (bf16 params, full fine-tune, B=8 x 2048, remat), 2
  warm-up and 5 timed steps, after one MoE layer at Mixtral width held
  against the same layer on the CPU (routing identical, outputs within
  tolerance, with and without capacity drops);
- sharded mixture-of-experts training: the same model, seed and batch
  through a mesh of one rank (an NCCL world of one, MeshSpec() through
  ray_tpu_torch.parallel), the data and expert axes' code with every
  collective a copy: 2 warm-up and 3 timed steps, held against the
  unsharded steps (step 0's loss bit-identical);
- ring attention: every rank of a ring of 4 over llama3_8b's attention
  at S = 4 x 8192 (bf16, causal, forward and backward) driven on this
  card through the port's per-rank loops, held against one flash call
  over the whole sequence, and non-causal at 4 x 2048 and against the
  plain versions at 4 x 1024;
- sharded dense training: llama2_7b_lora at full width through a mesh
  of one rank, the FSDP and tensor-parallel code with every collective a
  copy, 8 microbatches asked for (ignored at stage 1, as in JAX): 2
  warm-up and 3 timed steps, held against the unsharded steps (step 0's
  loss bit-identical);
- pipelined training: llama2_7b_lora at full width as a GPipe pipeline of
  4 stages (8 layers each) and 8 microbatches, every stage's loops run on
  this card through an in-process transport (the per-stage loops of
  ray_tpu_torch/ops/pipeline.py that the P2P path feeds across ranks): 2
  warm-up and 3 timed steps, step 0's loss and grad norm held against
  the unpipelined step's within twice that step's own distance from the
  same step in fp32 (measured here);
- collectives: ray_tpu_torch.util.collective over NCCL, a world of one:
  every op on CUDA tensors against numpy, a 256 MB bf16 allreduce timed;
- the trainer: llama2_7b_lora at full width through
  ray_tpu_torch.train.TorchTrainer with keep-1 checkpoints and one
  retry: steps 0-4, the state saved through torch.distributed.checkpoint
  after steps 2 and 4, a planned failure after step 2 and a resume from
  its checkpoint (losses bit-identical to the uninterrupted steps, the
  restored state's fingerprints equal to the saved one's); then
  LLMEngine serving the step-4 checkpoint through LLMConfig.params_path
  (greedy tokens bit-identical to the loop's from its in-memory params),
  and a bf16 state saved under a mesh of one (CUDA DTensors over NCCL)
  restored bit-identical;
- Tune: ray_tpu_torch.tune.Tuner over two LoRA learning rates in local
  mode, one trial at a time, each a TorchTrainer.fit() of 2 full-width
  llama2_7b_lora steps on a trial actor's thread (step 0's loss
  bit-identical to the training steps', the best result the argmin,
  memory freed after each trial);
- the RL learners: ray_tpu_torch.rllib's IMPALA, PPO, DQN, SAC and BC
  learners (hidden 64, 64) from one numpy init, 5 updates on the card
  held against the same 5 on the CPU, and each update timed;
- Anakin: its learn step on the card held against the CPU's on one
  trajectory of 4,096 envs, then ray_tpu_torch.rllib.Anakin.train() at
  4,096 and 65,536 envs (rollout of the batched torch CartPole, V-trace
  loss and Adam, all on the card): env steps/s, ms an update step, the
  device's idle share, kernels a step, peak memory, and the episode
  return over 20 train() calls.

Every phase prints JSON lines; any failure raises and the script exits
non-zero. The line before the last lists the kernels with their times,
design, HGMMA count (cuobjdump -sass of the built library) and resources
(registers, shared memory, local bytes, as the runtime loaded them); the
last is {"ok": true, "device": {...}}. The build is printed, with
ptxas's report of each kernel's registers, spills and warnings. Without
a CUDA device it exits 1 before doing anything.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
MAX_LEN = 2048
MAX_TOKENS = 32
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# kernel vs plain version: both compute in fp32 and, in bf16, round P to
# bf16 before P·V; fp32 differs only by summation order; bf16 O rounds
# once more to bf16 (1 ulp of |O| <= ~4)
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-3)}  # (O, LSE)
ATTN_SHAPES = [  # (name, B, Sq, Sk, H, Hkv, D, causal, dtype)
    # the continuous engine's largest prefill bucket; timed
    ("prefill", 1, 2048, 2048, 32, 8, 128, True, torch.bfloat16),
    # LLMEngine's prefill of the 4 smoke prompts (padded to the longest)
    ("prefill_batch4", 4, 1500, 1500, 32, 8, 128, True, torch.bfloat16),
    # the training step's attention (llama2_7b_lora); timed
    ("train_step", 8, 2048, 2048, 32, 32, 128, True, torch.bfloat16),
    # the MoE training step's attention (mixtral_8x7b, GQA 32/8); timed
    ("mixtral_train", 8, 2048, 2048, 32, 8, 128, True, torch.bfloat16),
    # the paged batcher's warm prefill: the remainder's largest bucket
    # over a 1,024-token reused prefix, no mask (paged_prefix); timed
    ("paged_warm", 1, 512, 1024, 32, 8, 128, False, torch.bfloat16),
    ("ragged", 2, 100, 100, 4, 4, 64, False, torch.float32),
    ("sq_ne_sk", 2, 64, 192, 8, 4, 32, True, torch.float32),
    # their bf16 twins: tensor-core tiles at D=64 and D=32, ragged ends
    ("ragged_bf16", 2, 100, 100, 4, 4, 64, False, torch.bfloat16),
    ("sq_ne_sk_bf16", 2, 64, 192, 8, 4, 32, True, torch.bfloat16),
]
TIMED_ATTN = {"prefill": 20, "train_step": 5, "mixtral_train": 5, "paged_warm": 20}  # shape: launches timed


BWD_SHAPES = [  # (name, B, Sq, Sk, H, Hkv, D, causal, dtype)
    # the training step's attention (llama2_7b_lora, bench.py:476-480); timed
    ("train_step", 8, 2048, 2048, 32, 32, 128, True, torch.bfloat16),
    # the MoE training step's attention (mixtral_8x7b, GQA 32/8); timed
    ("mixtral_train", 8, 2048, 2048, 32, 8, 128, True, torch.bfloat16),
    ("llama3_8b", 1, 2048, 2048, 32, 8, 128, True, torch.bfloat16),
    ("ragged", 2, 100, 100, 4, 4, 64, False, torch.float32),
    ("sq_ne_sk", 2, 64, 192, 8, 4, 32, True, torch.float32),
    ("ragged_bf16", 2, 100, 100, 4, 4, 64, False, torch.bfloat16),
    ("sq_ne_sk_bf16", 2, 64, 192, 8, 4, 32, True, torch.bfloat16),
    # ragged D=128 tiles (1500 is no multiple of 128) under GQA
    ("ragged_gqa", 2, 1500, 1500, 32, 8, 128, True, torch.bfloat16),
    # Sk > Sq under the causal mask, ragged key tile: keys >= Sq see no
    # query (whole 128-key tiles of the dK/dV kernel among them), so their
    # dK/dV must be zero
    ("sk_gt_sq_bf16", 1, 100, 300, 8, 2, 128, True, torch.bfloat16),
]
FP32_BWD_TOL = 1e-4  # kernel vs plain in fp32: summation order only
TIMED_BWD = ("train_step", "mixtral_train")
# bf16 shapes held by the per-element rule of ulp_rule_excess with floor
# 2 * gap in place of max error <= 2 * gap + FP32_BWD_TOL: at the Mixtral
# shape kernel and plain dV (summed over a GQA group of 4) land one ulp
# apart (0.0625 at |dV| in [8, 16)) where 2 * gap is just under it. Every
# other shape keeps the 2 * gap bound; each row reports both.
ULP_RULE_BWD = ("mixtral_train",)
# The ring (ring_vs_flash) merges bf16 partials: each block's O, dQ, dK,
# dV leaves the kernel rounded to bf16 before the fp32 merge, where one
# call over the whole sequence rounds once, so ring and single call can
# land one ulp apart where 2 * gap is under one ulp (non-causal O at 4 x
# 2048: 0.000977 against 2 * gap + 1e-4 = 0.000896). RING_RULE holds
# each of them (1) within the single call's own 2 * gap + 1e-4 of the
# fp32 call on the same inputs, and (2) to the single bf16 call by the
# per-element rule of ULP_RULE_BWD; LSE (fp32) by 2 * gap + 1e-4. Each
# row also reports the plain 2 * gap rule (within_2gap).
TRAIN_BATCH = 8
TRAIN_WARMUP, TRAIN_TIMED = 2, 5
MOE_LAYERS = 4  # mixtral_8x7b's 32 layers cut to 4: 46.7 B params do not fit 80 GB
MOE_TOKENS = 1024  # tokens of the one-layer card-vs-CPU check
MOE_FP32_TOL = 1e-4  # card vs CPU in fp32 (TF32 off): summation order only
MESH_TIMED = 3  # timed steps of the sharded MoE step (after TRAIN_WARMUP)
# the pipelined step: llama2_7b_lora's 32 layers as 4 stages of 8, the
# batch of 8 as 8 microbatches of one row
PIPE_STAGES, PIPE_MICRO = 4, 8
RING_N = 4  # ranks of the ring driven on one card
# the paged batcher (llama3_8b, bf16): pages of 64 tokens, 8 slots of
# MAX_LEN, so 1 + 8 * 32 = 257 pages; the prefix phase shares a prompt of
# 1,024 tokens (16 pages) between 8 requests with suffixes of 100-400
PAGE_SIZE = 64
PREFIX_TOKENS = 1024
SUFFIX_TOKENS = np.linspace(100, 400, 8).astype(int).tolist()
# the overcommitted pool: 16 pages for 8 requests of 60-120 prompt tokens
# and OVERCOMMIT_TOKENS each, which end on 2-3 pages each
OVERCOMMIT_PAGES, OVERCOMMIT_TOKENS, OVERCOMMIT_PROMPTS = 1 + 16, 64, (60, 120)
COLLECTIVE_BYTES = 256 * 2 ** 20  # the timed bf16 allreduce
# (name, B, S of the whole sequence, H, Hkv, D, causal, reference): llama3_8b's
# attention (long context is what the sequence axis is for), bf16; the
# ring held against one flash call over the whole sequence, or against
# the plain versions
# the RL phases: every learner at its config's defaults with hidden
# (64, 64), RL_UPDATES updates on the card and on the CPU from the same
# numpy init, update ms the median of RL_TIMED; Anakin's train() at
# thousands of envs (arXiv 2104.06272 §3), T = 16, 4 update steps a train()
RL_HIDDEN = (64, 64)
RL_UPDATES, RL_TIMED, RL_TOL = 5, 50, 2e-5
ANAKIN_ENVS = (4096, 65536)
ANAKIN_T, ANAKIN_ITERS, ANAKIN_TIMED, ANAKIN_RETURN_ITERS = 16, 4, 3, 20
RING_SHAPES = [("llama3_8b_32k", 1, RING_N * 8192, 32, 8, 128, True, "flash"),
               ("noncausal_8k", 1, RING_N * 2048, 32, 8, 128, False, "flash"),
               ("plain_4k", 1, RING_N * 1024, 32, 8, 128, True, "plain")]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


@contextlib.contextmanager
def phase(name):
    t0 = time.perf_counter()
    try:
        yield
    except BaseException as e:
        emit({"phase": name, "ok": False, "error": repr(e)[:500]})
        raise
    emit({"phase": name, "ok": True, "s": time.perf_counter() - t0})


QUEUE_CYCLES_A_CALL = 200_000  # ~100 us of GPU clock: a call's launch takes the host ~44 us


def cuda_ms(fn, iters: int) -> float:
    """Mean ms of ``fn`` over ``iters`` runs after one warm-up, by CUDA events.
    The card first spins while the host queues the runs, so a call shorter
    than its launch is timed on the device and not at the host's launch
    rate (on an H100, a 23 us flash call read 44 us without the spin)."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(QUEUE_CYCLES_A_CALL * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# device activity kinds for a profile's breakdown, by kernel-name substring
# (flash_fwd_kernel_sm90 and flash_bwd_dq_kernel_sm90 match the first). The
# third names PyTorch's indexing kernels: advanced indexing and index_copy
# (the embedding and the MoE dispatch and combine), index_select and
# scatter/gather (their backward, the routing's slots), index_put's
# accumulating backward and its radix sort, top-k and its sort, and scans
KINDS = (("flash attention kernels", ("flash_fwd_kernel", "flash_bwd_")),
         ("cuBLAS matmuls", ("nvjet", "gemm", "gemv", "xmma", "cutlass")),
         ("index, top-k, sort and scan kernels",
          ("index_elementwise_kernel", "indexSelect", "scatter_gather_elementwise",
           "indexing_backward_kernel", "DeviceRadixSort", "topk", "TopK", "SortKV",
           "kernel_scan_", "DeviceScan")),
         # the sharded step's collectives (at one rank NCCL may copy with a
         # memcpy, which falls in "other", or do nothing for an in-place call)
         ("NCCL collectives", ("nccl", "Nccl")))


def profiled(fn, top: int = 8, counts: bool = False):
    """Run ``fn`` once under torch.profiler: wall ms, device-busy ms (the
    union of the device activity intervals, so nothing counts twice), the
    device activities and how many of them are kernels (not a memcpy or
    memset), the summed device ms of each of KINDS (the rest as "other"),
    the launches and ms of each flash, indexing and NCCL kernel, and the
    top device activities by summed time; with ``counts``, every device
    activity's name and count as well. Raises if the profile holds no
    device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:  # every fn profiled here runs on the card
        raise AssertionError("a profile holds no device activity: the profiler lost its "
                             "records (ROADMAP.md Queue C, 'a trace loses its device "
                             "activities')")
    busy_us, end, by_name = 0.0, float("-inf"), {}
    for start, stop, name in spans:
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
        n, us = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, us + stop - start)
    busy_ms = busy_us / 1e3
    by_kind = {}
    for name, (n, us) in by_name.items():
        kind = next((k for k, subs in KINDS if any(s in name for s in subs)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + us / 1e3
    tops = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]

    def members(subs, width):
        return {name[:width]: {"count": n, "ms": us / 1e3}
                for name, (n, us) in by_name.items() if any(s_ in name for s_ in subs)}

    extra = {"activity_counts": {k: n for k, (n, _) in by_name.items()}} if counts else {}
    return {**extra, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1 - busy_ms / wall_ms),
            "device_activities": len(spans),
            "device_kernels": sum(1 for *_, name in spans
                                  if not name.startswith(("Memcpy", "Memset"))),
            "device_ms_by_kind": by_kind, "flash_kernels": members(KINDS[0][1], 80),
            "index_kernels": members(KINDS[2][1], 120),
            "nccl_kernels": members(KINDS[3][1], 80),
            "top_device_activities": [{"name": k[:80], "count": n, "ms": us / 1e3}
                                      for k, (n, us) in tops]}


def trace_holds(path: str) -> dict:
    """What a gpu_profile trace (Chrome JSON) holds: its events by category,
    the kernels, the flash forward kernels, and the runtime or driver
    launch calls with the threads that made them; the span of its events
    and of its kernels, in us."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if "ts" in e]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    launches = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "aunch" in e.get("name", "")]
    cats = {}
    for e in events:
        cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1

    def span(es):
        return [min(float(e["ts"]) for e in es), max(float(e["ts"]) for e in es)] if es else None

    return {"by_category": cats, "kernels": len(kernels),
            "flash": sum("flash_fwd_kernel" in e.get("name", "") for e in kernels),
            "launch_calls": [e["name"] for e in launches],
            "launch_threads": sorted({str(e.get("tid")) for e in launches}),
            "span_us": span(events), "launch_span_us": span(launches),
            "kernel_span_us": span(kernels)}


def kept_pairs(sq, sk, causal):
    """(query, key) pairs the mask keeps: under the top-left causal mask
    query i sees min(i + 1, Sk) keys."""
    return sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk


def attention_bound_ms(b, sq, sk, h, hkv, d, causal, dtype):
    """Least time for the flash forward on these inputs: the larger of its
    bytes (q, k, v read once; O and the fp32 LSE written once) over HBM
    rate and its multiply-adds over the peak rate for the input type."""
    es = torch.finfo(dtype).bits // 8
    nbytes = es * (2 * b * sq * h * d + 2 * b * sk * hkv * d) + 4 * b * h * sq
    flops = 4 * b * h * d * kept_pairs(sq, sk, causal)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def bwd_bound_ms(kernel, b, sq, sk, h, hkv, d, causal, dtype):
    """Least time for one backward kernel on these inputs: the larger of
    its bytes (q, k, v, dO read once, LSE and Delta in fp32, its outputs
    written once) over HBM rate and its operations over the peak rate for
    the input type: per kept (q, k) pair and head, 6*D for the dQ pass (S,
    dP, dQ) and 8*D for the dK/dV pass (S, dP, dV, dK)."""
    es = torch.finfo(dtype).bits // 8
    q_el, kv_el = b * sq * h * d, b * sk * hkv * d
    dq_pass = kernel == "flash_bwd_dq"
    nbytes = (es * (2 * q_el + 2 * kv_el) + 2 * 4 * b * h * sq
              + es * (q_el if dq_pass else 2 * kv_el))
    flops = (6 if dq_pass else 8) * b * h * d * kept_pairs(sq, sk, causal)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def shape_label(b, sq, h, hkv, d, causal, dtype) -> str:
    return (f"B={b} S={sq} H={h}/{hkv} D={d}{' causal' if causal else ''} "
            f"{str(dtype).removeprefix('torch.').replace('bfloat16', 'bf16')}")


def bf16_ulps(x):
    """One bf16 ulp at each element's magnitude, 2^(floor(log2|x|) - 7);
    0 where x is 0."""
    _, e = torch.frexp(x.float())
    ulp = torch.finfo(torch.bfloat16).eps * torch.exp2((e - 1).float())
    return torch.where(x == 0, 0.0, ulp)


def ulp_rule_excess(out, ref, floor: float, slack: float) -> float:
    """max_i |out_i - ref_i| - (max(floor, ulp(|ref_i|)) + slack): at most
    0 where every element is within ``floor`` of ``ref`` or, where its own
    bf16 ulp is more, within one ulp (two roundings to bf16 of fp32 values
    that differ by summation order alone can land one ulp apart), plus
    ``slack``, fp32's summation-order tolerance."""
    bound = bf16_ulps(ref).clamp_min(floor) + slack
    return float(((out.float() - ref.float()).abs() - bound).max())


def max_abs(x, y) -> float:
    return float((x.float() - y.float()).abs().max())


def prompt_texts(lengths, seed):
    """ByteTokenizer prompts: seeded English-like text of the given byte lengths."""
    words = ("the of and to in is was for on that with as by at from his her "
             "which were are this be had not they first new two time after "
             "years city also may system model serve request token cache").split()
    rng = np.random.default_rng(seed)
    out = []
    for n in lengths:
        text = ""
        while len(text) < n:
            text += words[int(rng.integers(len(words)))] + " "
        out.append(text[:n])
    return out


RUNTIME_CALLS = 1000  # no-op actor calls and put/get round trips timed
RUNTIME_PUT_BYTES = 64 * 2 ** 20  # the CUDA tensor put and got
RUNTIME_LEFT_BYTES = 256 * 2 ** 20  # allocated after shutdown beyond the start


class ServedLlama:
    """runtime_local's actor: an LLMEngine and a ContinuousLLMEngine over
    the params of the ObjectRef its constructor is given."""

    def __init__(self, config, params_ref):
        import ray_tpu_torch as rt
        from ray_tpu_torch.llm import ContinuousLLMEngine, LLMEngine

        params = rt.get(params_ref)
        self.engine = LLMEngine(config, params=params)
        self.cengine = ContinuousLLMEngine(config, params=params)

    def data_ptrs(self):
        return [{k: t.data_ptr() for k, t in tree_items(p)}
                for p in (self.engine.generator.params, self.cengine.batcher.params)]

    def generate_tokens(self, ids):
        return self.engine.generate_tokens(ids)

    def submit(self, prompt):
        return self.cengine.submit(prompt).result(timeout=600)

    def stats(self):
        return dict(self.cengine.batcher.stats)

    def stream(self, ids, sampling):
        yield from self.engine.generator.generate_stream(ids, sampling)

    def ping(self):
        return None

    def close(self):
        self.cengine.shutdown()


def prefill_attention(q, k, v):
    """runtime_local's num_gpus=1 task: one flash call, its output on the card."""
    from ray_tpu_torch.ops import attention as A

    return A.flash_attention(q, k, v, causal=True)


def attention_grads(q, k, v, do):
    """runtime_local's traced backward: dQ, dK, dV of one flash call, run
    on a task's thread (the profiler runs on the caller's)."""
    from ray_tpu_torch.ops import attention as A

    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    out = A.flash_attention(q, k, v, causal=True)
    return torch.autograd.grad(out, (q, k, v), do)


def median_host_us(fn, n: int) -> float:
    """Median µs of ``fn`` over ``n`` calls after one warm-up, host clock."""
    fn()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return 1e6 * float(np.median(times))


def runtime_local(cfg, config, params, ids4, prompts8, direct, smi) -> dict:
    """The actor runtime in local mode: llama3_8b served from an actor over
    the serving phase's params, with the kernels' counts from 0 around it.
    ``direct`` holds the direct engines (``cengine``) and their results on
    the same inputs (``tokens``, ``texts``, ``stream``). Returns the path's
    launches; the actor and the runtime are gone on return."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.accelerators import get_accelerator_manager
    from ray_tpu_torch.ops import attention as A

    with phase("runtime_direct_round"):
        # the 8 prompts again through the direct engine already built, the
        # yardstick of the actor's round (uncounted: before the reset)
        cstats = direct["cengine"].batcher.stats
        out_before = cstats["tokens_out"]
        t0 = time.perf_counter()
        futs = [direct["cengine"].submit(p) for p in prompts8]
        direct_texts = [f.result(timeout=600) for f in futs]
        direct_s = time.perf_counter() - t0
        direct_tokens_out = cstats["tokens_out"] - out_before
        emit({"direct_continuous_s": direct_s, "tokens_out": direct_tokens_out,
              "texts_equal_first_round": direct_texts == direct["texts"]})
        if direct_texts != direct["texts"]:
            raise AssertionError("the direct engine's second round gave other texts")

    reset_launches(A)
    with phase("runtime_local"):
        mem_before = torch.cuda.memory_allocated()
        rt.init(local_mode=True)
        try:
            res = rt.cluster_resources()
            emit({"runtime_resources": res, "card": smi, "accelerator_type":
                  get_accelerator_manager("GPU").get_current_node_accelerator_type()})
            if "GPU" not in res or res["GPU"] != torch.cuda.device_count():
                raise AssertionError(f"local mode advertises {res}, "
                                     f"{torch.cuda.device_count()} cards")

            ref = rt.put(params)
            served = rt.remote(num_gpus=1, max_concurrency=8)(ServedLlama).remote(config, ref)
            ptrs = rt.get(served.data_ptrs.remote())
            caller_ptrs = {k: t.data_ptr() for k, t in tree_items(params)}
            shared = all(p == caller_ptrs for p in ptrs)
            emit({"actor_params_share_storage": shared, "leaves": len(caller_ptrs),
                  "allocated_before_actor": mem_before,
                  "allocated_with_actor": torch.cuda.memory_allocated()})
            if not shared:
                raise AssertionError("the actor's params are not the caller's tensors")

            before = A.flash_fwd_launches
            tokens = rt.get(served.generate_tokens.remote(ids4))
            launches_gen = A.flash_fwd_launches - before
            emit({"actor_tokens_equal_direct": tokens == direct["tokens"],
                  "flash_fwd_launches": launches_gen})
            if tokens != direct["tokens"] or launches_gen != cfg.layers:
                raise AssertionError(f"actor generate_tokens: {launches_gen} launches, "
                                     f"tokens equal: {tokens == direct['tokens']}")

            before = A.flash_fwd_launches
            t0 = time.perf_counter()
            texts = rt.get([served.submit.remote(p) for p in prompts8])
            actor_cont_s = time.perf_counter() - t0
            launches_cont = A.flash_fwd_launches - before
            stats = rt.get(served.stats.remote())
            emit({"actor_continuous_s": actor_cont_s, "direct_continuous_s": direct_s,
                  "actor_over_direct": actor_cont_s / direct_s, "stats": stats,
                  "flash_fwd_launches": launches_cont,
                  "texts_equal_direct": texts == direct["texts"]})
            if stats["finished"] != len(prompts8) or \
                    launches_cont != cfg.layers * stats["admitted"] or \
                    texts != direct["texts"] or stats["tokens_out"] != direct_tokens_out:
                raise AssertionError(f"actor continuous engine: {stats}, "
                                     f"{launches_cont} launches, texts equal: "
                                     f"{texts == direct['texts']}, direct tokens_out "
                                     f"{direct_tokens_out}")

            before = A.flash_fwd_launches
            stream = served.stream.remote(ids4[0], config.sampling)
            streamed = [rt.get(r) for r in stream]
            launches_stream = A.flash_fwd_launches - before
            emit({"actor_stream_equals_direct": streamed == direct["stream"],
                  "stream_tokens": len(streamed), "flash_fwd_launches": launches_stream})
            if streamed != direct["stream"] or launches_stream != cfg.layers:
                raise AssertionError(f"actor stream {streamed} != {direct['stream']} "
                                     f"({launches_stream} launches)")

            gen = torch.Generator(device="cuda").manual_seed(SEED)
            q = torch.randn((1, MAX_LEN, 32, 128), generator=gen, device="cuda").bfloat16()
            k, v = (torch.randn((1, MAX_LEN, 8, 128), generator=gen, device="cuda").bfloat16()
                    for _ in range(2))
            attend = rt.remote(num_gpus=1)(prefill_attention)
            logdir = tempfile.mkdtemp(prefix="runtime_local_trace_")
            try:
                with rt.gpu_profile(logdir) as prof:
                    out = rt.get(attend.remote(q, k, v))
                    torch.cuda.synchronize()
                held = trace_holds(prof.path)
            finally:
                shutil.rmtree(logdir, ignore_errors=True)
            traced = held["flash"] > 0
            emit({"task_output_device": str(out.device), "trace_has_flash_fwd": traced,
                  "trace_holds": held})
            if out.device != torch.device("cuda", 0) or not traced:
                raise AssertionError(f"num_gpus=1 task: output on {out.device}, "
                                     f"traced: {traced}, the trace held {held}")

            # the error's name and message only: its traceback's frames hold
            # the actor (and through it the engines and the KV cache)
            rejected = None
            try:
                rt.get(served.generate_tokens.remote([[1] * (MAX_LEN + 1)]))
            except ValueError as e:
                rejected = (type(e).__name__, isinstance(e, rt.exceptions.RayTaskError),
                            str(getattr(e, "cause", e)))
            emit({"rejected_as": rejected})
            if rejected is None or not rejected[1]:
                raise AssertionError(f"an over-long prompt raised {rejected}")

            call_us = median_host_us(lambda: rt.get(served.ping.remote()), RUNTIME_CALLS)
            x = torch.empty(RUNTIME_PUT_BYTES // 2, dtype=torch.bfloat16, device="cuda")
            same = rt.get(rt.put(x)) is x
            put_get_us = median_host_us(lambda: rt.get(rt.put(x)), RUNTIME_CALLS)
            emit({"actor_call_us": call_us, "put_get_cuda_us": put_get_us,
                  "put_get_bytes": RUNTIME_PUT_BYTES, "get_put_is_same_tensor": same,
                  "calls": RUNTIME_CALLS, "clock": "host, median", "card": smi})
            if not same:
                raise AssertionError("get(put(x)) is not x in local mode")
            launches = read_launches(A)
            # the path's counts are read; what follows compares, uncounted
            expected = cfg.layers * (2 + stats["admitted"]) + 1  # generate, the 8, the stream; the task
            if launches != {"flash_fwd": expected, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}:
                raise AssertionError(f"runtime_local launched {launches}, "
                                     f"expected flash_fwd {expected}")
            direct_out = A.flash_attention(q, k, v, causal=True)
            emit({"task_output_equals_direct": bool(torch.equal(out, direct_out))})
            if not torch.equal(out, direct_out):
                raise AssertionError("the task's flash output differs from the direct call's")
            # the sm90 backward launchers under the profiler, off its thread:
            # a task's backward at the training shape, traced, against the
            # same call made directly (uncounted, after the read)
            B, S, H = BWD_SHAPES[0][1], BWD_SHAPES[0][2], BWD_SHAPES[0][4]
            q, k, v, do = (torch.randn((B, S, H, 128), generator=gen, device="cuda").bfloat16()
                           for _ in range(4))
            logdir = tempfile.mkdtemp(prefix="runtime_local_trace_")
            try:
                with rt.gpu_profile(logdir) as prof:
                    grads = rt.get(rt.remote(num_gpus=1)(attention_grads).remote(q, k, v, do))
                    torch.cuda.synchronize()
                with open(prof.path) as f:
                    trace = f.read()
            finally:
                shutil.rmtree(logdir, ignore_errors=True)
            traced_bwd = {name: name in trace for name in
                          ("flash_bwd_dq_kernel_sm90", "flash_bwd_dkv_kernel_sm90")}
            del trace
            grads_equal = all(torch.equal(a, b) for a, b in
                              zip(grads, attention_grads(q, k, v, do)))
            emit({"bwd_shape": [B, S, H, H, 128], "trace_has_bwd": traced_bwd,
                  "task_grads_equal_direct": grads_equal})
            if not all(traced_bwd.values()) or not grads_equal:
                raise AssertionError(f"traced backward task: kernels {traced_bwd}, "
                                     f"grads equal {grads_equal}")
            rt.get(served.close.remote())
            rt.kill(served)
        finally:
            rt.shutdown()
        del ref, served, stream, out, direct_out, x, q, k, v, do, grads
        gc.collect()
        left = torch.cuda.memory_allocated() - mem_before
        emit({"allocated_after_shutdown": mem_before + left,
              "allocated_before_actor": mem_before, "left_bytes": left})
        # the actor's KV cache (2 GiB) must be gone; what may stay is a
        # cuBLAS workspace (32 MiB) of each thread that ran a matmul
        if left > RUNTIME_LEFT_BYTES:
            raise AssertionError(f"{left} bytes still allocated after kill and shutdown")
    return launches


def serving_phases(kernels, smi) -> tuple:
    """The serving path: serve llama3_8b at full width through LLMEngine and
    ContinuousLLMEngine (launches counted from 0 around it), then through
    the actor runtime in local mode (runtime_local) and paged KV, then time
    prefill and decode and hold the kernel prefill against the plain
    formulation. Returns the serving, paged and runtime paths' launches;
    everything it allocates is freed on return."""
    from ray_tpu_torch.llm import ContinuousLLMEngine, LLMConfig, LLMEngine, SamplingParams
    from ray_tpu_torch.models import transformer as T
    from ray_tpu_torch.models.decoding import forward_cached, init_cache
    from ray_tpu_torch.ops import attention as A

    cfg = T.config("llama3_8b", param_dtype=torch.bfloat16)
    prompts4 = prompt_texts([100, 600, 1100, 1500], SEED)
    prompts8 = prompt_texts(np.linspace(100, 1500, 8).astype(int).tolist(), SEED + 1)
    greedy = SamplingParams(max_tokens=MAX_TOKENS)
    config = LLMConfig(model=cfg, max_len=MAX_LEN, sampling=greedy, seed=SEED,
                       cache_slots=8)
    batcher = None
    try:
        with phase("engine_init"):
            t0 = time.perf_counter()
            engine = LLMEngine(config)
            torch.cuda.synchronize()
            params = engine.generator.params
            nbytes = sum(t.numel() * t.element_size() for t in
                         [params["embed"], params["ln_f"], params["unembed"],
                          *params["blocks"].values()])
            emit({"model": "llama3_8b", "layers": cfg.layers, "hidden": cfg.hidden,
                  "params": cfg.num_params(), "param_bytes": nbytes,
                  "init_s": time.perf_counter() - t0})

        # ---- the main path: counts from 0, read right after ----------
        reset_launches(A)
        with phase("engine"):
            tok = engine.tokenizer
            ids4 = [tok.encode(p) for p in prompts4]
            t0 = time.perf_counter()
            outs = engine.generate_tokens(ids4)
            torch.cuda.synchronize()
            gen_s = time.perf_counter() - t0
            launches_engine = A.flash_fwd_launches
            emit({"engine_generate_s": gen_s, "prompt_tokens": [len(i) for i in ids4],
                  "completion_tokens": [len(o) for o in outs],
                  "flash_fwd_launches": launches_engine})
            if launches_engine != cfg.layers:
                raise AssertionError(
                    f"one prefill call launched flash_fwd {launches_engine} "
                    f"times, expected {cfg.layers}")
            if any(len(o) != MAX_TOKENS or not all(0 <= t < cfg.vocab_size for t in o)
                   for o in outs):
                raise AssertionError(f"engine completions malformed: {outs}")

        with phase("continuous_engine"):
            t0 = time.perf_counter()
            cengine = ContinuousLLMEngine(config, params=params)
            batcher = cengine.batcher
            futs = [cengine.submit(p) for p in prompts8]
            ctexts = [f.result(timeout=600) for f in futs]
            cont_s = time.perf_counter() - t0
            launches_cont = A.flash_fwd_launches - launches_engine
            stats = dict(batcher.stats)
            # random weights rarely emit byte ids, so the texts are mostly
            # empty; stats["tokens_out"] counts the tokens
            emit({"continuous_s": cont_s, "stats": stats,
                  "completion_chars": [len(t) for t in ctexts],
                  "flash_fwd_launches": launches_cont})
            if stats["finished"] != len(prompts8) or launches_cont != cfg.layers * stats["admitted"]:
                raise AssertionError(f"continuous engine: {stats}, {launches_cont} launches")
        with phase("generate_stream"):
            # Generator.generate_stream: one prompt, one prefill call
            before = A.flash_fwd_launches
            streamed = list(engine.generator.generate_stream(ids4[0], greedy))
            torch.cuda.synchronize()
            launches_stream = A.flash_fwd_launches - before
            emit({"stream_tokens": len(streamed), "flash_fwd_launches": launches_stream})
            if len(streamed) != MAX_TOKENS or launches_stream != cfg.layers:
                raise AssertionError(f"generate_stream: {len(streamed)} tokens, "
                                     f"{launches_stream} launches")
        launches = read_launches(A)
        kernels["flash_fwd"]["launches"] = launches["flash_fwd"]
        # ---- end of the main path ------------------------------------

        with phase("generate_stream_vs_generate"):
            with torch.no_grad():
                ref = engine.generator.generate([ids4[0]], greedy)[0]
            emit({"stream_equals_generate": streamed == ref})
            if streamed != ref:
                raise AssertionError(f"generate_stream {streamed} != generate {ref}")

        runtime = runtime_local(
            cfg, config, params, ids4, prompts8,
            {"cengine": cengine, "tokens": outs, "texts": ctexts, "stream": streamed}, smi)

        paged = paged_phases(cfg, params, [tok.encode(p) for p in prompts8], batcher, greedy)

        with phase("serving_times"):
            gen_ = engine.generator
            t0 = time.perf_counter()
            nxt, cache, g = gen_._start(ids4, greedy, seed=1)
            torch.cuda.synchronize()
            prefill_ms = 1e3 * (time.perf_counter() - t0)
            steps = 16
            t0 = time.perf_counter()
            for _ in range(steps):
                nxt = gen_._decode(nxt, cache, g, 0.0, 0)
            torch.cuda.synchronize()
            decode_ms = 1e3 * (time.perf_counter() - t0) / steps
            emit({"prefill_ms": prefill_ms, "prefill_tokens": sum(map(len, ids4)),
                  "prefill_padded_rows": len(ids4) * max(map(len, ids4)),
                  "decode_ms_per_token": decode_ms, "decode_batch": len(ids4),
                  "clock": "host, synchronized"})
            emit({"profile": "prefill", **profiled(lambda: gen_._start(ids4, greedy, seed=1))})
            emit({"profile": "decode x4", **profiled(
                lambda: [gen_._decode(nxt, cache, g, 0.0, 0) for _ in range(4)])})
            del cache

        with phase("prefill_vs_plain"):
            # The kernel's prefill against the JAX package's formulation
            # (plain _attend_cached over the length-masked cache) on one
            # prompt, same weights. Checked in fp32 compute, where the two
            # differ only by summation order: 1e-3 abs on logits of
            # magnitude ~5 after 32 layers. In bf16 two orderings each
            # round differently at every layer, so the bf16 gap is only
            # reported, beside the gap bf16 opens against fp32.
            ids = torch.tensor([ids4[0]], device="cuda")
            s = ids.shape[1]
            pos = torch.arange(s, device="cuda")[None, :]
            mask = torch.arange(s, device="cuda")[None, :] < s
            cfg32 = T.config(cfg, dtype=torch.float32)

            def last_logits(c, prefill):
                lg, _ = forward_cached(c, params, ids, pos,
                                       init_cache(c, 1, s, device="cuda"),
                                       None if prefill else mask, prefill=prefill)
                return lg[0, -1].float()

            with torch.no_grad():
                k32, p32 = last_logits(cfg32, True), last_logits(cfg32, False)
                k16, p16 = last_logits(cfg, True), last_logits(cfg, False)
            gap32 = float((k32 - p32).abs().max())
            row = {"prompt_tokens": s, "fp32_kernel_vs_plain": gap32, "tol": 1e-3,
                   "bf16_kernel_vs_plain": float((k16 - p16).abs().max()),
                   "bf16_vs_fp32": float((p16 - p32).abs().max()),
                   "argmax": [int(x.argmax()) for x in (k32, p32, k16, p16)],
                   "logits_max_abs": float(p32.abs().max())}
            emit(row)
            if not (gap32 <= 1e-3 and bool(torch.isfinite(k16).all())):
                raise AssertionError(f"kernel prefill disagrees with the plain formulation: {row}")
    finally:
        if batcher is not None:
            batcher.shutdown()
    return launches, paged, runtime


def torch_calls(fn) -> list:
    """The ATen ops ``fn`` dispatches, in order (host side, exact)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Log(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    with Log() as log:
        fn()
    torch.cuda.synchronize()
    return log.ops


def timed_steps(step, n: int) -> float:
    """Host ms per call of ``step`` over ``n`` calls, synchronised."""
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / n


def first_token_s(batcher, prompt, sampling):
    """(seconds from submit_stream to its first token, all its tokens)."""
    t0 = time.perf_counter()
    stream = batcher.submit_stream(prompt, sampling)
    first = next(stream)
    ttft = time.perf_counter() - t0
    return ttft, [first, *stream]


def paged_phases(cfg, params, ids8, dense, greedy) -> dict:
    """The paged serving path: ray_tpu_torch.models.paged_kv.PagedBatcher
    on llama3_8b (``params``) with the flash launches counted from 0
    around paged_engine, paged_prefix and paged_overcommit. Every flash
    launch is a prefill's: L for a cold one, 2·L for one over a reused
    prefix (recorded per call). Then the warm prefill's logits against
    the cold one's, and decode ms/token paged against the slot-dense
    ``dense`` batcher at batch 8. Returns the path's launches."""
    from concurrent.futures import ThreadPoolExecutor

    from ray_tpu_torch.models.decoding import forward_cached, init_cache
    from ray_tpu_torch.models.paged_kv import PagedBatcher, prefix_keys
    from ray_tpu_torch.models.transformer import config
    from ray_tpu_torch.ops import attention as A

    L = cfg.layers

    def recording(pb):
        """Record the prefix length of each prefill ``pb`` runs."""
        prefills, plain = [], pb._prefill

        def spy(tokens, length, prefix_pages):
            prefills.append(len(prefix_pages) * pb.page_size)
            return plain(tokens, length, prefix_pages)

        pb._prefill = spy
        return prefills

    def expected_launches(prefills):
        return sum(L if p == 0 else 2 * L for p in prefills)

    with phase("paged_dense_reference"):
        want = [f.result(timeout=600) for f in [dense.submit(i, greedy) for i in ids8]]

    pb = over = None
    try:
        pb = PagedBatcher(cfg, params, max_len=MAX_LEN, slots=8, page_size=PAGE_SIZE,
                          seed=SEED, device="cuda")
        prefills = recording(pb)
        ptrs = (pb.pool_k.data_ptr(), pb.pool_v.data_ptr())
        pool_bytes = 2 * pb.pool_k.numel() * pb.pool_k.element_size()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        # ---- the paged path: counts from 0, read right after --------
        reset_launches(A)
        with phase("paged_engine"):
            t0 = time.perf_counter()
            outs = [f.result(timeout=600) for f in [pb.submit(i, greedy) for i in ids8]]
            wall_s = time.perf_counter() - t0
            launches = A.flash_fwd_launches
            row = {"paged_s": wall_s, "stats": dict(pb.stats), "pages": pb.kv.num_pages,
                   "pool_bytes": pool_bytes, "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
                   "flash_fwd_launches": launches, "prefill_prefix_lens": list(prefills),
                   "tokens_equal_dense": outs == want}
            emit(row)
            if outs != want:
                raise AssertionError(f"paged tokens differ from the slot-dense batcher's: "
                                     f"{[i for i, (a, b) in enumerate(zip(outs, want)) if a != b]}")
            if launches != expected_launches(prefills) or prefills != [0] * len(ids8):
                raise AssertionError(f"paged_engine: {launches} launches for prefills {prefills}")

        with phase("paged_prefix"):
            rng = np.random.RandomState(SEED + 2)
            prefix = rng.randint(0, cfg.vocab_size, PREFIX_TOKENS).tolist()
            suffixes = [[100 + i, *rng.randint(0, cfg.vocab_size, n - 1).tolist()]
                        for i, n in enumerate(SUFFIX_TOKENS)]  # distinct first tokens
            prompts = [prefix + sfx for sfx in suffixes]
            stats0, done0 = dict(pb.stats), len(prefills)
            cold_ttft, first_out = first_token_s(pb, prompts[0], greedy)
            with ThreadPoolExecutor(len(prompts) - 1) as ex:
                warm = list(ex.map(lambda p: first_token_s(pb, p, greedy), prompts[1:]))
            hits = pb.stats["prefix_hit_tokens"] - stats0["prefix_hit_tokens"]
            prefilled = pb.stats["prefill_tokens"] - stats0["prefill_tokens"]
            want_prefilled = len(prompts[0]) + sum(SUFFIX_TOKENS[1:])
            # one more warm request alone: the TTFT to hold against the cold one
            alone = [200, *suffixes[0][1:]]
            warm_alone_ttft, _ = first_token_s(pb, prefix + alone, greedy)
            row = {"prefix_tokens": PREFIX_TOKENS, "suffix_tokens": SUFFIX_TOKENS,
                   "prefix_hit_tokens": hits, "want_prefix_hit_tokens": 7 * PREFIX_TOKENS,
                   "prefill_tokens": prefilled, "want_prefill_tokens": want_prefilled,
                   "ttft_cold_ms": 1e3 * cold_ttft, "ttft_warm_alone_ms": 1e3 * warm_alone_ttft,
                   "ttft_warm_concurrent_ms": [1e3 * t for t, _ in warm],
                   "prefill_prefix_lens": prefills[done0:],
                   "completion_tokens": [len(first_out)] + [len(o) for _, o in warm],
                   "clock": "host, submit to first streamed token"}
            emit(row)
            if hits != 7 * PREFIX_TOKENS or prefilled != want_prefilled:
                raise AssertionError(f"prefix reuse: {row}")
            if any(len(o) != MAX_TOKENS for o in [first_out] + [o for _, o in warm]):
                raise AssertionError(f"paged_prefix completions malformed: {row}")

        with phase("paged_overcommit"):
            over = PagedBatcher(cfg, params, max_len=MAX_LEN, slots=8, page_size=PAGE_SIZE,
                                seed=SEED, num_pages=OVERCOMMIT_PAGES, device="cuda")
            over_prefills = recording(over)
            rng = np.random.RandomState(SEED + 3)
            prompts_o = [rng.randint(0, cfg.vocab_size, int(n)).tolist()
                         for n in np.linspace(*OVERCOMMIT_PROMPTS, 8)]
            sp = dataclasses.replace(greedy, max_tokens=OVERCOMMIT_TOKENS)
            t0 = time.perf_counter()
            outs_o = [f.result(timeout=600) for f in [over.submit(p, sp) for p in prompts_o]]
            row = {"pages": OVERCOMMIT_PAGES, "max_tokens": OVERCOMMIT_TOKENS,
                   "s": time.perf_counter() - t0, "stats": dict(over.stats),
                   "lengths": [len(o) for o in outs_o], "prefills": len(over_prefills),
                   "free_pages_after": len(over.kv.free)}
            emit(row)
            if (over.stats["preempted"] < 1 or any(len(o) != OVERCOMMIT_TOKENS for o in outs_o)
                    or len(over.kv.free) != OVERCOMMIT_PAGES - 1):
                raise AssertionError(f"overcommit: {row}")
        launches = read_launches(A)
        want_launches = expected_launches(prefills) + expected_launches(over_prefills)
        emit({"paged_path_launches": launches, "expected_flash_fwd": want_launches})
        if launches["flash_fwd"] != want_launches or launches["flash_bwd_dq"] or \
                launches["flash_bwd_dkv"]:
            raise AssertionError(f"paged path launched {launches}, expected {want_launches}")
        if (pb.pool_k.data_ptr(), pb.pool_v.data_ptr()) != ptrs:
            raise AssertionError("the paged pool moved")
        # ---- end of the paged path ------------------------------------

        with phase("paged_prefix_logits"):
            # the warm continuation prefill (two kernel calls merged) held
            # against the cold prefill of the same prompt: within twice the
            # cold bf16 path's own distance from its fp32 run, + 1e-4
            prompt = prompts[1]
            n = len(prompt)
            pages = [pb.kv.prefix_map[k] for k in prefix_keys(prompt, PAGE_SIZE)[:PREFIX_TOKENS // PAGE_SIZE]]
            rem = prompt[PREFIX_TOKENS:]
            cfg32 = config(cfg, dtype=torch.float32)

            def padded(toks):
                out = torch.zeros((1, pb._bucket(len(toks))), dtype=torch.long, device="cuda")
                out[0, :len(toks)] = torch.tensor(toks, device="cuda")
                return out

            got = {}  # each prefill's last logits, run once under the profiler
            with torch.no_grad():
                prof = {"warm": profiled(lambda: got.setdefault(
                            "warm", pb._prefill(padded(rem), n, pages)[0].float())),
                        "cold": profiled(lambda: got.setdefault(
                            "cold", pb._prefill(padded(prompt), n, [])[0].float()))}
                warm16, cold16 = got["warm"], got["cold"]
                full = padded(prompt)
                pos = torch.arange(full.shape[1], device="cuda")[None, :]
                lg, _ = forward_cached(cfg32, params, full, pos,
                                       init_cache(cfg32, 1, full.shape[1], device="cuda"),
                                       None, prefill=True)
                cold32 = lg[0, n - 1].float()
            gap = max_abs(cold16, cold32)
            err = max_abs(warm16, cold16)
            row = {"prompt_tokens": n, "prefix_tokens": PREFIX_TOKENS,
                   "warm_vs_cold_bf16": err, "cold_bf16_vs_fp32": gap,
                   "warm_bf16_vs_cold_fp32": max_abs(warm16, cold32),
                   "bound": 2 * gap + 1e-4,
                   "argmax": [int(x.argmax()) for x in (warm16, cold16, cold32)]}
            for name, p in prof.items():  # one prefill each: device time, host wall
                row[f"{name}_prefill"] = {k: p[k] for k in ("wall_ms", "device_busy_ms",
                                                              "device_idle_share",
                                                              "device_ms_by_kind")}
            emit(row)
            if not err <= 2 * gap + 1e-4:
                raise AssertionError(f"warm prefill logits off the cold prefill: {row}")

        with phase("paged_decode_times"):
            # one decode step at batch 8, every slot active, at the lengths
            # the 8 prompts reach after MAX_TOKENS: the paged step (gather,
            # attend, scatter a layer) against the slot-dense step
            lengths = [len(i) + MAX_TOKENS for i in ids8]
            table = np.zeros((pb.slots, pb.pages_per_seq), np.int64)
            held = []
            for slot, n in enumerate(lengths):
                table[slot, :n // PAGE_SIZE + 1] = [pb.kv.alloc() for _ in range(n // PAGE_SIZE + 1)]
                held += table[slot, :n // PAGE_SIZE + 1].tolist()
            dev = torch.device("cuda")
            args = (torch.zeros(8, dtype=torch.long, device=dev),
                    torch.from_numpy(table).to(dev), torch.tensor(lengths, device=dev),
                    torch.zeros(8, device=dev), torch.zeros(8, dtype=torch.long, device=dev),
                    torch.ones(8, dtype=torch.bool, device=dev))
            dense.cache.lengths.copy_(torch.tensor(lengths, device=dev))
            dargs = args[:1] + args[3:]
            with torch.no_grad():
                paged_step = lambda: pb._decode(*args)  # noqa: E731
                dense_step = lambda: (dense._decode(*dargs), dense.cache.lengths.sub_(1))  # noqa: E731
                ms = {"dense": timed_steps(dense_step, 16), "paged": timed_steps(paged_step, 16)}
                ms["dense_again"] = timed_steps(dense_step, 16)
                ms["paged_again"] = timed_steps(paged_step, 16)
                # one step a profile (a profile of 3,000 device activities
                # takes seconds to read); the paged step three times
                prof = {"paged": profiled(paged_step, counts=True),
                        "dense": profiled(dense_step),
                        "paged_again": profiled(paged_step, counts=True),
                        "paged_third": profiled(paged_step, counts=True)}
                calls = [torch_calls(paged_step), torch_calls(paged_step)]
            for page in held:
                pb.kv.decref(page)
            # every paged step runs the same device activities, by name and
            # count; CUPTI's record of one step is not exact (it dropped one
            # layer's 98 activities from one of 24 profiles of this step, and
            # held 2 more in another), so two of the three profiles must agree
            # and the odd one's difference is printed. The ATen ops the step
            # dispatches are held equal too (host side, exact).
            tallies = [prof[k].pop("activity_counts")
                       for k in ("paged", "paged_again", "paged_third")]
            agree = [i for i, t in enumerate(tallies)
                     if any(t == u for j, u in enumerate(tallies) if j != i)]
            ref = tallies[agree[0] if agree else 0]
            odd = {i: {k[:100]: t.get(k, 0) - ref.get(k, 0) for k in set(t) | set(ref)
                       if t.get(k, 0) != ref.get(k, 0)}
                   for i, t in enumerate(tallies) if i not in agree}  # name: count - ref's
            row = {"decode_ms_per_token": ms, "batch": 8, "lengths": lengths,
                   "clock": "host, synchronized, 16 steps",
                   "paged_step_activities": [sum(t.values()) for t in tallies],
                   "paged_profiles_agreeing": agree, "paged_profiles_odd": odd,
                   "paged_step_torch_calls": [len(c) for c in calls]}
            for name, p in prof.items():
                row[f"{name}_device_idle_share"] = p["device_idle_share"]
                row[f"{name}_device_busy_ms"] = p["device_busy_ms"]
                row[f"{name}_device_ms_by_kind"] = p["device_ms_by_kind"]
            emit(row)
            if len(agree) < 2:
                raise AssertionError(f"no two profiles of the paged decode step ran the "
                                     f"same device activities: {row}")
            if not calls[0] or calls[0] != calls[1]:
                raise AssertionError(f"two paged decode steps made different torch calls: {row}")
    finally:
        for b in (pb, over):
            if b is not None:
                b.shutdown()
    return launches


NP_REDUCE = {"sum": lambda a: a.sum(0), "product": lambda a: a.prod(0),
             "max": lambda a: a.max(0), "min": lambda a: a.min(0),
             "mean": lambda a: a.mean(0)}


def collective_nccl(smi) -> None:
    """The collective API over NCCL on the card, a world of one: every op
    on CUDA tensors (a list of 2 parts, as one member holding two
    devices would pass them) against numpy, async_allreduce among them,
    and the time of a 256 MB bf16 allreduce (at one rank the group's
    reduction over its one part, a copy, and NCCL's in-place call: no
    link traffic). send/recv needs a second rank: held under 4 gloo ranks
    on the CPU (tests/test_torch_collective.py)."""
    from ray_tpu_torch.util import collective as col

    with phase("collective_nccl"):
        col.init_collective_group(1, 0, "nccl", "smoke")
        try:
            rng = np.random.RandomState(SEED)
            xs = [(rng.random_sample((16, 3)) + 0.5).astype(np.float32) for _ in range(2)]
            parts = [torch.from_numpy(x).cuda() for x in xs]
            errs = {}
            for op, f in NP_REDUCE.items():
                red = f(np.stack(xs))
                got = col.allreduce(parts, "smoke", op)
                errs[f"allreduce_{op}"] = float(np.abs(got.cpu().numpy() - red).max())
                got = col.reducescatter(parts, "smoke", op)
                errs[f"reducescatter_{op}"] = float(np.abs(got.cpu().numpy() - red.reshape(2, 8, 3)).max())
                if got.device.type != "cuda":
                    raise AssertionError(f"{op}: result on {got.device}")
            errs["allgather"] = float(np.abs(col.allgather(parts, "smoke").cpu().numpy() - np.stack(xs)).max())
            errs["broadcast"] = float(np.abs(col.broadcast(parts[0], 0, "smoke").cpu().numpy() - xs[0]).max())
            col.barrier("smoke")

            x = torch.randn(COLLECTIVE_BYTES // 2, device="cuda").to(torch.bfloat16)
            out = col.allreduce(x, "smoke")
            errs["allreduce_256MB"] = max_abs(out, x)
            ms = cuda_ms(lambda: col.allreduce(x, "smoke"), 10)
            copy_ms = cuda_ms(lambda: x.clone(), 10)

            t = parts[0].clone()
            h = col.async_allreduce(t, "smoke", "max")
            t.zero_()  # the op took a snapshot
            mid = col.allreduce(parts, "smoke")  # queued behind it
            errs["async_allreduce"] = float(np.abs(h.result(60).cpu().numpy() - xs[0]).max())
            errs["sync_after_async"] = float(np.abs(mid.cpu().numpy() - np.stack(xs).sum(0)).max())
            row = {"backend": "nccl", "world_size": 1, "max_abs_err": errs,
                   "allreduce_bytes": COLLECTIVE_BYTES, "allreduce_ms": ms,
                   "clone_ms": copy_ms, "what_is_timed": "world of one: a copy, no link traffic",
                   "card": smi}
            emit(row)
            bad = {k: v for k, v in errs.items() if v > (1e-6 if "sum" in k or "mean" in k
                                                         or "product" in k or k.startswith("sync")
                                                         else 0.0)}
            if bad:
                raise AssertionError(f"collectives over NCCL disagree with numpy: {bad}")
        finally:
            col.destroy_collective_group("smoke")


def median_ms(fn, n: int) -> float:
    """Median ms of ``fn`` over ``n`` calls after one warm-up, each call
    between its own pair of CUDA events (a call that syncs the host, as a
    learner's update does reading its metrics, counts its host time)."""
    fn()
    pairs = [tuple(torch.cuda.Event(enable_timing=True) for _ in range(2)) for _ in range(n)]
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([start.elapsed_time(end) for start, end in pairs]))


def rl_mlp(rng, out: int) -> dict:
    """init_mlp_params' distributions in numpy: normal · √(2/fan_in)
    weights, zero biases, a zero head; obs 4 → RL_HIDDEN → ``out``."""
    sizes = (4,) + RL_HIDDEN
    layers = {}
    for i in range(len(sizes) - 1):
        w = rng.standard_normal((sizes[i], sizes[i + 1])) * (2.0 / sizes[i]) ** 0.5
        layers[f"w{i}"] = w.astype(np.float32)
        layers[f"b{i}"] = np.zeros(sizes[i + 1], np.float32)
    layers["head_w"] = np.zeros((sizes[-1], out), np.float32)
    layers["head_b"] = np.zeros(out, np.float32)
    return layers


def rl_batches(rng):
    """Each learner's batch maker, from ``rng``: IMPALA one fragment of
    T = 128, PPO a batch of 512, DQN and SAC 64 transitions."""
    def fragment():
        t = 128
        return {"obs": rng.standard_normal((t, 4)).astype(np.float32),
                "actions": rng.integers(0, 2, t).astype(np.int32),
                "rewards": np.ones(t, np.float32),
                "terminateds": rng.random(t) < 0.05, "truncs": np.zeros(t, np.bool_),
                "logp": np.log(rng.uniform(0.3, 0.7, t)).astype(np.float32),
                "last_obs": rng.standard_normal(4).astype(np.float32)}

    def ppo_batch():
        n = 512
        return {"obs": rng.standard_normal((n, 4)).astype(np.float32),
                "actions": rng.integers(0, 2, n).astype(np.int32),
                "logp": np.log(rng.uniform(0.3, 0.7, n)).astype(np.float32),
                "adv": rng.standard_normal(n).astype(np.float32),
                "returns": rng.standard_normal(n).astype(np.float32)}

    def transitions():
        n = 64
        return {"obs": rng.standard_normal((n, 4)).astype(np.float32),
                "next_obs": rng.standard_normal((n, 4)).astype(np.float32),
                "actions": rng.integers(0, 2, n).astype(np.int32),
                "rewards": np.ones(n, np.float32), "terminateds": rng.random(n) < 0.05}

    return {"impala": fragment, "ppo": ppo_batch, "dqn": transitions, "sac": transitions}


def max_tree_diff(a, b) -> float:
    return max(float(np.abs(x - dict(tree_items(b))[p]).max()) for p, x in tree_items(a))


def metric_excess(got: dict, ref: dict, tol: float) -> tuple:
    """(largest |got − ref|, largest |got − ref| − tol·(1 + |ref|)): the
    tests' rule (absolute and relative tol), > 0 where a metric misses."""
    d = {k: abs(got[k] - ref[k]) for k in ref}
    return max(d.values()), max(d[k] - tol * (1 + abs(ref[k])) for k in ref)


def rl_learners(smi) -> dict:
    """The five learners of ray_tpu_torch.rllib (IMPALA, PPO, DQN, SAC, BC)
    at their configs' defaults with hidden (64, 64): each from the same
    numpy init, RL_UPDATES updates on the card and the same on the CPU
    (TF32 is off), the largest param and metric difference gated at
    RL_TOL (metrics as the tests hold them: absolute and relative); then
    the card's update ms, the median of RL_TIMED. BC reads 10 episodes of
    a scripted expert logged by collect_offline_data. Returns the flash
    kernels' launches (none: the learners are MLPs)."""
    from ray_tpu_torch import rllib as R
    from ray_tpu_torch.ops import attention as A
    from ray_tpu_torch.rllib import dqn, impala, ppo, sac

    reset_launches(A)
    with phase("rl_learners"):
        rng = np.random.default_rng(SEED)
        batches = rl_batches(rng)
        data = tempfile.mkdtemp(prefix="bc_")
        try:
            R.collect_offline_data("CartPole-v1", lambda o: int(o[2] + 0.5 * o[3] > 0),
                                   data, num_episodes=10, seed=SEED)
            policy = {"pi": rl_mlp(rng, 2), "vf": rl_mlp(rng, 1)}
            cases = {  # name: (learner on a device, numpy init, batch maker, one update)
                "impala": (lambda d: impala.IMPALALearner(impala.IMPALAConfig(hidden=RL_HIDDEN),
                                                          4, 2, device=d),
                           policy, batches["impala"], lambda l, b: l.update(b)),
                "ppo": (lambda d: ppo.PPOLearner(ppo.PPOConfig(hidden=RL_HIDDEN), 4, 2, device=d),
                        policy, batches["ppo"], lambda l, b: l.update(b)),
                "dqn": (lambda d: dqn.DQNLearner(dqn.DQNConfig(hidden=RL_HIDDEN), 4, 2, device=d),
                        {"q": rl_mlp(rng, 2)}, batches["dqn"], lambda l, b: l.update(b)),
                "sac": (lambda d: sac.SACLearner(sac.SACConfig(hidden=RL_HIDDEN), 4, 2, device=d),
                        {"pi": rl_mlp(rng, 2), "q1": rl_mlp(rng, 2), "q2": rl_mlp(rng, 2),
                         "log_alpha": np.float32(np.log(0.2))},
                        batches["sac"], lambda l, b: l.update(b)),
                "bc": (lambda d: R.BCConfig(hidden=RL_HIDDEN).offline_data(data).build(device=d),
                       policy, lambda: None, lambda l, b: l.train()),
            }
            bad = {}
            for name, (make, init, batch, update) in cases.items():
                pair = {d: make(d) for d in ("cuda", "cpu")}
                for learner in pair.values():
                    learner.set_weights(init)
                m_diff, m_excess = 0.0, float("-inf")
                for _ in range(RL_UPDATES):
                    b = batch()
                    got, ref = (update(pair[d], b) for d in ("cuda", "cpu"))
                    d_, e_ = metric_excess(got, ref, RL_TOL)
                    m_diff, m_excess = max(m_diff, d_), max(m_excess, e_)
                p_diff = max_tree_diff(pair["cuda"].get_weights_np(), pair["cpu"].get_weights_np())
                b = batch()
                ms = median_ms(lambda: update(pair["cuda"], b), RL_TIMED)
                row = {"learner": name, "updates_vs_cpu": RL_UPDATES, "max_param_diff": p_diff,
                       "max_metric_diff": m_diff, "metric_excess": m_excess, "tol": RL_TOL,
                       "update_ms": ms, "timed": RL_TIMED, "last_metrics": got, "card": smi}
                if name == "ppo":
                    row["adam_steps_an_update"] = 4 * 512 // 128
                emit(row)
                if not (p_diff <= RL_TOL and m_excess <= 0.0):
                    bad[name] = (p_diff, m_excess)
            if bad:
                raise AssertionError(f"learners on the card disagree with the CPU: {bad}")
        finally:
            shutil.rmtree(data, ignore_errors=True)
    launches = read_launches(A)
    emit({"rl_learners_launches": launches})
    return launches


def anakin_phases(smi) -> dict:
    """Anakin (ray_tpu_torch.rllib.podracer) on the card, alone (no process
    group). ``learn`` on the card against ``learn`` on the CPU, on one
    trajectory of 4,096 envs with the same params and Adam state (after
    one train(): the heads non-zero), params gated at RL_TOL; then
    train() at ANAKIN_ENVS envs (T = 16, 4 update steps a call, hidden
    (64, 64)): env steps/s and ms an update step (host clock around
    synchronised train() calls, the median of ANAKIN_TIMED after a
    warm-up), the device's idle share, kernels and activities of one
    update step (torch.profiler), peak memory; and episode_return_mean
    over ANAKIN_RETURN_ITERS train() calls at 4,096 envs, reported (not
    gated). Returns the flash kernels' launches (none)."""
    from ray_tpu_torch.ops import attention as A
    from ray_tpu_torch.rllib import AnakinConfig
    from ray_tpu_torch.rllib.adam import tree_map
    from ray_tpu_torch.rllib.convert import params_from_jax, to_numpy

    def config(n, iters=ANAKIN_ITERS):
        return AnakinConfig(num_envs=n, rollout_fragment_length=ANAKIN_T,
                            iterations_per_train=iters, hidden=RL_HIDDEN, seed=SEED)

    reset_launches(A)
    with phase("anakin"):
        algo = config(ANAKIN_ENVS[0], 1).build(device="cuda")
        algo.train()
        _, traj = algo.rollout(algo.params, algo._env, algo._gen)
        params_np = to_numpy(algo.params)
        out = {}
        for d in ("cuda", "cpu"):
            params = params_from_jax(params_np, d)
            state = tree_map(lambda t: t.detach().to(d, copy=True), algo.opt_state)
            m = config(ANAKIN_ENVS[0], 1).build(device=d).learn(
                params, state, {k: v.to(d) for k, v in traj.items()})
            out[d] = (to_numpy(params), {k: float(v) for k, v in m.items()})
        p_diff = max_tree_diff(out["cuda"][0], out["cpu"][0])
        m_diff, m_excess = metric_excess(out["cuda"][1], out["cpu"][1], RL_TOL)
        emit({"anakin_learn_vs_cpu": {"envs": ANAKIN_ENVS[0], "t": ANAKIN_T,
                                      "max_param_diff": p_diff, "max_metric_diff": m_diff,
                                      "metric_excess": m_excess, "tol": RL_TOL,
                                      "metrics": out["cuda"][1]}})
        if not (p_diff <= RL_TOL and m_excess <= 0.0):
            raise AssertionError(f"Anakin's learn on the card disagrees with the CPU: "
                                 f"params {p_diff}, metrics {m_excess}")
        del algo, traj
        for n in ANAKIN_ENVS:
            algo = config(n).build(device="cuda")
            algo.train()  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            walls = []
            for _ in range(ANAKIN_TIMED):
                t0 = time.perf_counter()
                r = algo.train()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            wall = float(np.median(walls))
            prof = profiled(algo._one_step)
            steps = ANAKIN_ITERS * n * ANAKIN_T
            row = {"anakin_train": {"envs": n, "t": ANAKIN_T, "update_steps_a_train": ANAKIN_ITERS,
                                    "env_steps_per_s": steps / wall,
                                    "ms_per_update_step": 1e3 * wall / ANAKIN_ITERS,
                                    "train_s": walls, "peak_bytes": torch.cuda.max_memory_allocated(),
                                    "one_update_step": prof, "total_loss": r["total_loss"],
                                    "card": smi}}
            emit(row)
            if not np.isfinite(r["total_loss"]):
                raise AssertionError(f"Anakin at {n} envs: loss {r['total_loss']}")
            del algo
            gc.collect()
            torch.cuda.empty_cache()
        algo = config(ANAKIN_ENVS[0]).build(device="cuda")
        rets = [algo.train()["episode_return_mean"] for _ in range(ANAKIN_RETURN_ITERS)]
        emit({"anakin_returns": {"envs": ANAKIN_ENVS[0], "iterations": ANAKIN_RETURN_ITERS,
                                 "update_steps": ANAKIN_RETURN_ITERS * ANAKIN_ITERS,
                                 "episode_return_mean": rets}})
        if not all(np.isfinite(rets)):
            raise AssertionError(f"Anakin's returns are not finite: {rets}")
    launches = read_launches(A)
    emit({"anakin_launches": launches})
    return launches


# the port's launch counters, by kernel name
COUNTERS = {"flash_fwd": "flash_fwd_launches",
            "flash_bwd_dq": "flash_bwd_dq_launches",
            "flash_bwd_dkv": "flash_bwd_dkv_launches"}


def reset_launches(A) -> None:
    for attr in COUNTERS.values():
        setattr(A, attr, 0)


def read_launches(A) -> dict:
    return {name: getattr(A, attr) for name, attr in COUNTERS.items()}


def tree_items(tree, prefix=""):
    """(path, tensor) of each leaf of a params-shaped dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from tree_items(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def clone_tree(tree):
    return ({k: clone_tree(v) for k, v in tree.items()} if isinstance(tree, dict)
            else tree.clone())


def sdpa_bwd_ms(q, k, v, do, causal, iters):
    """ms of the backward of scaled_dot_product_attention on the same
    inputs through torch.autograd.grad: one call yields dQ, dK and dV."""
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True)
    g = do.transpose(1, 2)
    return cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), g,
                                               retain_graph=True), iters)


def flash_bwd_vs_plain(kernels, smi) -> None:
    """Each backward kernel against _flash_bwd_reference at the shapes the
    training path (and llama3_8b) gives it, at two ragged shapes in fp32
    and bf16, at a ragged D=128 GQA one and at one where trailing keys see
    no query; every grad finite, and under the causal mask the dK/dV of
    keys >= Sq exactly zero; times at the training shape."""
    from ray_tpu_torch.ops import attention as A

    with phase("flash_bwd_vs_plain"):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
        for sname, b, sq, sk, h, hkv, d, causal, dtype in BWD_SHAPES:
            q = torch.randn((b, sq, h, d), generator=gen, device="cuda").to(dtype)
            k = torch.randn((b, sk, hkv, d), generator=gen, device="cuda").to(dtype)
            v = torch.randn((b, sk, hkv, d), generator=gen, device="cuda").to(dtype)
            do = torch.randn((b, sq, h, d), generator=gen, device="cuda").to(dtype)
            o, lse = A.flash_attention_fwd(q, k, v, causal)
            grads = A.flash_attention_bwd(q, k, v, o, lse, do, causal)
            plain = A._flash_bwd_reference(q, k, v, o, lse, do, causal)
            torch.cuda.synchronize()
            row = {"shape": sname, "b": b, "sq": sq, "sk": sk, "h": h, "hkv": hkv,
                   "d": d, "causal": causal, "dtype": str(dtype)}
            if dtype == torch.float32:
                tols = [FP32_BWD_TOL] * 3
            else:
                # Kernel and plain version both compute in fp32 and round
                # to bf16 (the plain version P and dS before the products
                # they feed, and each output), so each lies within the
                # rounding of the fp32 result: at most `gap`, the plain
                # version's bf16-vs-fp32 gap on these inputs. They are
                # within 2 * gap of each other, plus fp32's
                # summation-order tolerance.
                plain32 = A._flash_bwd_reference(q.float(), k.float(), v.float(),
                                                 o.float(), lse, do.float(), causal)
                gaps = [max_abs(x, y) for x, y in zip(plain, plain32)]
                row["bf16_vs_fp32_gap"] = gaps
                # not gated: the tensor-core kernels against the fp32 computation
                row["dq_vs_fp32"] = max_abs(grads[0], plain32[0])
                row["dkv_vs_fp32"] = [max_abs(x, y) for x, y in zip(grads[1:], plain32[1:])]
                tols = [2 * gap + FP32_BWD_TOL for gap in gaps]
                # the per-element rule (see ULP_RULE_BWD), reported at every
                # bf16 shape and gating those it lists
                row["ulp_rule_excess"] = [ulp_rule_excess(x, y, 2 * gap, FP32_BWD_TOL)
                                          for x, y, gap in zip(grads, plain, gaps)]
                del plain32
            errs = [max_abs(x, y) for x, y in zip(grads, plain)]
            row.update(max_abs_err=dict(zip(("dq", "dk", "dv"), errs)), tol=tols)
            within = all(e <= t for e, t in zip(errs, tols))
            if sname in ULP_RULE_BWD:
                within = all(x <= 0 for x in row["ulp_rule_excess"])
            row["within_tol"] = within
            finite = all(bool(torch.isfinite(g).all()) for g in grads)
            # top-left causal mask: key j is seen by queries i >= j only
            unseen_zero = not (causal and sk > sq) or all(
                not bool(g[:, sq:].any()) for g in grads[1:])
            row.update(finite=finite, unseen_keys_zero=unseen_zero)
            if sname in TIMED_BWD:
                scale, iters = d ** -0.5, 5
                delta = A._flash_bwd_delta(o, do)
                row["dq_ms"] = cuda_ms(lambda: A._flash_bwd_dq_cuda(
                    q, k, v, do, lse, delta, causal, scale), 4 * iters)
                row["dkv_ms"] = cuda_ms(lambda: A._flash_bwd_dkv_cuda(
                    q, k, v, do, lse, delta, causal, scale), iters)
                row["plain_ms"] = cuda_ms(lambda: A._flash_bwd_reference(
                    q, k, v, o, lse, do, causal), 2)
                row["library_ms"] = sdpa_bwd_ms(q, k, v, do, causal, iters)
                row["card"] = smi
                label = shape_label(b, sq, h, hkv, d, causal, dtype)
                for name, line, src, ms, err in (
                        ("flash_bwd_dq", 164, "flash_bwd_dq_sm90.cu", row["dq_ms"], errs[0]),
                        ("flash_bwd_dkv", 199, "flash_bwd_dkv_sm90.cu", row["dkv_ms"],
                         max(errs[1:]))):
                    bound, by = bwd_bound_ms(name, b, sq, sk, h, hkv, d, causal, dtype)
                    row[f"{name}_bound_ms"] = bound
                    row[f"{name}_share"] = bound / ms
                    if sname != "train_step":  # a sub-row of the kernel's row
                        kernels[name][f"{sname}_shape"] = {
                            "max_abs_err": err, "ms": ms, "plain_ms": row["plain_ms"],
                            "bound_ms": bound, "bound_by": by, "share": bound / ms,
                            "library_ms": row["library_ms"], "shape": label}
                        continue
                    kernels[name] = {
                        "name": name, "route": "cuda",
                        "source": f"ray_tpu_torch/ops/csrc/{src}",
                        "replaces": f"ray_tpu/ops/attention.py:{line}",
                        "max_abs_err": err, "ms": ms, "plain_ms": row["plain_ms"],
                        "bound_ms": bound, "bound_by": by, "share": bound / ms,
                        "library_ms": row["library_ms"],
                        # one plain call and one SDPA backward each give
                        # all three grads: both rows carry their full time
                        "plain_and_library_cover": "dQ, dK and dV",
                        "shape": label}
                del delta
            emit(row)
            if not (within and finite and unseen_zero):
                raise AssertionError(f"flash backward disagrees with its plain version at {row}")
            del q, k, v, do, o, lse, grads, plain
            torch.cuda.empty_cache()


def ring_on_one_card(q, k, v, do, causal, n, timed=False):
    """Every rank's computation of a ring of ``n`` over the sequence of q,
    k, v [B, S, H, D] on this card, through the port's per-rank loops:
    rank ``my`` is handed the K/V blocks it would receive, in ring order
    (from my, my-1, ...), and in the backward each block's dK/dV
    accumulators, as the P2P transport hands them. Returns (O, LSE, dQ,
    dK, dV) over the whole sequence and, with ``timed``, each rank's
    forward and backward device ms (CUDA events)."""
    from ray_tpu_torch.ops.ring_attention import (
        ring_attention_rank_bwd, ring_attention_rank_fwd,
    )

    qs, ks, vs, dos = (t.chunk(n, dim=1) for t in (q, k, v, do))
    order = [[(my - t) % n for t in range(n)] for my in range(n)]
    dk = [torch.zeros_like(x, dtype=torch.float32) for x in ks]
    dv = [torch.zeros_like(x, dtype=torch.float32) for x in vs]
    outs, dqs, ms = [], [], []
    for my in range(n):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(3)] if timed else None
        if timed:
            events[0].record()
        o, lse = ring_attention_rank_fwd(qs[my], [(ks[s_], vs[s_], s_) for s_ in order[my]],
                                         my, causal)
        if timed:
            events[1].record()
        dqs.append(ring_attention_rank_bwd(
            qs[my], o, lse, dos[my], [(ks[s_], vs[s_], s_, dk[s_], dv[s_]) for s_ in order[my]],
            my, causal))
        outs.append((o, lse))
        if timed:
            events[2].record()
            events[2].synchronize()
            ms.append({"fwd_ms": events[0].elapsed_time(events[1]),
                       "bwd_ms": events[1].elapsed_time(events[2])})
    out = (torch.cat([o for o, _ in outs], 1), torch.cat([l_ for _, l_ in outs], 2),
           torch.cat(dqs, 1), torch.cat(dk, 1).to(k.dtype), torch.cat(dv, 1).to(v.dtype))
    return out, ms


def ring_vs_flash(smi) -> dict:
    """Ring attention, every rank of a ring of RING_N on this one card
    (the card holds one NCCL rank, so the ring's P2P transport is held
    on the CPU under gloo, tests/test_torch_ring_attention.py): per rank
    the flash forward on each visible block merged by log-sum-exp, and
    the flash backward on each with the global O and LSE. O, LSE, dQ, dK
    and dV are held by RING_RULE against one flash call over the whole
    sequence (gap: that call's distance from the same call in fp32, on
    the CUDA-core kernels), and at S = 4 x 1024 against the plain
    versions. Launches: each kernel n(n+1)/2 times a ring under the causal mask
    (no launch for a wholly masked block), n^2 without it. Returns the
    causal 32k ring's launches, the ring path of the kernels line."""
    from ray_tpu_torch.ops import attention as A

    with phase("ring_vs_flash"):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
        ring_launches = None
        for sname, b, s, h, hkv, d, causal, ref in RING_SHAPES:
            n = RING_N
            q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(torch.bfloat16)
            k = torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
            v = torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
            do = torch.randn((b, s, h, d), generator=gen, device="cuda").to(torch.bfloat16)
            # ---- the ring path: counts from 0, read right after ----------
            reset_launches(A)
            ring, _ = ring_on_one_card(q, k, v, do, causal, n)
            torch.cuda.synchronize()
            launches = read_launches(A)
            # ---- end of the ring path ------------------------------------
            per = n * (n + 1) // 2 if causal else n * n
            want = {name: per for name in COUNTERS}
            fwd, bwd = ((A.flash_attention_fwd, A.flash_attention_bwd) if ref == "flash"
                        else (A._flash_fwd_reference, A._flash_bwd_reference))
            o1, lse1 = fwd(q, k, v, causal)
            single = (o1, lse1, *bwd(q, k, v, o1, lse1, do, causal))
            # the same call in fp32 (the CUDA-core kernels for "flash")
            q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
            o32, lse32 = fwd(q32, k32, v32, causal)
            wide = (o32, lse32, *bwd(q32, k32, v32, o32, lse32, do32, causal))
            del q32, k32, v32, do32
            torch.cuda.synchronize()
            names = ("o", "lse", "dq", "dk", "dv")
            gaps = {x: max_abs(a, w) for x, a, w in zip(names, single, wide)}
            errs = {x: max_abs(r, a) for x, r, a in zip(names, ring, single)}
            tol = {x: 2 * gaps[x] + FP32_BWD_TOL for x in names}
            finite = all(bool(torch.isfinite(t).all()) for t in ring)
            # RING_RULE: the ring's distance from the fp32 result within the
            # single call's 2 * gap + 1e-4, and the ring against the single
            # bf16 call by the per-element rule of ULP_RULE_BWD
            vs_fp32 = {x: max_abs(r, w) for x, r, w in zip(names, ring, wide)}
            ulp_excess = {x: ulp_rule_excess(r, a, 2 * gaps[x], FP32_BWD_TOL)
                          for x, r, a in zip(names, ring, single) if x != "lse"}
            row = {"ring": sname, "n": n, "b": b, "s": s, "s_local": s // n, "h": h,
                   "hkv": hkv, "d": d, "causal": causal, "dtype": "bf16",
                   "against": "one flash call over the whole sequence" if ref == "flash"
                   else "_flash_fwd_reference / _flash_bwd_reference over the whole sequence",
                   "max_abs_err": errs, "gap_bf16_vs_fp32": gaps, "tol": tol,
                   "ring_vs_fp32": vs_fp32, "ulp_rule_excess": ulp_excess,
                   "launches": launches, "want_launches": want, "finite": finite,
                   "sends": "held on the CPU under gloo (tests/test_torch_ring_attention.py)"}
            del wide
            if ref == "flash":
                # timed: each rank's device ms (after the gated run), the
                # single call's fwd + bwd, and the bound of that call's work
                _, ranks_ms = ring_on_one_card(q, k, v, do, causal, n, timed=True)
                fwd_ms = cuda_ms(lambda: A.flash_attention_fwd(q, k, v, causal), 3)
                bwd_ms = cuda_ms(lambda: A.flash_attention_bwd(q, k, v, o1, lse1, do, causal), 3)
                bound = (attention_bound_ms(b, s, s, h, hkv, d, causal, torch.bfloat16)[0]
                         + sum(bwd_bound_ms(kn, b, s, s, h, hkv, d, causal, torch.bfloat16)[0]
                               for kn in ("flash_bwd_dq", "flash_bwd_dkv")))
                total = sum(r_["fwd_ms"] + r_["bwd_ms"] for r_ in ranks_ms)
                row.update(rank_ms=ranks_ms, ring_total_ms=total,
                           ring_slowest_rank_ms=max(r_["fwd_ms"] + r_["bwd_ms"]
                                                    for r_ in ranks_ms),
                           single_fwd_ms=fwd_ms, single_bwd_ms=bwd_ms,
                           single_ms=fwd_ms + bwd_ms, bound_ms=bound,
                           kept_pairs=kept_pairs(s, s, causal), card=smi)
            within_2gap = all(errs[x] <= tol[x] for x in names)
            within = (all(vs_fp32[x] <= tol[x] for x in names) and errs["lse"] <= tol["lse"]
                      and all(e <= 0 for e in ulp_excess.values()))
            row.update(within_2gap=within_2gap, within_ring_rule=within)
            emit(row)
            if not (within and finite and launches == want):
                raise AssertionError(f"ring attention disagrees at {row}")
            if sname == RING_SHAPES[0][0]:
                ring_launches = launches
            del q, k, v, do, ring, single, o1, lse1
            gc.collect()
            torch.cuda.empty_cache()
    return ring_launches


def train_full_width_check() -> None:
    """Two layers of llama2_7b_lora at full width, fp32 params and
    compute, B=1 x 2048: the train step with the kernels against the same
    step with attention through the plain versions."""
    from ray_tpu_torch import train as S
    from ray_tpu_torch.models import transformer as T
    from ray_tpu_torch.ops import attention as A

    class PlainFlash(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v):
            o, lse = A._flash_fwd_reference(q, k, v, True)
            ctx.save_for_backward(q, k, v, o, lse)
            return o

        @staticmethod
        def backward(ctx, g):
            return A._flash_bwd_reference(*ctx.saved_tensors, g, True)

    with phase("train_full_width_check"):
        cfg = T.config("llama2_7b_lora", layers=2, dtype=torch.float32,
                       param_dtype=torch.float32)
        opt = S.default_optimizer(cfg)
        state = S.init_state(cfg, opt, seed=SEED, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
        for name in ("wq_b", "wv_b", "wi_b"):  # nonzero B: every adapter takes a grad
            t = state["params"]["lora"][name]
            t.copy_(0.1 * torch.randn(t.shape, generator=gen, device="cuda"))
        tokens = torch.from_numpy(np.random.RandomState(SEED).randint(
            0, cfg.vocab_size, (1, MAX_LEN))).cuda()
        batch = {"tokens": tokens}
        out = {}
        for route, attn in (("kernels", None), ("plain", PlainFlash.apply)):
            reset_launches(A)
            (_, m), grads = S.value_and_grad(cfg, state["params"], batch, attn_fn=attn)
            stepped = clone_tree(state)
            _, sm = S.make_train_step(cfg, opt, device="cuda", attn_fn=attn)(stepped, batch)
            torch.cuda.synchronize()
            out[route] = {"loss": float(m["loss"]), "step_loss": float(sm["loss"]),
                          "grad_norm": float(sm["grad_norm"]), "lora": grads["lora"],
                          "launches": read_launches(A)}
        k_, p_ = out["kernels"], out["plain"]
        lora_err = {n: max_abs(k_["lora"][n], p_["lora"][n]) / float(p_["lora"][n].abs().max())
                    for n in p_["lora"]}
        row = {"layers": cfg.layers, "hidden": cfg.hidden, "seq": MAX_LEN,
               "loss": [k_["loss"], p_["loss"]], "step_loss": [k_["step_loss"], p_["step_loss"]],
               "grad_norm": [k_["grad_norm"], p_["grad_norm"]],
               "lora_grad_rel_err": lora_err,
               "launches": {"kernels": k_["launches"], "plain": p_["launches"]},
               "tol": {"loss_rel": 1e-5, "grad_norm_rel": 1e-4, "lora_grad_rel": 1e-4}}
        emit(row)
        want = {"flash_fwd": 4 * cfg.layers, "flash_bwd_dq": 2 * cfg.layers,
                "flash_bwd_dkv": 2 * cfg.layers}  # two passes, each forward + remat
        ok = (abs(k_["loss"] - p_["loss"]) <= 1e-5 * abs(p_["loss"])
              and k_["loss"] == k_["step_loss"]
              and abs(k_["grad_norm"] - p_["grad_norm"]) <= 1e-4 * p_["grad_norm"]
              and max(lora_err.values()) <= 1e-4
              and k_["launches"] == want and not any(p_["launches"].values()))
        if not ok:
            raise AssertionError(f"kernel and plain train steps disagree: {row}")
        del state, out, k_, p_
        torch.cuda.empty_cache()


def train_steps(smi) -> dict:
    """The training path at full width: llama2_7b_lora, all 32 layers, bf16
    params (bench.py:476-480 sets them for one chip), B=8 x 2048, remat,
    tokens from seed 0 and the same batch each step as bench.py's
    _run_bench. Then data_train_ingest on the same state. Returns one
    step's kernel launches and the run's numbers (for mesh_train_steps;
    with the Data-fed step's launches)."""
    from ray_tpu_torch import train as S
    from ray_tpu_torch.models import transformer as T
    from ray_tpu_torch.ops import attention as A

    with phase("train_steps"):
        cfg = T.config("llama2_7b_lora", param_dtype=torch.bfloat16)
        opt = S.default_optimizer(cfg)
        t0 = time.perf_counter()
        state = S.init_state(cfg, opt, seed=SEED, device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        tokens = torch.from_numpy(np.random.RandomState(SEED).randint(
            0, cfg.vocab_size, (TRAIN_BATCH, MAX_LEN))).cuda()
        batch = {"tokens": tokens}
        params = state["params"]
        # host copies of the frozen base, to check it bit-unchanged after
        frozen = {p: t.cpu() for p, t in tree_items(params) if not p.startswith("lora/")}
        lora0 = {p: t.clone() for p, t in tree_items(params["lora"])}
        run = S.make_train_step(cfg, opt, device="cuda")
        want = {"flash_fwd": 2 * cfg.layers, "flash_bwd_dq": cfg.layers,
                "flash_bwd_dkv": cfg.layers}  # forward + remat re-run, one backward
        torch.cuda.reset_peak_memory_stats()
        losses, step_ms, metrics = [], [], []
        for i in range(TRAIN_WARMUP + TRAIN_TIMED):
            # ---- the main path: counts from 0, read right after ------
            reset_launches(A)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = run(state, batch)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            launches = read_launches(A)
            # ---- end of the main path --------------------------------
            losses.append(float(m["loss"]))
            metrics.append({k: float(v) for k, v in m.items()})
            emit({"train_step": i, "warmup": i < TRAIN_WARMUP, "ms": step_ms[-1],
                  "loss": losses[-1], "grad_norm": float(m["grad_norm"]),
                  "accuracy": float(m["accuracy"]), "launches": launches})
            if launches != want:
                raise AssertionError(f"step {i} launched {launches}, expected {want}")
        timed = sorted(step_ms[TRAIN_WARMUP:])
        med = timed[len(timed) // 2]
        tok_s = TRAIN_BATCH * MAX_LEN / (med / 1e3)
        peak = 756e12 if "PCIe" in torch.cuda.get_device_name(0) else 989e12
        peak_bytes = torch.cuda.max_memory_allocated()
        summary = {"step_ms_median": med, "tokens_per_s": tok_s,
                   "mfu_6n": 6 * cfg.num_params() * tok_s / peak,
                   "peak_allocated_bytes": peak_bytes, "metrics": metrics}
        emit({"model": "llama2_7b_lora", "layers": cfg.layers, "batch": TRAIN_BATCH,
              "seq": MAX_LEN, "param_dtype": "bfloat16", "remat": cfg.remat,
              "params": cfg.num_params(), "init_s": init_s,
              "step_ms_median": med, "step_ms_timed": step_ms[TRAIN_WARMUP:],
              "tokens_per_s": tok_s,
              "mfu_6n": summary["mfu_6n"], "peak_flops": peak,
              "peak_allocated_bytes": peak_bytes,
              "losses": losses, "clock": "host, synchronized", "card": smi})
        emit({"profile": "train_step", "card": smi, **profiled(lambda: run(state, batch), top=12)})
        torch.cuda.synchronize()
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"losses not finite and falling: {losses}")
        changed = [p for p, t in tree_items(params) if p in frozen
                   and not torch.equal(frozen[p].cuda(), t)]
        unmoved = [p for p, t in tree_items(params["lora"])
                   if not (t != lora0[p]).flatten(1).any(1).all()]
        emit({"frozen_leaves": len(frozen), "frozen_changed": changed,
              "lora_leaves_not_moved_in_every_layer": unmoved})
        if changed or unmoved:
            raise AssertionError(f"frozen leaves changed {changed}; LoRA leaves unmoved {unmoved}")
    summary["data_train_ingest_launches"] = data_train_ingest(smi, cfg, run, state, med)
    del state, params, frozen, lora0
    torch.cuda.empty_cache()
    return launches, summary


DATA_BLOCKS = 3  # data_llm_batch: the 4 serving prompts, then the 8, four rows a block
DATA_PAIRS = (("direct", "data"), ("data", "direct"), ("direct", "data"))  # timed passes
INGEST_STEPS = 3  # data_train_ingest: Data-fed steps on train_steps' state
TUNE_LRS = (3e-4, 1e-3)  # tune_trials' grid: default_optimizer's lr, and a larger one
TUNE_STEPS = 2  # steps of each trial's TorchTrainer loop


class IdsTokenizer:
    """data_llm_batch's tokenizer: ByteTokenizer's encode and ids; decode
    writes the ids out, so the Dataset's output column carries the exact
    tokens (random weights rarely emit byte ids)."""

    vocab_size = 257
    eos_token_id = 256

    def encode(self, text):
        return list(text.encode("utf-8"))

    def decode(self, ids):
        return " ".join(str(int(i)) for i in ids)


def data_llm_batch(smi) -> dict:
    """Batch inference over a Dataset: 12 prompt rows (the serving
    prompts: the 4, then the 8) in 3 blocks of 4, in local mode, through
    build_llm_processor(LLMConfig(llama3_8b, seed 0), batch_size=4) and
    take_all(), with the kernels' counts from 0 around it (the first block
    builds the engine). Gates: every completion's tokens equal the cached
    engine's own generate on the same 3 batches, bit for bit; flash_fwd
    launches = layers x 3 (one prefill a batch); the card's allocated
    memory back to its level before once the engine cache is cleared.
    Then the same plan again, warm, against the 3 direct generate calls,
    three pairs in alternating order: medians of rows/s, completion
    tokens/s and the wall ratio (every pass's tokens gated equal too).
    Returns the launches."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import data as D
    from ray_tpu_torch.llm import LLMConfig, SamplingParams, build_llm_processor
    from ray_tpu_torch.llm import batch as LB
    from ray_tpu_torch.models import transformer as T
    from ray_tpu_torch.ops import attention as A

    cfg = T.config("llama3_8b", param_dtype=torch.bfloat16)
    prompts = (prompt_texts([100, 600, 1100, 1500], SEED)
               + prompt_texts(np.linspace(100, 1500, 8).astype(int).tolist(), SEED + 1))
    per_block = len(prompts) // DATA_BLOCKS
    config = LLMConfig(model=cfg, max_len=MAX_LEN, seed=SEED, tokenizer=IdsTokenizer(),
                       sampling=SamplingParams(max_tokens=MAX_TOKENS))
    with phase("data_llm_batch"):
        gc.collect()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        rt.init(local_mode=True)
        try:
            ds = D.from_items([{"prompt": p, "row": i} for i, p in enumerate(prompts)],
                              override_num_blocks=DATA_BLOCKS)
            process = build_llm_processor(config, batch_size=per_block)
            # ---- the main path: counts from 0, read right after ----------
            reset_launches(A)
            t0 = time.perf_counter()
            rows = process(ds).take_all()
            torch.cuda.synchronize()
            cold_s = time.perf_counter() - t0
            launches = read_launches(A)
            # ---- end of the main path ------------------------------------
            eng = LB._engine_for(config)
            batches = [prompts[i:i + per_block] for i in range(0, len(prompts), per_block)]
            passes = {"direct": lambda: [t for b in batches for t in eng.generate(b)],
                      "data": lambda: [r["generated"] for r in process(ds).take_all()]}
            walls, outs = {"direct": [], "data": []}, {"direct": [], "data": []}
            for order in DATA_PAIRS:  # alternating which side runs first
                for side in order:
                    t0 = time.perf_counter()
                    outs[side].append(passes[side]())
                    torch.cuda.synchronize()
                    walls[side].append(time.perf_counter() - t0)
            direct_s, warm_s = (float(np.median(walls[k])) for k in ("direct", "data"))
            got = [r["generated"] for r in rows]
            tokens = sum(len(t.split()) for t in got)
            row = {"rows": len(rows), "blocks": DATA_BLOCKS, "batch_size": per_block,
                   "cold_s": cold_s, "warm_s": walls["data"], "direct_s": walls["direct"],
                   "data_over_direct": warm_s / direct_s,
                   "pair_ratios": [d / r for d, r in zip(walls["data"], walls["direct"])],
                   "rows_per_s": len(rows) / warm_s,
                   "completion_tokens": tokens, "completion_tokens_per_s": tokens / warm_s,
                   "tokens_equal_direct": all(o == got for o in outs["direct"]),
                   "warm_equal_cold": all(o == got for o in outs["data"]),
                   "rows_in_order": [r["row"] for r in rows] == list(range(len(prompts))),
                   "launches": launches, "clock": "host, synchronized", "card": smi}
            del eng, rows, passes, outs
        finally:
            rt.shutdown()
            LB._ENGINE_CACHE.clear()
        gc.collect()
        torch.cuda.empty_cache()
        row["allocated_before"], row["allocated_after"] = before, torch.cuda.memory_allocated()
        emit(row)
        want = {"flash_fwd": cfg.layers * DATA_BLOCKS, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
        if not (row["tokens_equal_direct"] and row["warm_equal_cold"] and row["rows_in_order"]
                and launches == want and tokens > 0
                and row["allocated_after"] <= before + RUNTIME_LEFT_BYTES):
            raise AssertionError(f"data_llm_batch: {row}")
    return launches


def data_train_ingest(smi, cfg, run, state, step_ms_median) -> dict:
    """The train step fed by Data: 24 rows of tokens from seed 0 through
    from_numpy(...).random_shuffle(seed=0).iter_torch_batches(batch_size=8)
    into train_steps' step function and state (after its timed steps, so
    no second init), 3 steps, each with the counts from 0 around the
    ingest and the step. Gates: each batch on the card, int32 (JAX's
    dtype for int64 rows), bit-equal to the same plan's iter_batches rows;
    launches as train_steps' (64/32/32); finite losses. Prints step ms
    against train_steps' median, ingest ms a batch, and the idle share of
    one profiled Data-fed step. Returns a step's launches."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import data as D
    from ray_tpu_torch.ops import attention as A

    want = {"flash_fwd": 2 * cfg.layers, "flash_bwd_dq": cfg.layers,
            "flash_bwd_dkv": cfg.layers}
    with phase("data_train_ingest"):
        rt.init(local_mode=True)
        try:
            rows = np.random.RandomState(SEED).randint(
                0, cfg.vocab_size, (INGEST_STEPS * TRAIN_BATCH, MAX_LEN))
            ds = D.from_numpy(rows, column="tokens").random_shuffle(seed=SEED)
            expect = [torch.from_numpy(b["tokens"].astype(np.int32)) for b in
                      ds.iter_batches(batch_size=TRAIN_BATCH, drop_last=True)]
            steps, bad = [], []
            it = ds.iter_torch_batches(batch_size=TRAIN_BATCH)
            for i in range(INGEST_STEPS):
                # ---- the main path: counts from 0, read right after ------
                reset_launches(A)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                batch = next(it)
                torch.cuda.synchronize()
                ingest_ms = 1e3 * (time.perf_counter() - t0)
                t0 = time.perf_counter()
                state, m = run(state, batch)
                torch.cuda.synchronize()
                step_ms = 1e3 * (time.perf_counter() - t0)
                launches = read_launches(A)
                # ---- end of the main path --------------------------------
                tok = batch["tokens"]
                equal = (tok.device.type == "cuda" and tok.dtype == torch.int32
                         and torch.equal(tok.cpu(), expect[i]))
                steps.append({"step": i, "ingest_ms": ingest_ms, "step_ms": step_ms,
                              "loss": float(m["loss"]), "launches": launches,
                              "batch_equal_iter_batches": equal})
                emit({"data_train_ingest": steps[-1]})
                if not (equal and launches == want and np.isfinite(steps[-1]["loss"])):
                    bad.append(i)
            fed = ds.iter_torch_batches(batch_size=TRAIN_BATCH)
            prof = profiled(lambda: run(state, next(fed)), top=12)
        finally:
            rt.shutdown()
        med = sorted(s["step_ms"] for s in steps)[len(steps) // 2]
        emit({"data_train_ingest_summary": {
            "rows": len(rows), "steps": INGEST_STEPS, "step_ms_median": med,
            "train_steps_ms_median": step_ms_median, "over_train_steps": med / step_ms_median,
            "ingest_ms": [s["ingest_ms"] for s in steps],
            "losses": [s["loss"] for s in steps], "clock": "host, synchronized",
            "card": smi}})
        emit({"profile": "data_fed_train_step", "card": smi, **prof})
        if bad:
            raise AssertionError(f"data_train_ingest: steps {bad} failed: {steps}")
    return launches


def tune_trials(smi, unsharded) -> dict:
    """Train-in-Tune at full width: Tuner over grid_search of two LoRA
    learning rates (default_optimizer's 3e-4 and 1e-3), in local mode,
    one trial at a time, each asking for one card
    (resources_per_trial={"GPU": 1}). A trial runs TorchTrainer.fit()
    (one worker, in process) whose loop takes 2 llama2_7b_lora steps (bf16,
    B=8 x 2048, remat) on train_steps' seed and batch, reports each step
    and saves no checkpoint; the trial then reports the steps to Tune.
    The kernels run on the trial's thread. Gates: each trial's step-0 loss
    and the 3e-4 trial's step-1 loss bit-identical to train_steps'; the
    trials' step-1 losses differ; get_best_result() is the argmin of the
    last loss; launches a step as train_steps' (64/32/32); the card's
    allocated memory back to its level before at each trial's start and
    after the fit. Prints each trial's wall time. Returns the path's
    launches (both trials)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import train as S
    from ray_tpu_torch import tune
    from ray_tpu_torch.models import transformer as T
    from ray_tpu_torch.ops import attention as A

    cfg = T.config("llama2_7b_lora", param_dtype=torch.bfloat16)
    want = {"flash_fwd": 2 * cfg.layers, "flash_bwd_dq": cfg.layers,
            "flash_bwd_dkv": cfg.layers}
    root = tempfile.mkdtemp(prefix="tune_trials_")
    rec = {}

    def trial(config):
        gc.collect()
        t_trial = time.perf_counter()
        start_mem = torch.cuda.memory_allocated()
        steps = []

        def loop(cfg_):
            opt = S.default_optimizer(cfg, lr=cfg_["lr"])
            state = S.init_state(cfg, opt, seed=SEED, device="cuda")
            tokens = torch.from_numpy(np.random.RandomState(SEED).randint(
                0, cfg.vocab_size, (TRAIN_BATCH, MAX_LEN))).cuda()
            run = S.make_train_step(cfg, opt, device="cuda")
            for i in range(TUNE_STEPS):
                before = read_launches(A)
                t0 = time.perf_counter()
                state, m = run(state, {"tokens": tokens})
                loss = float(m["loss"])
                after = read_launches(A)
                steps.append({"step": i, "loss": loss, "ms": 1e3 * (time.perf_counter() - t0),
                              "launches": {k: after[k] - before[k] for k in after}})
                S.report({"loss": loss, "step": i})

        res = S.TorchTrainer(loop, train_loop_config={"lr": config["lr"]},
                             run_config=S.RunConfig(name=f"lr_{config['lr']}",
                                                    storage_path=root)).fit()
        if res.error is not None:
            raise res.error
        gc.collect()
        rec[config["lr"]] = {"steps": steps, "start_mem": start_mem,
                             "end_mem": torch.cuda.memory_allocated(),
                             "wall_s": time.perf_counter() - t_trial}
        for s in steps:
            tune.report({"loss": s["loss"], "training_iteration": s["step"] + 1})

    with phase("tune_trials"):
        gc.collect()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        rt.init(local_mode=True)
        try:
            # ---- the main path: counts from 0, read right after ----------
            reset_launches(A)
            t0 = time.perf_counter()
            grid = tune.Tuner(trial, param_space={"lr": tune.grid_search(list(TUNE_LRS))},
                              tune_config=tune.TuneConfig(metric="loss", mode="min",
                                                          max_concurrent_trials=1),
                              resources_per_trial={"GPU": 1}).fit()
            fit_s = time.perf_counter() - t0
            launches = read_launches(A)
            # ---- end of the main path ------------------------------------
        finally:
            rt.shutdown()
            shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
        after = torch.cuda.memory_allocated()
        ref = [m["loss"] for m in unsharded["metrics"][:TUNE_STEPS]]
        losses = {lr: [s["loss"] for s in r["steps"]] for lr, r in rec.items()}
        best = grid.get_best_result()
        argmin = min(losses, key=lambda lr: losses[lr][-1])
        row = {"trials": [{"lr": lr, **r} for lr, r in rec.items()], "fit_s": fit_s,
               "errors": grid.errors, "reference_losses": ref,
               "step0_bit_identical": all(l_[0] == ref[0] for l_ in losses.values()),
               "default_lr_bit_identical": losses.get(TUNE_LRS[0]) == ref,
               "step1_differ": len({l_[-1] for l_ in losses.values()}) == len(TUNE_LRS),
               "best_lr": best.config["lr"], "argmin_lr": argmin, "launches": launches,
               "allocated_before": before, "allocated_after": after,
               "clock": "host, synchronized", "card": smi}
        emit(row)
        steps = [s for r in rec.values() for s in r["steps"]]
        mem_ok = all(r["start_mem"] <= before + RUNTIME_LEFT_BYTES
                     and r["end_mem"] <= before + RUNTIME_LEFT_BYTES for r in rec.values())
        if not (not grid.errors and len(rec) == len(TUNE_LRS)
                and len(steps) == TUNE_STEPS * len(TUNE_LRS)
                and row["step0_bit_identical"] and row["default_lr_bit_identical"]
                and row["step1_differ"] and best.config["lr"] == argmin
                and all(s["launches"] == want for s in steps) and mem_ok
                and after <= before + RUNTIME_LEFT_BYTES):
            raise AssertionError(f"tune_trials: {row}")
    return launches


FIT_STEPS, FIT_SAVE_AT, FIT_FAIL_AFTER = 5, (2, 4), 2  # steps 0-4; save after 2 and 4
SERVE_TOKENS = 16  # serve_from_checkpoint's greedy tokens a prompt


def fingerprints(tree) -> dict:
    """path → the int64 sum of each leaf's bit pattern, computed on the card."""
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return {p: int(t.contiguous().view(ints[t.element_size()]).sum(dtype=torch.int64))
            for p, t in tree_items(tree)}


def dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def state_bytes(cfg) -> int:
    """The bytes of a train state of ``cfg``: params and the trainable
    leaves' two moments in the params' dtype, plus step and count."""
    from ray_tpu_torch.models import transformer as T

    shapes = T.param_shapes(cfg)
    size = torch.tensor([], dtype=cfg.param_dtype).element_size()

    def numel(tree):
        return sum(numel(v) if isinstance(v, dict) else int(np.prod(v[0]))
                   for v in tree.values())

    return size * (numel(shapes) + 2 * numel(T.trainable_leaves(cfg, shapes))) + 8


def fit_storage(cfg):
    """(directory, layers, free bytes): a fresh temporary directory for
    the trainer's storage, and the depth whose checkpoints its disk holds
    twice (keep-1 holds the new one beside the old for a moment) with 10%
    to spare: all of cfg's layers unless the disk is short."""
    root = tempfile.mkdtemp(prefix="trainer_fit_")
    free = shutil.disk_usage(root).free
    full, one_layer = state_bytes(cfg), state_bytes(dataclasses.replace(cfg, layers=1))
    per_layer = (full - one_layer) // (cfg.layers - 1)
    layers = cfg.layers
    while layers > 1 and 2.2 * (one_layer + (layers - 1) * per_layer) > free:
        layers -= 1
    if layers < 2:
        shutil.rmtree(root)
        raise RuntimeError(f"{free} bytes free on {root}: no room for two checkpoints")
    return root, layers, free


def meta_params(cfg):
    """The params tree of ``cfg`` as meta tensors (shapes and dtype, no
    storage): a restore's target."""
    from ray_tpu_torch.models import transformer as T

    def meta(tree):
        return {k: meta(v) if isinstance(v, dict) else
                torch.empty(v[0], dtype=cfg.param_dtype, device="meta") for k, v in tree.items()}

    return meta(T.param_shapes(cfg))


def uninterrupted_losses(cfg, opt, batch) -> list:
    """FIT_STEPS losses of an uninterrupted make_train_step run from
    init_state(seed=SEED): trainer_fit's reference when the disk cut its
    depth below train_steps'."""
    from ray_tpu_torch import train as S

    state = S.init_state(cfg, opt, seed=SEED, device="cuda")
    run = S.make_train_step(cfg, opt, device="cuda")
    out = [float(run(state, batch)[1]["loss"]) for _ in range(FIT_STEPS)]
    del state
    return out


def trainer_phases(smi, unsharded) -> tuple:
    """The trainer path and serving what it trained, at full width.

    ``trainer_fit``: TorchTrainer.fit() of llama2_7b_lora (bf16 params,
    B=8 x 2048, remat, train_steps' seed and batch) with storage in a
    fresh directory, keep-1 and max_failures=1. The loop restores from
    get_checkpoint() when there is one (params into a meta target, the
    rest from DCP's metadata), runs to step 4, and after steps 2 and 4
    saves the state with save_state (``params`` and ``train``, two
    subdirectories of one Checkpoint) and reports it; the first attempt
    raises right after reporting step 2 (a marker file), the second
    resumes from step 2. At step 4 it decodes the serving prompts greedily
    from its in-memory params (Generator) and reports the tokens. Gates:
    launches 64/32/32 every step; the losses of steps 0-4 equal
    ``unsharded``'s (train_steps') bit for bit; per-leaf fingerprints at
    the save equal those after the restore; Result.metrics["step"] 4 and
    one checkpoint left; memory allocated at the second attempt's start
    within 1 GB of the first's.

    ``serve_from_checkpoint``: LLMEngine(LLMConfig(params_path=<the step-4
    checkpoint>/params)) greedy-decodes the same prompts: tokens equal the
    loop's bit for bit, the params' fingerprints equal the step-4 save's,
    every LoRA B non-zero in every layer, 32 flash-forward launches.

    Returns each path's launches. The storage is removed at the end."""
    from ray_tpu_torch import train as S
    from ray_tpu_torch.llm import LLMConfig, LLMEngine
    from ray_tpu_torch.llm.config import ByteTokenizer
    from ray_tpu_torch.models import transformer as T
    from ray_tpu_torch.models.decoding import Generator, SamplingParams
    from ray_tpu_torch.ops import attention as A

    full = T.config("llama2_7b_lora", param_dtype=torch.bfloat16)
    root, layers, free = fit_storage(full)
    cfg = dataclasses.replace(full, layers=layers)
    tok = ByteTokenizer()
    ids4 = [tok.encode(p) for p in prompt_texts([100, 600, 1100, 1500], SEED)]
    greedy = SamplingParams(max_tokens=SERVE_TOKENS)
    want = {"flash_fwd": 2 * cfg.layers, "flash_bwd_dq": cfg.layers,
            "flash_bwd_dkv": cfg.layers}
    try:
        with phase("trainer_fit"):
            emit({"storage": root, "free_bytes": free, "layers": layers,
                  "reduced": layers != full.layers, "state_bytes": state_bytes(cfg)})
            opt = S.default_optimizer(cfg)
            tokens = torch.from_numpy(np.random.RandomState(SEED).randint(
                0, cfg.vocab_size, (TRAIN_BATCH, MAX_LEN))).cuda()
            batch = {"tokens": tokens}
            marker = os.path.join(root, "fail_once")
            rec = {"mem_at_start": [], "attempt_s": [], "saves": [], "restores": [],
                   "saved_fp": {}, "restored_fp": [], "steps": []}

            def loop(config):
                t_attempt = time.perf_counter()
                rec["mem_at_start"].append(torch.cuda.memory_allocated())
                ck = S.get_checkpoint()
                if ck is None:
                    state = S.init_state(cfg, opt, seed=SEED, device="cuda")
                else:
                    t0 = time.perf_counter()
                    state = {"params": S.restore_state(os.path.join(ck.path, "params"),
                                                       meta_params(cfg), device="cuda"),
                             **S.restore_state(os.path.join(ck.path, "train"), device="cuda")}
                    torch.cuda.synchronize()
                    s = time.perf_counter() - t0
                    nbytes = sum(dir_bytes(os.path.join(ck.path, n)) for n in ("params", "train"))
                    fp = fingerprints(state)
                    rec["restores"].append({"s": s, "bytes": nbytes, "gb_per_s": nbytes / s / 1e9,
                                            "step": int(state["step"])})
                    rec["restored_fp"].append(fp == rec["saved_fp"][int(state["step"]) - 1])
                run = S.make_train_step(cfg, opt, device="cuda")
                for i in range(int(state["step"]), config["steps"]):
                    before = read_launches(A)
                    state, m = run(state, batch)
                    metrics = {"step": i, **{k: float(v) for k, v in m.items()}}
                    after = read_launches(A)
                    rec["steps"].append({**metrics, "launches": {
                        k: after[k] - before[k] for k in after}})
                    if i not in FIT_SAVE_AT:
                        S.report(metrics)
                        continue
                    d = os.path.join(S.get_context().get_storage_path(), f"report_step{i}")
                    rec["saved_fp"][i] = fingerprints(state)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    S.save_state(state["params"], os.path.join(d, "params"))
                    S.save_state({"opt_state": state["opt_state"], "step": state["step"]},
                                 os.path.join(d, "train"))
                    s = time.perf_counter() - t0
                    nbytes = dir_bytes(d)
                    rec["saves"].append({"step": i, "s": s, "bytes": nbytes,
                                         "gb_per_s": nbytes / s / 1e9})
                    if i == config["steps"] - 1:  # serve what was trained, in memory
                        with torch.no_grad():
                            metrics["tokens"] = Generator(cfg, state["params"], max_len=MAX_LEN,
                                                          device="cuda").generate(ids4, greedy, 1)
                    S.report(metrics, checkpoint=S.Checkpoint(d))
                    if i == FIT_FAIL_AFTER and not os.path.exists(marker):
                        open(marker, "w").close()
                        rec["attempt_s"].append(time.perf_counter() - t_attempt)
                        raise RuntimeError(f"planned failure after step {i}")
                rec["attempt_s"].append(time.perf_counter() - t_attempt)

            gc.collect()
            torch.cuda.empty_cache()
            # ---- the main path: counts from 0, read right after ----------
            reset_launches(A)
            res = S.TorchTrainer(loop, train_loop_config={"steps": FIT_STEPS}, run_config=S.RunConfig(
                name="llama2_7b_lora", storage_path=os.path.join(root, "storage"),
                failure_config=S.FailureConfig(max_failures=1),
                checkpoint_config=S.CheckpointConfig(num_to_keep=1))).fit()
            fit_launches = read_launches(A)
            # ---- end of the main path ------------------------------------
            ref = ([m["loss"] for m in unsharded["metrics"][:FIT_STEPS]] if layers == full.layers
                   else uninterrupted_losses(cfg, opt, batch))
            losses = [s_["loss"] for s_ in rec["steps"]]
            left = sorted(p for p in os.listdir(res.path) if p.startswith("checkpoint_"))
            row = {"model": "llama2_7b_lora", "layers": cfg.layers, "batch": TRAIN_BATCH,
                   "seq": MAX_LEN, "param_dtype": "bfloat16", "steps": rec["steps"],
                   "losses": losses, "reference_losses": ref,
                   "bit_identical": losses == ref, "saves": rec["saves"],
                   "restores": rec["restores"], "restored_fingerprints_equal": rec["restored_fp"],
                   "mem_at_attempt_start": rec["mem_at_start"], "attempt_s": rec["attempt_s"],
                   "result_metrics_step": res.metrics.get("step"), "error": res.error is not None,
                   "checkpoints_left": left, "launches": fit_launches,
                   "clock": "host, synchronized", "card": smi}
            emit(row)
            ok = (res.error is None and res.metrics.get("step") == FIT_STEPS - 1
                  and len(left) == 1 and losses == ref and len(rec["steps"]) == FIT_STEPS
                  and all(s_["launches"] == want for s_ in rec["steps"])
                  and rec["restored_fp"] == [True] and len(rec["mem_at_start"]) == 2
                  and rec["mem_at_start"][1] <= rec["mem_at_start"][0] + 2 ** 30)
            if not ok:
                raise AssertionError(f"trainer_fit: {row}")
            fit_tokens = res.metrics["tokens"]
            params_path = os.path.join(res.checkpoint.path, "params")
            saved_fp = rec["saved_fp"][FIT_STEPS - 1]

        with phase("serve_from_checkpoint"):
            gc.collect()
            torch.cuda.empty_cache()
            # ---- the main path: counts from 0, read right after ----------
            reset_launches(A)
            t0 = time.perf_counter()
            engine = LLMEngine(LLMConfig(model=cfg, params_path=params_path, max_len=MAX_LEN),
                               device="cuda")
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            toks = engine.generate_tokens(ids4, greedy)
            serve_launches = read_launches(A)
            # ---- end of the main path ------------------------------------
            params = engine.generator.params
            fp_equal = fingerprints({"params": params}) == {
                k: v for k, v in saved_fp.items() if k.startswith("params/")}
            zero_b = [f"{n}[{i}]" for n, t in params["lora"].items() if n.endswith("_b")
                      for i in range(t.shape[0]) if not bool(t[i].any())]
            nbytes = dir_bytes(params_path)
            row = {"params_path_bytes": nbytes, "restore_s": restore_s,
                   "gb_per_s": nbytes / restore_s / 1e9, "tokens_equal": toks == fit_tokens,
                   "fingerprints_equal": fp_equal,
                   "lora_b_zero_layers": zero_b, "launches": serve_launches,
                   "tokens": toks, "card": smi}
            emit(row)
            if not (toks == fit_tokens and fp_equal and not zero_b
                    and serve_launches == {"flash_fwd": cfg.layers, "flash_bwd_dq": 0,
                                           "flash_bwd_dkv": 0}):
                raise AssertionError(f"serve_from_checkpoint: {row}")
            del engine, params
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return fit_launches, serve_launches


def checkpoint_mesh_of_one(smi) -> None:
    """DCP's CUDA-DTensor route over NCCL: a bf16 ``debug`` train state
    (seeded random moments, step and count set) under
    single_device_mesh("cuda"), an NCCL world of one, saved with its
    shardings, then restored with no mesh (whole tensors) and with the
    mesh and shardings (into a meta target): both bit-identical, dtypes
    included. Destroys the process group at its end."""
    import torch.distributed as dist

    from ray_tpu_torch import parallel as P
    from ray_tpu_torch import train as S
    from ray_tpu_torch.models import transformer as T

    with phase("checkpoint_mesh_of_one"):
        cfg = T.config("debug", param_dtype=torch.bfloat16)
        opt = S.default_optimizer(cfg)
        mesh = P.single_device_mesh("cuda")
        root = tempfile.mkdtemp(prefix="ckpt_mesh_")
        try:
            state = S.init_state(cfg, opt, mesh, seed=SEED)
            gen = torch.Generator(device="cuda").manual_seed(SEED)
            for _, t in tree_items(state["opt_state"]):
                if t.ndim:
                    t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))
            state["opt_state"]["count"].fill_(7)
            state["step"].fill_(9)
            sh = S.state_shardings(cfg, opt, mesh)
            d = os.path.join(root, "state")
            S.save_state(state, d, shardings=sh, mesh=mesh)
            whole = S.restore_state(d, device="cuda")
            meta = {"params": meta_params(cfg), "opt_state": opt.init(meta_params(cfg)),
                    "step": torch.empty((), dtype=torch.int32, device="meta")}
            sharded = S.restore_state(d, meta, sh, mesh=mesh)
            want = dict(tree_items(state))

            def same(tree):
                got = dict(tree_items(tree))
                return got.keys() == want.keys() and all(
                    t.dtype == want[p].dtype and t.device.type == "cuda"
                    and torch.equal(t, want[p]) for p, t in got.items())

            row = {"backend": dist.get_backend(), "leaves": len(want),
                   "bytes": dir_bytes(d), "files": sorted(os.listdir(d)),
                   "whole_bit_identical": same(whole),
                   "mesh_bit_identical": same(sharded), "card": smi}
            emit(row)
            if not (row["backend"] == "nccl" and row["whole_bit_identical"]
                    and row["mesh_bit_identical"]):
                raise AssertionError(f"checkpoint_mesh_of_one: {row}")
        finally:
            dist.destroy_process_group()
            shutil.rmtree(root, ignore_errors=True)


def design_collectives(cfg, units, masked):
    """The collectives a train step issues by kind through a mesh with no
    sequence axis, as the design lays them out
    (ray_tpu_torch/parallel/collectives.py; tests/sharded_step_ref.py
    holds the same count under 8 gloo ranks), for L layers each run R
    times forward (2 under remat) and U grad tensors:

    - all_gather: per block run, each leaf cut over fsdp the block reads
      (wq, wk, wv, wo, wi_gate, wi_up, wo_mlp; MoE's router; LoRA's wq_a,
      wv_a and, dense only, wi_a) and MoE's tokens (over the sequence
      group, then the batch group); the embedding table
      twice (lookup, unembedding); the sequence shards' first tokens;
    - reduce_scatter: one per gather of a leaf or of MoE's tokens, in the
      backward;
    - all_reduce: per block run attention's and the MLP's partial sums
      over tensor (MoE: the expert combine), but for the dense MLP's in
      the remat re-run (torch's checkpoint stops once the backward's
      saved tensors are recomputed); per block in the backward the
      attention and MLP inputs' grads (MoE: the expert input's) and
      LoRA's x·A grads; the embedding's vocab partials and the
      unembedding input's grad; the loss's max, partial sums and argmax
      min, its metrics and a loss_mask's sum; U grads; the norm.
    """
    r, n = (2 if cfg.remat else 1), cfg.layers
    moe = bool(cfg.num_experts)
    lora = (2 if moe else 3) if cfg.lora_rank else 0
    leaves = 7 + moe + lora
    return {"all_gather": r * n * (leaves + 2 * moe) + 3,
            "reduce_scatter": n * (leaves + 2 * moe) + 2,
            "all_reduce": (2 * r - (r - 1) * (not moe)) * n + (2 + lora) * n + 2 + 4
            + int(masked) + units + 1, "send": 0}


def mesh_train_steps(smi, unsharded) -> dict:
    """The dense sharded training path on a mesh of one rank: an NCCL
    world of one (ray_tpu_torch.parallel.single_device_mesh on cuda,
    every axis of MeshSpec() 1), llama2_7b_lora at full width with
    train_steps' seed and batch, through init_state(cfg, opt, mesh) and
    make_train_step(cfg, opt, mesh, None, True, PIPE_MICRO): the FSDP
    gathers and their reduce-scatters, the tensor group's sums, the
    vocab-parallel embedding and loss, each at size one; the microbatches
    are ignored at stage 1, as in JAX. 2 warm-up, MESH_TIMED timed and 1
    profiled step. Held against ``unsharded`` (train_steps'
    numbers): step 0's loss and accuracy bit-identical, its grad_norm
    within 1e-5 relative; launches 64/32/32 and the design's collectives
    every step. Returns one step's kernel launches."""
    import torch.distributed as dist

    from ray_tpu_torch import parallel as P
    from ray_tpu_torch import train as S
    from ray_tpu_torch.models import transformer as T
    from ray_tpu_torch.ops import attention as A

    with phase("mesh_train_steps"):
        cfg = T.config("llama2_7b_lora", param_dtype=torch.bfloat16)
        opt = S.default_optimizer(cfg)
        mesh = P.single_device_mesh("cuda")
        state = run = None
        try:
            emit({"mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
                  "backend": dist.get_backend(), "world": dist.get_world_size()})
            if dist.get_backend() != "nccl":
                raise AssertionError(f"a cuda mesh on {dist.get_backend()}")
            state = S.init_state(cfg, opt, mesh, seed=SEED)
            run = S.make_train_step(cfg, opt, mesh, None, True, PIPE_MICRO)
            tokens = torch.from_numpy(np.random.RandomState(SEED).randint(
                0, cfg.vocab_size, (TRAIN_BATCH, MAX_LEN))).cuda()
            batch = {"tokens": tokens}
            want = {"flash_fwd": 2 * cfg.layers, "flash_bwd_dq": cfg.layers,
                    "flash_bwd_dkv": cfg.layers}  # forward + remat re-run, one backward
            want_coll = design_collectives(cfg, len(S.step._units(state["params"])), False)
            gc.collect()
            torch.cuda.reset_peak_memory_stats()
            metrics, step_ms = [], []
            for i in range(TRAIN_WARMUP + MESH_TIMED):
                # ---- the main path: counts from 0, read right after ------
                reset_launches(A)
                P.reset_collectives()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = run(state, batch)
                torch.cuda.synchronize()
                step_ms.append(1e3 * (time.perf_counter() - t0))
                launches, coll = read_launches(A), P.read_collectives()
                # ---- end of the main path --------------------------------
                metrics.append({k: float(v) for k, v in m.items()})
                emit({"mesh_train_step": i, "warmup": i < TRAIN_WARMUP,
                      "ms": step_ms[-1], **metrics[-1], "launches": launches,
                      "collectives": coll})
                if launches != want or coll != want_coll:
                    raise AssertionError(f"mesh step {i} launched {launches} and issued "
                                         f"{coll}, expected {want} and {want_coll}")
            peak_bytes = torch.cuda.max_memory_allocated()
            timed = sorted(step_ms[TRAIN_WARMUP:])
            med = timed[len(timed) // 2]
            tok_s = TRAIN_BATCH * MAX_LEN / (med / 1e3)
            peak = 756e12 if "PCIe" in torch.cuda.get_device_name(0) else 989e12
            ref = unsharded["metrics"]
            cmp = {"step0_loss": [metrics[0]["loss"], ref[0]["loss"]],
                   "step0_accuracy": [metrics[0]["accuracy"], ref[0]["accuracy"]],
                   "step0_grad_norm": [metrics[0]["grad_norm"], ref[0]["grad_norm"]],
                   "bit_identical_steps": sum(a == b for a, b in zip(metrics, ref)),
                   "tol": {"grad_norm_rel": 1e-5}}
            emit({"model": "llama2_7b_lora", "layers": cfg.layers,
                  "mesh": "MeshSpec() on an NCCL world of one",
                  "num_microbatches": PIPE_MICRO, "stage": 1,
                  "batch": TRAIN_BATCH, "seq": MAX_LEN, "param_dtype": "bfloat16",
                  "step_ms_median": med, "step_ms_timed": step_ms[TRAIN_WARMUP:],
                  "tokens_per_s": tok_s, "mfu_6n": 6 * cfg.num_params() * tok_s / peak,
                  "peak_allocated_bytes": peak_bytes,
                  "unsharded": {k: unsharded[k] for k in (
                      "step_ms_median", "tokens_per_s", "mfu_6n", "peak_allocated_bytes")},
                  "against_unsharded": cmp, "clock": "host, synchronized", "card": smi})
            ok = (cmp["step0_loss"][0] == cmp["step0_loss"][1]
                  and cmp["step0_accuracy"][0] == cmp["step0_accuracy"][1]
                  and abs(cmp["step0_grad_norm"][0] - cmp["step0_grad_norm"][1])
                  <= 1e-5 * abs(cmp["step0_grad_norm"][1])
                  and all(np.isfinite([m_["loss"] for m_ in metrics])))
            if not ok:
                raise AssertionError(f"mesh step and unsharded step disagree: {cmp}")
            emit({"profile": "mesh_train_step", "card": smi,
                  **profiled(lambda: run(state, batch), top=16)})
            torch.cuda.synchronize()
        finally:
            del state, run
            dist.destroy_process_group()
            gc.collect()
            torch.cuda.empty_cache()
    return launches


def pipeline_train_steps(smi, unsharded) -> dict:
    """The pipelined training path at full width: llama2_7b_lora (32
    layers, bf16 params, B=8 x 2048, remat, train_steps' seed and batch)
    through make_train_step(cfg, opt, None, None, True, PIPE_MICRO,
    stages=PIPE_STAGES): every stage's forward and backward loops
    (ray_tpu_torch/ops/pipeline.py) run on this card, one stage after
    another, through the in-process transport; the card holds one NCCL
    rank, so the P2P transport is held on the CPU under gloo
    (tests/test_torch_pipeline*.py). 2 warm-up, MESH_TIMED timed and 1
    profiled step. Each step launches each flash kernel PIPE_MICRO times
    the unpipelined step's count, each on one microbatch, and sends
    2 (stages - 1) PIPE_MICRO activations and their grads. Step 0's loss
    and grad norm are held against ``unsharded`` (train_steps' numbers)
    within twice the distance of that step from the same step in fp32
    (the unpipelined step on fp32 params, run here after the pipelined
    one). Returns one step's kernel launches."""
    from ray_tpu_torch import parallel as P
    from ray_tpu_torch import train as S
    from ray_tpu_torch.models import transformer as T
    from ray_tpu_torch.ops import attention as A

    with phase("pipeline_train_steps"):
        cfg = T.config("llama2_7b_lora", param_dtype=torch.bfloat16)
        opt = S.default_optimizer(cfg)
        state = S.init_state(cfg, opt, seed=SEED, device="cuda")
        run = S.make_train_step(cfg, opt, None, None, True, PIPE_MICRO, device="cuda",
                                stages=PIPE_STAGES)
        tokens = torch.from_numpy(np.random.RandomState(SEED).randint(
            0, cfg.vocab_size, (TRAIN_BATCH, MAX_LEN))).cuda()
        batch = {"tokens": tokens}
        # forward + remat re-run, one backward: per layer and microbatch
        want = {"flash_fwd": 2 * cfg.layers * PIPE_MICRO,
                "flash_bwd_dq": cfg.layers * PIPE_MICRO,
                "flash_bwd_dkv": cfg.layers * PIPE_MICRO}
        want_sends = 2 * (PIPE_STAGES - 1) * PIPE_MICRO
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        # the step is host-bound: the host time the garbage collector takes
        # in each step, and the caching allocator's retries (each frees
        # cached blocks and synchronises the card)
        gc_ms = [0.0, 0.0]  # this step's ms, the current collection's start

        def on_gc(when, info):
            if when == "start":
                gc_ms[1] = time.perf_counter()
            else:
                gc_ms[0] += 1e3 * (time.perf_counter() - gc_ms[1])

        metrics, step_ms = [], []
        gc.callbacks.append(on_gc)
        try:
            for i in range(TRAIN_WARMUP + MESH_TIMED):
                retries = torch.cuda.memory_stats()["num_alloc_retries"]
                gc_ms[0] = 0.0
                # ---- the main path: counts from 0, read right after ------
                reset_launches(A)
                P.reset_collectives()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = run(state, batch)
                torch.cuda.synchronize()
                step_ms.append(1e3 * (time.perf_counter() - t0))
                launches, sends = read_launches(A), P.read_collectives()["send"]
                # ---- end of the main path --------------------------------
                metrics.append({k: float(v) for k, v in m.items()})
                emit({"pipeline_train_step": i, "warmup": i < TRAIN_WARMUP, "ms": step_ms[-1],
                      **metrics[-1], "launches": launches, "sends": sends,
                      "gc_ms": gc_ms[0],
                      "alloc_retries": torch.cuda.memory_stats()["num_alloc_retries"] - retries,
                      "reserved_bytes": torch.cuda.memory_reserved()})
                if launches != want or sends != want_sends:
                    raise AssertionError(f"pipelined step {i} launched {launches} and sent "
                                         f"{sends}, expected {want} and {want_sends}")
        finally:
            gc.callbacks.remove(on_gc)
        peak_bytes = torch.cuda.max_memory_allocated()
        timed = sorted(step_ms[TRAIN_WARMUP:])
        med = timed[len(timed) // 2]
        tok_s = TRAIN_BATCH * MAX_LEN / (med / 1e3)
        peak = 756e12 if "PCIe" in torch.cuda.get_device_name(0) else 989e12
        prof = profiled(lambda: run(state, batch), top=16)
        emit({"profile": "pipeline_train_step", "card": smi, **prof})
        torch.cuda.synchronize()
        del state, run
        gc.collect()
        torch.cuda.empty_cache()
        # the unpipelined step's own bf16-vs-fp32 distance, at step 0
        t0 = time.perf_counter()
        cfg32 = T.config("llama2_7b_lora", dtype=torch.float32, param_dtype=torch.float32)
        opt32 = S.default_optimizer(cfg32)
        st32 = S.init_state(cfg32, opt32, seed=SEED, device="cuda")
        _, m32 = S.make_train_step(cfg32, opt32, device="cuda")(st32, batch)
        fp32 = {k: float(v) for k, v in m32.items()}
        fp32_s = time.perf_counter() - t0
        fp32_peak = torch.cuda.max_memory_allocated()
        del st32, m32
        gc.collect()
        torch.cuda.empty_cache()
        ref = unsharded["metrics"][0]
        keys = ("loss", "grad_norm")
        gap = {k: abs(ref[k] - fp32[k]) for k in keys}
        diff = {k: abs(metrics[0][k] - ref[k]) for k in keys}
        tol = {k: 2 * gap[k] for k in keys}
        losses = [m_["loss"] for m_ in metrics]
        emit({"model": "llama2_7b_lora", "layers": cfg.layers, "stages": PIPE_STAGES,
              "layers_a_stage": cfg.layers // PIPE_STAGES, "num_microbatches": PIPE_MICRO,
              "transport": "in-process (every stage on this card)",
              "batch": TRAIN_BATCH, "seq": MAX_LEN, "param_dtype": "bfloat16",
              "step_ms_median": med, "step_ms_timed": step_ms[TRAIN_WARMUP:],
              "tokens_per_s": tok_s, "mfu_6n": 6 * cfg.num_params() * tok_s / peak,
              "peak_allocated_bytes": peak_bytes,
              # the profiled step's; the profiler's host overhead inflates it
              # where the host launches ~8x the kernels, so also the share
              # of the timed median the profiled device work leaves idle
              "device_idle_share": prof["device_idle_share"],
              "device_idle_share_of_median": max(0.0, 1 - prof["device_busy_ms"] / med),
              "launches_per_step": launches, "sends_per_step": sends,
              "unpipelined": {k: unsharded[k] for k in (
                  "step_ms_median", "tokens_per_s", "mfu_6n", "peak_allocated_bytes")},
              "step0": {"pipelined": {k: metrics[0][k] for k in keys},
                        "unpipelined": {k: ref[k] for k in keys},
                        "unpipelined_fp32": {k: fp32[k] for k in keys},
                        "diff": diff, "gap_bf16_vs_fp32": gap, "tol": tol},
              "fp32_step_peak_allocated_bytes": fp32_peak, "fp32_step_s": fp32_s,
              "losses": losses, "clock": "host, synchronized", "card": smi})
        if not (all(diff[k] <= tol[k] for k in keys) and all(np.isfinite(losses))
                and losses[-1] < losses[0]):
            raise AssertionError(f"pipelined step disagrees with the unpipelined one: "
                                 f"diff {diff}, tol {tol}, losses {losses}")
    return launches


def moe_weights(cfg, gen, dtype):
    """One MoE layer's weights on the card, normal / sqrt(fan_in)."""
    h, m, e = cfg.hidden, cfg.mlp_hidden, cfg.num_experts

    def draw(shape, fan_in):
        return (torch.randn(shape, generator=gen, device="cuda") / fan_in ** 0.5).to(dtype)

    return {"router": draw((h, e), h), "wi_gate": draw((e, h, m), h),
            "wi_up": draw((e, h, m), h), "wo_mlp": draw((e, m, h), m)}


def moe_vs_cpu() -> None:
    """One mixture-of-experts layer at Mixtral width (h 4096, m 14336, 8
    experts, top-2) on MOE_TOKENS tokens, on the card and on the CPU from
    the same tensors, in fp32 and bf16, at capacity factor 1.25 and 0.5
    (which forces drops). Routing (gate_idx, slot, keep) must be
    identical on both devices. fp32 outputs agree within MOE_FP32_TOL
    (summation order, TF32 off). In bf16 both devices round at the same
    points, so each output lies within the rounding of the fp32 result:
    at most `gap`, the CPU's bf16-vs-fp32 gap on the same bf16-rounded
    inputs. They are within 2 * gap of each other, plus MOE_FP32_TOL (the
    rule flash_bwd_vs_plain holds the backward kernels to): a split of
    one intermediate rounding (the expert outputs, the gate product, the
    sum over k) can move an output element by more than its own ulp."""
    from ray_tpu_torch.models import transformer as T

    with phase("moe_vs_cpu"):
        base = T.config("mixtral_8x7b")
        gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
        p32 = moe_weights(base, gen, torch.float32)
        y32 = torch.randn((1, MOE_TOKENS, base.hidden), generator=gen, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            p = {k: v.to(dtype) for k, v in p32.items()}
            y = y32.to(dtype)
            p_cpu, y_cpu = {k: v.cpu() for k, v in p.items()}, y.cpu()
            for cf in (1.25, 0.5):
                cfg = T.config(base, dtype=dtype, capacity_factor=cf)
                with torch.no_grad():
                    out = T._moe_mlp(cfg, y, p).cpu()
                    r = T.moe_routing(cfg, y[0], p["router"])
                    t0 = time.perf_counter()
                    ref = T._moe_mlp(cfg, y_cpu, p_cpu)
                    cpu_s = time.perf_counter() - t0
                    r_cpu = T.moe_routing(cfg, y_cpu[0], p_cpu["router"])
                same = {f: bool(torch.equal(getattr(r, f).cpu(), getattr(r_cpu, f)))
                        for f in ("gate_idx", "slot", "keep")}
                err = max_abs(out, ref)
                row = {"dtype": str(dtype), "capacity_factor": cf, "tokens": MOE_TOKENS,
                       "capacity": r.capacity, "routing_identical": same,
                       "dropped_share": float((~r_cpu.keep).float().mean()),
                       "max_abs_err": err, "out_max_abs": float(ref.abs().max()),
                       "cpu_s": cpu_s}
                if dtype == torch.float32:
                    row["tol"] = MOE_FP32_TOL
                    within = err <= MOE_FP32_TOL
                else:
                    cfg32 = T.config(cfg, dtype=torch.float32)
                    with torch.no_grad():
                        ref32 = T._moe_mlp(cfg32, y_cpu.float(),
                                           {k: v.float() for k, v in p_cpu.items()})
                    row["cpu_bf16_vs_fp32"] = max_abs(ref, ref32)
                    # not gated: the card's bf16 layer against the same fp32 result
                    row["card_bf16_vs_fp32"] = max_abs(out, ref32)
                    row["tol"] = 2 * row["cpu_bf16_vs_fp32"] + MOE_FP32_TOL
                    within = err <= row["tol"]
                row["within_tol"] = within
                emit(row)
                if not (all(same.values()) and within
                        and bool(torch.isfinite(out).all())):
                    raise AssertionError(f"MoE layer: card and CPU disagree: {row}")
                if cf < 1 and row["dropped_share"] == 0:
                    raise AssertionError(f"capacity factor {cf} dropped nothing: {row}")
            del p, y, p_cpu, y_cpu
        del p32, y32
        torch.cuda.empty_cache()


def active_params(cfg) -> int:
    """Params a token's forward multiplies by: attention, the router, the
    k of E experts it is routed to, and the unembedding (the embedding
    is a lookup; norms are left out)."""
    h, m, e, k = cfg.hidden, cfg.mlp_hidden, cfg.num_experts, cfg.experts_per_token
    attn = h * cfg.heads * cfg.hd + 2 * h * cfg.kv_heads * cfg.hd + cfg.heads * cfg.hd * h
    return cfg.layers * (attn + h * e + k * 3 * h * m) + h * cfg.vocab_size


@torch.no_grad()
def expert_load(cfg, params, tokens):
    """Routing of ``tokens`` at ``params``, layer by layer, through the
    model's own halves of a block: per layer the tokens routed to each
    expert (all k choices), those kept, and the dropped share. Also
    returns layer 0's MLP input (for moe_layer_times)."""
    from ray_tpu_torch.models import transformer as T

    x = params["embed"].to(cfg.dtype)[tokens]
    pos = torch.arange(tokens.shape[1], device="cuda")
    attn, rows, y0 = T._default_attn(cfg), [], None
    for i in range(cfg.layers):
        lp, lo = T._layer(params, i)
        x = T._attention(cfg, x, lp, lo, pos, attn)
        y = T._rms_norm(x, lp["ln_mlp"], cfg.norm_eps)
        y0 = y if i == 0 else y0
        r = T.moe_routing(cfg, y.reshape(-1, cfg.hidden), lp["router"])
        idx = r.gate_idx.T.reshape(-1)
        rows.append({"layer": i, "capacity": r.capacity,
                     "routed": torch.bincount(idx, minlength=cfg.num_experts).tolist(),
                     "kept": torch.bincount(idx[r.keep], minlength=cfg.num_experts).tolist(),
                     "dropped_share": float((~r.keep).float().mean())})
        x = T._mlp(cfg, x, lp, lo)
    return rows, y0


def moe_layer_times(cfg, params, y) -> dict:
    """ms of one MoE layer's parts at the step's shape, layer 0's weights
    and MLP input, by CUDA events: routing, the expert FFN (the model's
    ``_expert_ffn`` on a full [E, C, h] buffer), the whole ``_moe_mlp``
    forward (its rest is the dispatch and combine gathers), and forward
    plus backward of ``_moe_mlp``, of the expert FFN alone and of a
    block's attention half."""
    from ray_tpu_torch.models import transformer as T

    lp, _ = T._layer(params, 0)
    t = y.shape[0] * y.shape[1]
    x = y.reshape(t, cfg.hidden)
    cap = T.moe_capacity(cfg, t)
    rows = torch.arange(cfg.num_experts * cap, device="cuda") % t  # a full buffer
    xe = x[rows].reshape(cfg.num_experts, cap, cfg.hidden)
    w = {k: lp[k].detach().requires_grad_() for k in ("router", "wi_gate", "wi_up", "wo_mlp")}

    def experts(xe):
        return T._expert_ffn(xe, w)

    def fwd_bwd(fn, *inputs):
        inputs = [v.detach().requires_grad_() for v in inputs]
        with torch.enable_grad():
            out = fn(*inputs)
            torch.autograd.grad(out, inputs + [v for v in w.values()],
                                torch.ones_like(out), allow_unused=True)

    pos = torch.arange(y.shape[1], device="cuda")
    attn = T._default_attn(cfg)
    with torch.no_grad():
        out = {"routing_ms": cuda_ms(lambda: T.moe_routing(cfg, x, lp["router"]), 5),
               "experts_fwd_ms": cuda_ms(lambda: experts(xe), 5),
               "moe_mlp_fwd_ms": cuda_ms(lambda: T._moe_mlp(cfg, y, lp), 5)}
    out["dispatch_combine_fwd_ms"] = (out["moe_mlp_fwd_ms"] - out["routing_ms"]
                                      - out["experts_fwd_ms"])
    out["moe_mlp_fwd_bwd_ms"] = cuda_ms(lambda: fwd_bwd(
        lambda y_: T._moe_mlp(cfg, y_, w), y), 3)
    out["experts_fwd_bwd_ms"] = cuda_ms(lambda: fwd_bwd(experts, xe), 3)
    w.update({k: lp[k].detach().requires_grad_() for k in ("wq", "wk", "wv", "wo", "ln_attn")})
    out["attention_half_fwd_bwd_ms"] = cuda_ms(lambda: fwd_bwd(
        lambda y_: T._attention(cfg, y_, w, None, pos, attn), y), 3)
    out.update(tokens=t, capacity=cap, clock="CUDA events")
    return out


class FirstGrads:
    """The optimizer the MoE step is given: it updates as the wrapped
    AdamW does, and on its first update (step 0) it records the L2 norm
    of each expert's ``wi_gate`` gradient and of each layer's router
    gradient, found among the per-layer leaves by their storage."""

    def __init__(self, opt, params):
        self.opt, self.norms = opt, None
        self.where = {t.data_ptr(): (name, i) for name in ("wi_gate", "router")
                      for i, t in enumerate(params["blocks"][name])}

    def update_(self, params, grads, opt_state, grad_norm):
        if self.norms is None:
            self.norms = {}
            for p, g in zip(params, grads):
                name, i = self.where.get(p.data_ptr(), (None, None))
                if name == "wi_gate":
                    self.norms[(name, i)] = torch.linalg.vector_norm(
                        g, dim=(1, 2), dtype=torch.float32).tolist()
                elif name == "router":
                    self.norms[(name, i)] = float(torch.linalg.vector_norm(
                        g, dtype=torch.float32))
        self.opt.update_(params, grads, opt_state, grad_norm)


def moe_train_steps(smi):
    """The MoE training path: mixtral_8x7b at full width, layers cut to
    MOE_LAYERS, bf16 params, full fine-tune, B=8 x 2048, remat, tokens
    from seed 0 and the same batch each step, through
    ray_tpu_torch.train.make_train_step. Returns one step's kernel
    launches and the run's numbers (for moe_mesh_train_steps)."""
    from ray_tpu_torch import train as S
    from ray_tpu_torch.models import transformer as T
    from ray_tpu_torch.ops import attention as A

    with phase("moe_train_steps"):
        cfg = T.config("mixtral_8x7b", layers=MOE_LAYERS, param_dtype=torch.bfloat16)
        opt = S.default_optimizer(cfg)
        t0 = time.perf_counter()
        state = S.init_state(cfg, opt, seed=SEED, device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        tokens = torch.from_numpy(np.random.RandomState(SEED).randint(
            0, cfg.vocab_size, (TRAIN_BATCH, MAX_LEN))).cuda()
        batch = {"tokens": tokens}
        load, y0 = expert_load(cfg, state["params"], tokens)
        emit({"expert_load_step0": load, "experts": cfg.num_experts,
              "experts_per_token": cfg.experts_per_token,
              "capacity_factor": cfg.capacity_factor, "card": smi})
        recorder = FirstGrads(opt, state["params"])
        run = S.make_train_step(cfg, recorder, device="cuda")
        want = {"flash_fwd": 2 * cfg.layers, "flash_bwd_dq": cfg.layers,
                "flash_bwd_dkv": cfg.layers}  # forward + remat re-run, one backward
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        losses, step_ms, metrics = [], [], []
        for i in range(TRAIN_WARMUP + TRAIN_TIMED):
            # ---- the main path: counts from 0, read right after ------
            reset_launches(A)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = run(state, batch)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            launches = read_launches(A)
            # ---- end of the main path --------------------------------
            losses.append(float(m["loss"]))
            metrics.append({k: float(v) for k, v in m.items()})
            emit({"moe_train_step": i, "warmup": i < TRAIN_WARMUP, "ms": step_ms[-1],
                  "loss": losses[-1], "grad_norm": float(m["grad_norm"]),
                  "accuracy": float(m["accuracy"]), "launches": launches})
            if launches != want:
                raise AssertionError(f"MoE step {i} launched {launches}, expected {want}")
        peak_bytes = torch.cuda.max_memory_allocated()
        timed = sorted(step_ms[TRAIN_WARMUP:])
        med = timed[len(timed) // 2]
        tok_s = TRAIN_BATCH * MAX_LEN / (med / 1e3)
        peak = 756e12 if "PCIe" in torch.cuda.get_device_name(0) else 989e12
        n_active, t = active_params(cfg), TRAIN_BATCH * MAX_LEN
        summary = {"step_ms_median": med, "tokens_per_s": tok_s,
                   "mfu_6n_active": 6 * n_active * tok_s / peak,
                   "peak_allocated_bytes": peak_bytes, "metrics": metrics}
        emit({"model": "mixtral_8x7b", "layers": cfg.layers, "reduced": "layers 32->4",
              "batch": TRAIN_BATCH, "seq": MAX_LEN, "param_dtype": "bfloat16",
              "remat": cfg.remat, "lora_rank": cfg.lora_rank,
              "params": cfg.num_params(), "active_params": n_active, "init_s": init_s,
              "step_ms_median": med, "step_ms_timed": step_ms[TRAIN_WARMUP:],
              "tokens_per_s": tok_s,
              "mfu_6n_active": summary["mfu_6n_active"], "peak_flops": peak,
              # not the MFU: bench.py's 6·N with every expert counted
              "six_n_all_over_peak": 6 * cfg.num_params() * tok_s / peak,
              "peak_allocated_bytes": peak_bytes,
              # what one fp32 one-hot [k·T, E, C] tensor of JAX's dispatch would hold
              "one_hot_dispatch_bytes": 4 * cfg.experts_per_token * t * cfg.num_experts
              * T.moe_capacity(cfg, t),
              "losses": losses, "clock": "host, synchronized", "card": smi})
        emit({"profile": "moe_train_step", "card": smi,
              **profiled(lambda: run(state, batch), top=16)})
        torch.cuda.synchronize()
        norms = recorder.norms
        dead = [f"layer {i} expert {e}" for i in range(cfg.layers)
                for e, v in enumerate(norms[("wi_gate", i)]) if not v > 0]
        dead += [f"layer {i} router" for i in range(cfg.layers) if not norms[("router", i)] > 0]
        emit({"step0_grad_norms": {f"{n}/{i}": v for (n, i), v in sorted(norms.items())},
              "experts_or_routers_without_grad": dead})
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"MoE losses not finite and falling: {losses}")
        if dead or len(norms) != 2 * cfg.layers:
            raise AssertionError(f"step 0: no gradient for {dead} ({len(norms)} leaves seen)")
        emit({"moe_layer_times": moe_layer_times(cfg, state["params"], y0), "card": smi})
        del state, run, recorder, y0
        gc.collect()
        torch.cuda.empty_cache()
    return launches, summary


def moe_mesh_train_steps(smi, unsharded) -> dict:
    """The sharded MoE training path on a mesh of one rank: an NCCL world
    of one (ray_tpu_torch.parallel.single_device_mesh on cuda, every axis
    of MeshSpec() 1), the same model, seed and batch as moe_train_steps,
    through init_state(cfg, opt, mesh) and make_train_step(cfg, opt, mesh):
    the data and expert axes' code with each collective a copy, and the
    MoE layer's sequence gather, its expert leaves' fsdp gathers and its
    sum over the (expert, tensor) group, each at size one. 2 warm-up,
    MESH_TIMED timed and 1 profiled step; its step ms and peak memory
    beside the unsharded ones, and their deltas. Held against ``unsharded``
    (moe_train_steps' numbers): step 0's loss and accuracy bit-identical,
    its grad_norm within 1e-5 relative, the losses of steps 1-2 within
    1e-3. Returns one step's kernel launches."""
    import torch.distributed as dist

    from ray_tpu_torch import parallel as P
    from ray_tpu_torch import train as S
    from ray_tpu_torch.models import transformer as T
    from ray_tpu_torch.ops import attention as A

    with phase("moe_mesh_train_steps"):
        cfg = T.config("mixtral_8x7b", layers=MOE_LAYERS, param_dtype=torch.bfloat16)
        opt = S.default_optimizer(cfg)
        mesh = P.single_device_mesh("cuda")
        state = run = None
        try:
            emit({"mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
                  "backend": dist.get_backend(), "world": dist.get_world_size()})
            if dist.get_backend() != "nccl":
                raise AssertionError(f"a cuda mesh on {dist.get_backend()}")
            state = S.init_state(cfg, opt, mesh, seed=SEED)
            run = S.make_train_step(cfg, opt, mesh)
            tokens = torch.from_numpy(np.random.RandomState(SEED).randint(
                0, cfg.vocab_size, (TRAIN_BATCH, MAX_LEN))).cuda()
            batch = {"tokens": tokens}
            want = {"flash_fwd": 2 * cfg.layers, "flash_bwd_dq": cfg.layers,
                    "flash_bwd_dkv": cfg.layers}  # forward + remat re-run, one backward
            # the design's collectives a step (design_collectives): the MoE
            # layers' and, each at size one, the FSDP, tensor and loss ones
            want_coll = design_collectives(cfg, len(S.step._units(state["params"])), False)
            gc.collect()
            torch.cuda.reset_peak_memory_stats()
            metrics, step_ms = [], []
            for i in range(TRAIN_WARMUP + MESH_TIMED):
                # ---- the main path: counts from 0, read right after ------
                reset_launches(A)
                P.reset_collectives()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = run(state, batch)
                torch.cuda.synchronize()
                step_ms.append(1e3 * (time.perf_counter() - t0))
                launches, coll = read_launches(A), P.read_collectives()
                # ---- end of the main path --------------------------------
                metrics.append({k: float(v) for k, v in m.items()})
                emit({"moe_mesh_train_step": i, "warmup": i < TRAIN_WARMUP,
                      "ms": step_ms[-1], **metrics[-1], "launches": launches,
                      "collectives": coll})
                if launches != want or coll != want_coll:
                    raise AssertionError(f"mesh step {i} launched {launches} and issued "
                                         f"{coll}, expected {want} and {want_coll}")
            peak_bytes = torch.cuda.max_memory_allocated()
            timed = sorted(step_ms[TRAIN_WARMUP:])
            med = timed[len(timed) // 2]
            tok_s = TRAIN_BATCH * MAX_LEN / (med / 1e3)
            peak = 756e12 if "PCIe" in torch.cuda.get_device_name(0) else 989e12
            ref = unsharded["metrics"]
            cmp = {"step0_loss": [metrics[0]["loss"], ref[0]["loss"]],
                   "step0_accuracy": [metrics[0]["accuracy"], ref[0]["accuracy"]],
                   "step0_grad_norm": [metrics[0]["grad_norm"], ref[0]["grad_norm"]],
                   "losses_1_2": [[m_["loss"] for m_ in metrics[1:3]],
                                  [m_["loss"] for m_ in ref[1:3]]],
                   "bit_identical_steps": sum(a == b for a, b in zip(metrics, ref)),
                   "tol": {"grad_norm_rel": 1e-5, "loss_rel": 1e-3}}
            emit({"model": "mixtral_8x7b", "layers": cfg.layers,
                  "reduced": "layers 32->4", "mesh": "MeshSpec() on an NCCL world of one",
                  "batch": TRAIN_BATCH, "seq": MAX_LEN, "param_dtype": "bfloat16",
                  "step_ms_median": med, "step_ms_timed": step_ms[TRAIN_WARMUP:],
                  "tokens_per_s": tok_s,
                  "mfu_6n_active": 6 * active_params(cfg) * tok_s / peak,
                  "peak_allocated_bytes": peak_bytes,
                  "unsharded": {k: unsharded[k] for k in (
                      "step_ms_median", "tokens_per_s", "mfu_6n_active",
                      "peak_allocated_bytes")},
                  "delta_ms": med - unsharded["step_ms_median"],
                  "delta_peak_gb": (peak_bytes - unsharded["peak_allocated_bytes"]) / 1e9,
                  "against_unsharded": cmp, "clock": "host, synchronized", "card": smi})
            ok = (cmp["step0_loss"][0] == cmp["step0_loss"][1]
                  and cmp["step0_accuracy"][0] == cmp["step0_accuracy"][1]
                  and abs(cmp["step0_grad_norm"][0] - cmp["step0_grad_norm"][1])
                  <= 1e-5 * abs(cmp["step0_grad_norm"][1])
                  and all(abs(a - b) <= 1e-3 * abs(b)
                          for a, b in zip(*cmp["losses_1_2"]))
                  and all(np.isfinite([m_["loss"] for m_ in metrics])))
            if not ok:
                raise AssertionError(f"mesh step and unsharded step disagree: {cmp}")
            emit({"profile": "moe_mesh_train_step", "card": smi,
                  **profiled(lambda: run(state, batch), top=16)})
            torch.cuda.synchronize()
        finally:
            del state, run
            dist.destroy_process_group()
            gc.collect()
            torch.cuda.empty_cache()
    return launches


# the instantiation each main path launches (bf16, D=128), by mangled-name
# substring, and its design
SASS_FUNCTIONS = {"flash_fwd": ("flash_fwd_kernel_sm90ILi128E", "sm90_wgmma_tma"),
                  "flash_bwd_dq": ("flash_bwd_dq_kernel_sm90ILi128E", "sm90_wgmma_tma"),
                  "flash_bwd_dkv": ("flash_bwd_dkv_kernel_sm90ILi128E", "sm90_wgmma_tma")}


def kernel_facts(kernels) -> None:
    """Evidence of the tensor cores: each kernel's count of HGMMA (wgmma)
    instructions in the built library's SASS (cuobjdump -sass), beside its
    registers per thread at launch, static and dynamic shared memory and
    local (spill) bytes as the runtime loaded it. A tensor-core design
    with no HGMMA, or a CUDA-core one with any, fails."""
    from torch.utils.cpp_extension import CUDA_HOME

    from ray_tpu_torch.ops import _build

    with phase("kernel_facts"):
        lib = os.path.join(_build.BUILD_DIR, "ray_tpu_torch_kernels.so")
        sass = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", lib],
                              capture_output=True, text=True, check=True, timeout=300).stdout
        hgmma, func = {}, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                func = m.group(1)
            elif func is not None and "HGMMA" in line:
                hgmma[func] = hgmma.get(func, 0) + 1
        ext = _build.load_extension()
        for name, (sub, design) in SASS_FUNCTIONS.items():
            funcs = [f for f in re.findall(r"Function : (\S+)", sass) if sub in f]
            if len(funcs) != 1:
                raise AssertionError(f"{name}: {len(funcs)} SASS functions match {sub}")
            row = kernels[name]
            row["design"] = design
            row["hgmma"] = hgmma.get(funcs[0], 0)
            row["sass_function"] = funcs[0]
            row["resources"] = dict(ext.kernel_attrs(name, 128))
            emit({"kernel": name, **{k: row[k] for k in
                                      ("design", "hgmma", "sass_function", "resources")}})
            if (row["hgmma"] > 0) != (design == "sm90_wgmma_tma"):
                raise AssertionError(f"{name}: design {design} with {row['hgmma']} HGMMA")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import attention as A

    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 references in full fp32
    torch.backends.cudnn.allow_tf32 = False
    kernels = {}

    with phase("device"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
        name = torch.cuda.get_device_name(0)
        if "H100" not in name:
            raise RuntimeError(f"bounds are for an H100; this card is {name}")
        print(smi, flush=True)
        emit({"device": name, "count": torch.cuda.device_count(),
              "nvidia_smi": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda})

    with phase("build"):
        t0 = time.perf_counter()
        _build.load_extension(verbose=True)  # ptxas's report per kernel
        emit({"build_s": time.perf_counter() - t0, "dir": _build.BUILD_DIR})

    with phase("kernel_vs_plain"):
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        for sname, b, sq, sk, h, hkv, d, causal, dtype in ATTN_SHAPES:
            q = torch.randn((b, sq, h, d), generator=gen, device="cuda").to(dtype)
            k = torch.randn((b, sk, hkv, d), generator=gen, device="cuda").to(dtype)
            v = torch.randn((b, sk, hkv, d), generator=gen, device="cuda").to(dtype)
            o, lse = A.flash_attention_fwd(q, k, v, causal)
            o_ref, lse_ref = A._flash_fwd_reference(q, k, v, causal)
            torch.cuda.synchronize()
            err_o = max_abs(o, o_ref)
            err_lse = max_abs(lse, lse_ref)
            tol_o, tol_lse = TOL[dtype]
            row = {"shape": sname, "b": b, "sq": sq, "sk": sk, "h": h, "hkv": hkv,
                   "d": d, "causal": causal, "dtype": str(dtype),
                   "o_max_abs_err": err_o, "lse_max_abs_err": err_lse,
                   "tol_o": tol_o, "tol_lse": tol_lse}
            if dtype == torch.bfloat16:
                # not gated: what the bf16 rounding of P (and of O) costs
                # against the fp32 computation on the same inputs
                row["o_vs_fp32"] = max_abs(o, A._flash_fwd_reference(
                    q.float(), k.float(), v.float(), causal)[0])
            if sname in TIMED_ATTN:
                iters = TIMED_ATTN[sname]
                row["ms"] = cuda_ms(lambda: A.flash_attention_fwd(q, k, v, causal), iters)
                row["plain_ms"] = cuda_ms(lambda: A._flash_fwd_reference(q, k, v, causal), iters)
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                row["library_ms"] = cuda_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal, enable_gqa=True), iters)
                row["bound_ms"], row["bound_by"] = attention_bound_ms(
                    b, sq, sk, h, hkv, d, causal, dtype)
                row["share"] = row["bound_ms"] / row["ms"]
                timed = {k_: row[k_] for k_ in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                "share", "library_ms")}
                label = shape_label(b, sq, h, hkv, d, causal, dtype)
                if sname == "prefill":  # the serving path's shape
                    kernels["flash_fwd"] = {
                        "name": "flash_fwd", "route": "cuda",
                        "source": "ray_tpu_torch/ops/csrc/flash_fwd_sm90.cu",
                        "replaces": "ray_tpu/ops/attention.py:120",
                        "max_abs_err": err_o, "lse_max_abs_err": err_lse, **timed,
                        "shape": label}
                else:  # a training path's shape
                    kernels["flash_fwd"][f"{sname}_shape"] = {
                        "max_abs_err": err_o, **timed, "shape": label}
            emit(row)
            if not (err_o <= tol_o and err_lse <= tol_lse):
                raise AssertionError(f"flash_fwd disagrees with its plain version at {row}")
            del q, k, v, o, lse, o_ref, lse_ref
            torch.cuda.empty_cache()

    serving, paged, runtime = serving_phases(kernels, smi)
    gc.collect()
    torch.cuda.empty_cache()
    emit({"after_serving_allocated_bytes": torch.cuda.memory_allocated()})
    data_batch = data_llm_batch(smi)

    flash_bwd_vs_plain(kernels, smi)
    ring = ring_vs_flash(smi)
    train_full_width_check()
    train, train_numbers = train_steps(smi)
    gc.collect()
    torch.cuda.empty_cache()
    fit, serve_ckpt = trainer_phases(smi, train_numbers)
    trials = tune_trials(smi, train_numbers)
    checkpoint_mesh_of_one(smi)
    mesh = mesh_train_steps(smi, train_numbers)
    gc.collect()
    torch.cuda.empty_cache()
    pipe = pipeline_train_steps(smi, train_numbers)
    moe_vs_cpu()
    moe, moe_numbers = moe_train_steps(smi)
    moe_mesh = moe_mesh_train_steps(smi, moe_numbers)
    collective_nccl(smi)
    rl = rl_learners(smi)
    anakin = anakin_phases(smi)
    kernel_facts(kernels)
    for name, row in kernels.items():
        row["card"] = smi
        row["launches_by_path"] = {"serving": serving[name], "runtime_local": runtime[name],
                                   "paged_serving": paged[name],
                                   "data_llm_batch": data_batch[name],
                                   "train_step": train[name],
                                   "data_train_ingest":
                                       train_numbers["data_train_ingest_launches"][name],
                                   "tune_trials": trials[name],
                                   "trainer_fit": fit[name],
                                   "serve_from_checkpoint": serve_ckpt[name],
                                   "ring": ring[name], "mesh_train_step": mesh[name],
                                   "pipeline_train_step": pipe[name],
                                   "moe_train_step": moe[name],
                                   "moe_mesh_train_step": moe_mesh[name],
                                   "rl_learners": rl[name], "anakin": anakin[name]}
        if name != "flash_fwd":  # the training step is their main path
            row["launches"] = train[name]

    emit({"kernels": [kernels[k] for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
