"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout and
holds each kernel against its plain PyTorch version on the card: bf16
inputs run the forward, dQ and dK/dV on the tensor cores (wgmma + TMA),
fp32 inputs the CUDA-core kernels. Then it drives the port's two paths
at full width, each with the kernels' launch counts set to 0 just
before it and read just after:

- serving: llama3_8b (all 32 layers, random bf16 weights from seed 0)
  through ray_tpu_torch.llm.LLMEngine and ContinuousLLMEngine;
- training: llama2_7b_lora (all 32 layers, bf16 params, B=8 x 2048,
  remat) through ray_tpu_torch.train.make_train_step, 2 warm-up and 5
  timed steps, after a two-layer fp32 step held against the same step
  with attention through the plain versions;
- mixture-of-experts training: mixtral_8x7b at full width with its 32
  layers cut to 4 (bf16 params, full fine-tune, B=8 x 2048, remat), 2
  warm-up and 5 timed steps, after one MoE layer at Mixtral width held
  against the same layer on the CPU (routing identical, outputs within
  tolerance, with and without capacity drops);
- sharded mixture-of-experts training: the same model, seed and batch
  through a mesh of one rank (an NCCL world of one, MeshSpec() through
  ray_tpu_torch.parallel), the data and expert axes' code with every
  collective a copy: 2 warm-up and 3 timed steps, held against the
  unsharded steps (step 0's loss bit-identical).

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
import gc
import json
import os
import re
import subprocess
import sys
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
    ("ragged", 2, 100, 100, 4, 4, 64, False, torch.float32),
    ("sq_ne_sk", 2, 64, 192, 8, 4, 32, True, torch.float32),
    # their bf16 twins: tensor-core tiles at D=64 and D=32, ragged ends
    ("ragged_bf16", 2, 100, 100, 4, 4, 64, False, torch.bfloat16),
    ("sq_ne_sk_bf16", 2, 64, 192, 8, 4, 32, True, torch.bfloat16),
]
TIMED_ATTN = {"prefill": 20, "train_step": 5, "mixtral_train": 5}  # shape: launches timed


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
TRAIN_BATCH = 8
TRAIN_WARMUP, TRAIN_TIMED = 2, 5
MOE_LAYERS = 4  # mixtral_8x7b's 32 layers cut to 4: 46.7 B params do not fit 80 GB
MOE_TOKENS = 1024  # tokens of the one-layer card-vs-CPU check
MOE_FP32_TOL = 1e-4  # card vs CPU in fp32 (TF32 off): summation order only
MESH_TIMED = 3  # timed steps of the sharded MoE step (after TRAIN_WARMUP)


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


def cuda_ms(fn, iters: int) -> float:
    """Mean ms of ``fn`` over ``iters`` runs after one warm-up, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
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


def profiled(fn, top: int = 8):
    """Run ``fn`` once under torch.profiler: wall ms, device-busy ms (the
    union of the device activity intervals, so nothing counts twice), the
    summed device ms of each of KINDS (the rest as "other"), the launches
    and ms of each flash, indexing and NCCL kernel, and the top device
    activities by summed time."""
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

    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1 - busy_ms / wall_ms),
            "device_ms_by_kind": by_kind, "flash_kernels": members(KINDS[0][1], 80),
            "index_kernels": members(KINDS[2][1], 120),
            "nccl_kernels": members(KINDS[3][1], 80),
            "top_device_activities": [{"name": k[:80], "count": n, "ms": us / 1e3}
                                      for k, (n, us) in tops]}


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


def serving_phases(kernels) -> dict:
    """The serving path: serve llama3_8b at full width through LLMEngine and
    ContinuousLLMEngine (launches counted from 0 around it), then time
    prefill and decode and hold the kernel prefill against the plain
    formulation. Returns the serving path's launches; everything it
    allocates is freed on return."""
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
        launches = read_launches(A)
        kernels["flash_fwd"]["launches"] = launches["flash_fwd"]
        # ---- end of the main path ------------------------------------

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
    _run_bench. Returns one step's kernel launches."""
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
        losses, step_ms = [], []
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
            emit({"train_step": i, "warmup": i < TRAIN_WARMUP, "ms": step_ms[-1],
                  "loss": losses[-1], "grad_norm": float(m["grad_norm"]),
                  "accuracy": float(m["accuracy"]), "launches": launches})
            if launches != want:
                raise AssertionError(f"step {i} launched {launches}, expected {want}")
        timed = sorted(step_ms[TRAIN_WARMUP:])
        med = timed[len(timed) // 2]
        tok_s = TRAIN_BATCH * MAX_LEN / (med / 1e3)
        peak = 756e12 if "PCIe" in torch.cuda.get_device_name(0) else 989e12
        emit({"model": "llama2_7b_lora", "layers": cfg.layers, "batch": TRAIN_BATCH,
              "seq": MAX_LEN, "param_dtype": "bfloat16", "remat": cfg.remat,
              "params": cfg.num_params(), "init_s": init_s,
              "step_ms_median": med, "step_ms_timed": step_ms[TRAIN_WARMUP:],
              "tokens_per_s": tok_s,
              "mfu_6n": 6 * cfg.num_params() * tok_s / peak, "peak_flops": peak,
              "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
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
        del state, params, frozen, lora0
        torch.cuda.empty_cache()
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
    the data and expert axes' code with each collective a copy. 2 warm-up,
    MESH_TIMED timed and 1 profiled step. Held against ``unsharded``
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
            # the design's collectives a step (ray_tpu_torch/parallel/collectives.py):
            # per MoE layer the tokens' gather in the forward and the remat
            # re-run, its reduce-scatter in the backward, the combine's
            # all-reduce twice and the input grad's once; then one all-reduce
            # per grad tensor, the norm's and the metrics'
            units = len(S.step._units(state["params"]))
            want_coll = {"all_gather": 2 * cfg.layers, "reduce_scatter": cfg.layers,
                         "all_reduce": 3 * cfg.layers + units + 2}
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

    serving = serving_phases(kernels)
    gc.collect()
    torch.cuda.empty_cache()
    emit({"after_serving_allocated_bytes": torch.cuda.memory_allocated()})

    flash_bwd_vs_plain(kernels, smi)
    train_full_width_check()
    train = train_steps(smi)
    gc.collect()
    torch.cuda.empty_cache()
    moe_vs_cpu()
    moe, moe_numbers = moe_train_steps(smi)
    moe_mesh = moe_mesh_train_steps(smi, moe_numbers)
    kernel_facts(kernels)
    for name, row in kernels.items():
        row["card"] = smi
        row["launches_by_path"] = {"serving": serving[name], "train_step": train[name],
                                   "moe_train_step": moe[name],
                                   "moe_mesh_train_step": moe_mesh[name]}
        if name != "flash_fwd":  # the training step is their main path
            row["launches"] = train[name]

    emit({"kernels": [kernels[k] for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
