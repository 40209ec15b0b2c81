"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each kernel against its plain PyTorch version on the card, then serves
llama3_8b at full width (all 32 layers, random bf16 weights from seed 0)
through ray_tpu_torch.llm.LLMEngine and ContinuousLLMEngine, and checks
that the serving path went through the kernels. Every phase prints one
JSON line; any failure raises and the script exits non-zero. The last
line is {"ok": true, "device": {...}}. Without a CUDA device it exits 1
before doing anything.
"""

from __future__ import annotations

import contextlib
import json
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
# kernel vs plain version: both compute in fp32; fp32 differs only by
# summation order; bf16 O rounds once more to bf16 (1 ulp of |O| <= ~4)
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-3)}  # (O, LSE)
ATTN_SHAPES = [  # (name, B, Sq, Sk, H, Hkv, D, causal, dtype)
    # the continuous engine's largest prefill bucket; timed
    ("prefill", 1, 2048, 2048, 32, 8, 128, True, torch.bfloat16),
    # LLMEngine's prefill of the 4 smoke prompts (padded to the longest)
    ("prefill_batch4", 4, 1500, 1500, 32, 8, 128, True, torch.bfloat16),
    ("ragged", 2, 100, 100, 4, 4, 64, False, torch.float32),
    ("sq_ne_sk", 2, 64, 192, 8, 4, 32, True, torch.float32),
]


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


def profiled(fn, top: int = 8):
    """Run ``fn`` once under torch.profiler: wall ms, device-busy ms (the
    union of the device activity intervals, so nothing counts twice) and
    the top device activities by summed time."""
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
    tops = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1 - busy_ms / wall_ms),
            "top_device_activities": [{"name": k[:80], "count": n, "ms": us / 1e3}
                                      for k, (n, us) in tops]}


def attention_bound_ms(b, sq, sk, h, hkv, d, causal, dtype):
    """Least time for the flash forward on these inputs: the larger of its
    bytes (q, k, v read once; O and the fp32 LSE written once) over HBM
    rate and its multiply-adds over the peak rate for the input type.
    Under the top-left causal mask query i sees min(i + 1, Sk) keys."""
    es = torch.finfo(dtype).bits // 8
    nbytes = es * (2 * b * sq * h * d + 2 * b * sk * hkv * d) + 4 * b * h * sq
    pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
    flops = 4 * b * h * d * pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    from ray_tpu_torch.llm import ContinuousLLMEngine, LLMConfig, LLMEngine, SamplingParams
    from ray_tpu_torch.models import transformer as T
    from ray_tpu_torch.models.decoding import forward_cached, init_cache
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
        _build.load_extension()
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
            err_o = float((o.float() - o_ref.float()).abs().max())
            err_lse = float((lse - lse_ref).abs().max())
            tol_o, tol_lse = TOL[dtype]
            row = {"shape": sname, "b": b, "sq": sq, "sk": sk, "h": h, "hkv": hkv,
                   "d": d, "causal": causal, "dtype": str(dtype),
                   "o_max_abs_err": err_o, "lse_max_abs_err": err_lse,
                   "tol_o": tol_o, "tol_lse": tol_lse}
            if sname == "prefill":
                iters = 20
                row["ms"] = cuda_ms(lambda: A.flash_attention_fwd(q, k, v, causal), iters)
                row["plain_ms"] = cuda_ms(lambda: A._flash_fwd_reference(q, k, v, causal), iters)
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                row["library_ms"] = cuda_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal, enable_gqa=True), iters)
                row["bound_ms"], row["bound_by"] = attention_bound_ms(
                    b, sq, sk, h, hkv, d, causal, dtype)
                kernels["flash_fwd"] = {
                    "name": "flash_fwd", "route": "cuda",
                    "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
                    "replaces": "ray_tpu/ops/attention.py:120",
                    "max_abs_err": err_o, "lse_max_abs_err": err_lse,
                    **{k_: row[k_] for k_ in ("ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms")}}
            emit(row)
            if not (err_o <= tol_o and err_lse <= tol_lse):
                raise AssertionError(f"flash_fwd disagrees with its plain version at {row}")
            del q, k, v, o, lse, o_ref, lse_ref

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
        A.flash_fwd_launches = 0
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
        kernels["flash_fwd"]["launches"] = A.flash_fwd_launches
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

    emit({"kernels": [kernels["flash_fwd"]]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
