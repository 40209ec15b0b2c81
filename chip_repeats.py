"""Spread of chip_smoke.py's profile-based gates and short timings, on one
NVIDIA GPU.

    python3 chip_repeats.py [check ...]  # every check, or the ones named
    python3 chip_repeats.py --cycles tasks|actor|after_profiles
    python3 chip_repeats.py --after-work <variant>  # a key of AFTER_WORK
    python3 chip_repeats.py --serving fresh|after_profiles|after_traces|twice
    python3 chip_repeats.py --fastpath  # one fastpath_backends run

Some of chip_smoke.py's checks rest on torch.profiler's record of the card
(CUPTI) or on a timing window of about a millisecond. This script repeats
them and prints what each repeat saw, one JSON object a line:

- cupti_record: a run of 3,000 in-place adds profiled 20 times; each
  profile should hold exactly 3,000 device activities;
- gpu_profile_trace: ray_tpu_torch.gpu_profile around one flash call at
  the serving prefill shape, 20 times from a num_gpus=1 task of
  init(local_mode=True) and 20 times from the main thread; each trace
  should name flash_fwd_kernel;
- paged_warm_timing: the flash forward and scaled_dot_product_attention
  at the paged warm shape (B=1, Sq 512 over Sk 1,024, 32/8 heads, bf16,
  no mask) by CUDA events over 20 calls (chip_smoke's window) ten times,
  with cuda_ms's spin and without it, and over 200 calls, beside the
  host's us a call and the device's us a call from a profile of 20 calls;
- gpu_profile_cycles: in a fresh process for each variant, three
  init(local_mode=True) / shutdown cycles, each tracing one flash call
  from a num_gpus=1 task and one from the main thread through
  gpu_profile, with what each trace holds (kernels, flash kernels,
  launch calls and their threads). Variants: tasks alone; an actor
  holding the card alive (as runtime_local's); 20 profiles taken first
  (as in this script's own process);
- trace_after_work: the same two traces, three times each, in a fresh
  process for each variant: after nothing; after one profiled session;
  after 400,000 kernels run with no profiler; after a session and then
  400,000 or 1,200,000 such kernels, the last also with the profiler's
  device-record buffers capped at 1 GB (KINETO_CONFIG) instead of 128 MB,
  or with CUPTI finalized after each trace (TEARDOWN_CUPTI=1); with the
  profiler's warnings;
- serving_variants: chip_smoke.serving_phases (serving, runtime_local,
  paged serving with its three profiles of one decode step) in a fresh
  process for each variant: alone; after cupti_record; after
  gpu_profile_trace; twice. Each run's failure is printed, not raised,
  with what runtime_local's trace held;
- cluster_release_thread: µs a no-op actor call on a one-node cluster
  (median of 300, six windows alternating D, I, I, D, D, I) with the
  releases a reference count reaching zero starts run on the core
  worker's release thread (D, the port's way) and run inline by the
  driver (I, the JAX package's way off its event loop);
- fastpath_backends: runtime_cluster's control-plane measurements under
  each codec, in a fresh process a run (RAY_TPU_FASTPATH is read at
  import), six runs alternating 0, require, require, 0, 0, require: µs a
  no-op actor call on a one-node cluster (median of 300), ms a 64 MB
  CUDA tensor's put by the driver plus its get in a num_gpus=1 worker
  (median of 5), and GB/s of fastpath.write_body_into laying a 64 MB
  body into a buffer in the driver (median of 20), with the backend each
  process kind loaded.

It exits 0 when every repeat ran, whatever it saw; the last line sums up.
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

import chip_smoke as C

PROFILES = 20  # cupti_record's profiles
ADDS = 3000  # device activities a cupti_record profile should hold
TRACES = 20  # gpu_profile_trace's traces from each thread
WINDOWS = 10  # paged_warm_timing's 20-call windows
LONG = 200  # paged_warm_timing's long window and host timing, in calls


def cupti_record() -> dict:
    x = torch.zeros(1024, device="cuda")

    def adds():
        for _ in range(ADDS):
            x.add_(1)

    counts = [C.profiled(adds)["device_activities"] for _ in range(PROFILES)]
    row = {"expected": ADDS, "counts": counts, "off": sum(c != ADDS for c in counts)}
    C.emit({"cupti_record": row})
    return row


def gpu_profile_trace() -> dict:
    import ray_tpu_torch as rt

    gen = torch.Generator(device="cuda").manual_seed(C.SEED)
    q = torch.randn((1, C.MAX_LEN, 32, 128), generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn((1, C.MAX_LEN, 8, 128), generator=gen, device="cuda").bfloat16()
            for _ in range(2))
    rt.init(local_mode=True)
    row = {}
    try:
        attend = rt.remote(num_gpus=1)(C.prefill_attention)
        calls = {"task": lambda: rt.get(attend.remote(q, k, v)),
                 "main_thread": lambda: C.prefill_attention(q, k, v)}
        for where, call in calls.items():
            seen = []
            for _ in range(TRACES):
                logdir = tempfile.mkdtemp(prefix="gpu_profile_trace_")
                try:
                    with rt.gpu_profile(logdir) as prof:
                        call()
                        torch.cuda.synchronize()
                    with open(prof.path) as f:
                        seen.append("flash_fwd_kernel" in f.read())
                finally:
                    shutil.rmtree(logdir, ignore_errors=True)
            row[where] = {"traces": TRACES, "missed": seen.count(False),
                          "missed_at": [i for i, s in enumerate(seen) if not s]}
    finally:
        rt.shutdown()
    C.emit({"gpu_profile_trace": row})
    return row


CYCLES = 3  # gpu_profile_cycles' init / shutdown cycles a variant
VARIANTS = ("tasks", "actor", "after_profiles")


class CardHolder:
    """gpu_profile_cycles' actor: holds the one card, as runtime_local's
    ServedLlama does, and makes one flash call on its own thread."""

    def attend(self, q, k, v):
        return C.prefill_attention(q, k, v)


def gpu_profile_cycle_run(variant: str) -> dict:
    """One variant of gpu_profile_cycles, in this (fresh) process."""
    import ray_tpu_torch as rt

    gen = torch.Generator(device="cuda").manual_seed(C.SEED)
    q = torch.randn((1, C.MAX_LEN, 32, 128), generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn((1, C.MAX_LEN, 8, 128), generator=gen, device="cuda").bfloat16()
            for _ in range(2))
    if variant == "after_profiles":
        for _ in range(PROFILES):
            C.profiled(lambda: C.prefill_attention(q, k, v))
    cycles = []
    for _ in range(CYCLES):
        rt.init(local_mode=True)
        try:
            holder = None
            if variant == "actor":
                holder = rt.remote(num_gpus=1)(CardHolder).remote()
                rt.get(holder.attend.remote(q, k, v))
            attend = rt.remote(num_gpus=1)(C.prefill_attention)
            calls = {"task": lambda: rt.get(attend.remote(q, k, v)),
                     "main_thread": lambda: C.prefill_attention(q, k, v)}
            cycle = {}
            for where, call in calls.items():
                logdir = tempfile.mkdtemp(prefix="gpu_profile_cycles_")
                try:
                    with rt.gpu_profile(logdir) as prof:
                        call()
                        torch.cuda.synchronize()
                    cycle[where] = C.trace_holds(prof.path)
                finally:
                    shutil.rmtree(logdir, ignore_errors=True)
            cycles.append(cycle)
            del holder
        finally:
            rt.shutdown()
    return {"variant": variant, "cycles": cycles}


def gpu_profile_cycles() -> dict:
    row = {}
    for variant in VARIANTS:
        out = subprocess.run([sys.executable, __file__, "--cycles", variant],
                             capture_output=True, text=True, timeout=300)
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
        row[variant] = json.loads(lines[-1])["cycles"] if out.returncode == 0 and lines \
            else {"rc": out.returncode, "stderr": out.stderr[-1500:]}
    C.emit({"gpu_profile_cycles": row})
    return row


def unspun_ms(fn, iters: int) -> float:
    """chip_smoke.cuda_ms without its spin: the runs are timed as the host
    queues them."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def paged_warm_timing(smi) -> dict:
    from ray_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(C.SEED)
    q = torch.randn((1, 512, 32, 128), generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn((1, 1024, 8, 128), generator=gen, device="cuda").bfloat16()
            for _ in range(2))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    fns = {"kernel": lambda: A.flash_attention_fwd(q, k, v, False),
           "library": lambda: torch.nn.functional.scaled_dot_product_attention(
               qt, kt, vt, enable_gqa=True)}
    row = {"card": smi}
    for name, fn in fns.items():
        unspun = [unspun_ms(fn, 20) for _ in range(WINDOWS)]
        windows = [C.cuda_ms(fn, 20) for _ in range(WINDOWS)]
        long = C.cuda_ms(fn, LONG)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LONG):
            fn()
        host_us = 1e6 * (time.perf_counter() - t0) / LONG
        torch.cuda.synchronize()
        prof = C.profiled(lambda: [fn() for _ in range(20)])
        row[name] = {"ms_20_calls_unspun": unspun, "ms_20_calls": windows,
                     "ms_200_calls": long,
                     "host_us_a_call": host_us,
                     "device_us_a_call": 1e3 * prof["device_busy_ms"] / 20,
                     "device_activities_a_call": prof["device_activities"] / 20}
    C.emit({"paged_warm_timing": row})
    return row


# trace_after_work's variants: (profiled sessions first, kernels then run
# with no profiler, before the traces)
AFTER_WORK = {"none": (0, 0), "session": (1, 0), "work": (0, 400_000),
              "session_work": (1, 400_000), "session_more_work": (1, 1_200_000),
              "session_more_work_1gb": (1, 1_200_000),
              "session_more_work_teardown": (1, 1_200_000)}
BIG_BUFFER_MB = 1024  # the last variant's cap on the profiler's device-record buffers
AFTER_WORK_TRACES = 3  # traces from each thread


def trace_after_work_run(variant: str) -> dict:
    """One variant of trace_after_work, in this (fresh) process."""
    import ray_tpu_torch as rt

    sessions, work = AFTER_WORK[variant]
    gen = torch.Generator(device="cuda").manual_seed(C.SEED)
    q = torch.randn((1, C.MAX_LEN, 32, 128), generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn((1, C.MAX_LEN, 8, 128), generator=gen, device="cuda").bfloat16()
            for _ in range(2))
    x = torch.zeros(1024, device="cuda")
    for _ in range(sessions):
        C.profiled(lambda: x.add_(1))
    t0 = time.perf_counter()
    for _ in range(work):
        x.add_(1)
    torch.cuda.synchronize()
    work_s = time.perf_counter() - t0
    rt.init(local_mode=True)
    traces = []
    try:
        attend = rt.remote(num_gpus=1)(C.prefill_attention)
        calls = {"task": lambda: rt.get(attend.remote(q, k, v)),
                 "main_thread": lambda: C.prefill_attention(q, k, v)}
        for _ in range(AFTER_WORK_TRACES):
            for where, call in calls.items():
                logdir = tempfile.mkdtemp(prefix="trace_after_work_")
                try:
                    with rt.gpu_profile(logdir) as prof:
                        call()
                        torch.cuda.synchronize()
                    held = C.trace_holds(prof.path)
                finally:
                    shutil.rmtree(logdir, ignore_errors=True)
                traces.append({"from": where, "flash": held["flash"],
                               "launch_calls": len(held["launch_calls"])})
    finally:
        rt.shutdown()
    return {"variant": variant, "sessions": sessions, "kernels_between": work,
            "work_s": work_s, "traces": traces}


def trace_after_work() -> dict:
    """gpu_profile traces of one flash call (a task's, the main thread's)
    after a profiled session, after many kernels run with no profiler, and
    after both, each variant in a fresh process; with the profiler's
    messages about its buffers or dropped records."""
    row = {}
    conf = tempfile.mkdtemp(prefix="kineto_conf_")
    with open(os.path.join(conf, "kineto.conf"), "w") as f:
        f.write(f"ACTIVITIES_MAX_GPU_BUFFER_SIZE_MB={BIG_BUFFER_MB}\n")
    try:
        for variant in AFTER_WORK:
            env = {**os.environ, "KINETO_LOG_LEVEL": "0"}
            if variant.endswith("_1gb"):
                env["KINETO_CONFIG"] = os.path.join(conf, "kineto.conf")
            if variant.endswith("_teardown"):
                env["TEARDOWN_CUPTI"] = "1"  # the profiler finalizes CUPTI after a trace
            out = subprocess.run([sys.executable, __file__, "--after-work", variant],
                                 capture_output=True, text=True, timeout=600, env=env)
            lines = [ln for ln in out.stdout.splitlines() if ln.startswith('{"variant"')]
            said = [ln[:300] for ln in out.stderr.splitlines()
                    if ln.startswith(("WARNING", "ERROR")) or "max CUPTI buffer" in ln]
            row[variant] = {**(json.loads(lines[-1]) if lines else
                               {"rc": out.returncode, "stderr": out.stderr[-1500:]}),
                            "profiler_warned": sorted(set(said))[:40]}
            C.emit({"trace_after_work": row[variant]})
    finally:
        shutil.rmtree(conf, ignore_errors=True)
    return row


SERVING_VARIANTS = ("fresh", "after_profiles", "after_traces", "twice")


def serving_run(variant: str, smi) -> list:
    """One variant of serving_variants, in this (fresh) process: what runs
    before chip_smoke.serving_phases, and each run's outcome."""
    if variant == "after_profiles":
        cupti_record()
    elif variant == "after_traces":
        gpu_profile_trace()
    outcomes = []
    for _ in range(2 if variant == "twice" else 1):
        try:
            C.serving_phases({"flash_fwd": {}}, smi)
            outcomes.append("passed")
        except Exception as e:  # the repeat's outcome is what this script reports
            outcomes.append(repr(e)[:300])
        gc.collect()
        torch.cuda.empty_cache()
    return outcomes


def serving_variants(smi) -> dict:
    row = {}
    for variant in SERVING_VARIANTS:
        out = subprocess.run([sys.executable, __file__, "--serving", variant],
                             capture_output=True, text=True, timeout=600)
        holds = [ln for ln in out.stdout.splitlines() if '"trace_holds"' in ln]
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith('{"outcomes"')]
        row[variant] = {"outcomes": json.loads(lines[-1])["outcomes"] if lines else None,
                        "rc": out.returncode, "traces": [json.loads(h) for h in holds]}
        if not lines:
            row[variant]["stderr"] = out.stderr[-1500:]
        C.emit({"serving_variant": variant, **row[variant]})
    return row


CALLS = 300  # cluster_release_thread's calls a window


def cluster_release_thread(smi) -> dict:
    import numpy as np

    import ray_tpu_torch as rt

    rt.init(num_cpus=2)
    try:
        core = rt._private.worker.global_worker.core
        deferred = core.free_object

        @rt.remote
        class Pinger:
            def ping(self):
                return None

        a = Pinger.remote()
        rt.get(a.ping.remote(), timeout=120)
        row = {"deferred": [], "inline": [], "calls": CALLS, "card": smi}
        for mode in "DIIDDI":
            core.free_object = deferred if mode == "D" else core._free_object_sync
            rt.get([a.ping.remote() for _ in range(50)], timeout=120)
            ts = []
            for _ in range(CALLS):
                t0 = time.perf_counter()
                rt.get(a.ping.remote(), timeout=60)
                ts.append(time.perf_counter() - t0)
            row["deferred" if mode == "D" else "inline"].append(1e6 * float(np.median(ts)))
        core.free_object = deferred
        rt.kill(a)
    finally:
        rt.shutdown()
    C.emit({"cluster_release_thread": row})
    return row


CODEC_BYTES = 64 * 2 ** 20  # fastpath_backends' write_body_into body
CODEC_REPEATS = 20  # its timed layouts (median)
FASTPATH_MODES = ("0", "require", "require", "0", "0", "require")


def fastpath_run(smi) -> dict:
    """One fastpath_backends run, under the RAY_TPU_FASTPATH this process
    was started with."""
    import numpy as np

    import ray_tpu_torch as rt
    from ray_tpu_torch._private import fastpath

    body = memoryview(np.random.default_rng(0).integers(
        0, 255, CODEC_BYTES, dtype=np.uint8)).cast("B")
    meta = b"m" * 256
    dest = bytearray(8 + len(meta) + 8 + body.nbytes)
    for _ in range(3):  # the destination's pages faulted in
        fastpath.write_body_into(dest, meta, [body])
    ts = []
    for _ in range(CODEC_REPEATS):
        t0 = time.perf_counter()
        fastpath.write_body_into(dest, meta, [body])
        ts.append(time.perf_counter() - t0)
    if bytes(dest) != fastpath.available_backends()["python"].encode_body(meta, [body]):
        raise AssertionError("write_body_into laid out another body than encode_body")
    row = {"mode": os.environ.get("RAY_TPU_FASTPATH"), "driver": fastpath.backend(),
           "write_body_into_gb_s": body.nbytes / float(np.median(ts)) / 1e9,
           "write_body_into_ms": 1e3 * float(np.median(ts)), "card": smi}
    rt.init(num_cpus=2)
    try:
        @rt.remote
        class Pinger:
            def ping(self):
                return None

            def backend(self):
                return C.fastpath_backend()

        a = Pinger.remote()
        row["actor_worker"] = rt.get(a.backend.remote(), timeout=300)
        row["task_worker"] = rt.get(rt.remote(C.fastpath_backend).remote(), timeout=300)
        rt.get([a.ping.remote() for _ in range(50)], timeout=120)
        row["actor_call_us"] = C.median_host_us(lambda: rt.get(a.ping.remote(), timeout=60),
                                                C.CLUSTER_CALLS)
        x = torch.randn(C.RUNTIME_PUT_BYTES // 2, device="cuda").bfloat16()
        fetch = rt.remote(num_gpus=1)(C.cluster_fetch_task)
        put_get = []
        for _ in range(C.CLUSTER_PUTS + 1):  # the first leases the worker: dropped
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = rt.put(x)
            put_ms = 1e3 * (time.perf_counter() - t0)
            put_get.append(put_ms + rt.get(fetch.remote([ref]), timeout=300)["get_ms"])
            del ref
        row["put_get_64mb_ms"] = float(np.median(put_get[1:]))
        row["put_get_64mb_ms_all"] = put_get[1:]
        rt.kill(a)
    finally:
        rt.shutdown()
    return row


def fastpath_backends(smi) -> dict:
    rows = []
    for mode in FASTPATH_MODES:
        env = dict(os.environ, RAY_TPU_FASTPATH=mode)
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--fastpath"],
                             capture_output=True, text=True, timeout=600, env=env)
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
        row = json.loads(lines[-1]) if out.returncode == 0 and lines else \
            {"mode": mode, "rc": out.returncode, "stderr": out.stderr[-1500:]}
        C.emit({"fastpath_run": row})
        rows.append(row)
    summary = {}
    for mode in sorted(set(FASTPATH_MODES)):
        mine = [r for r in rows if r.get("mode") == mode and "actor_call_us" in r]
        summary[mode] = {k: [r[k] for r in mine] for k in
                         ("actor_call_us", "put_get_64mb_ms", "write_body_into_gb_s")}
        summary[mode]["backends"] = sorted({(r["driver"], r["task_worker"], r["actor_worker"])
                                            for r in mine})
    C.emit({"fastpath_backends": summary, "card": smi})
    return summary


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_repeats: no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    from ray_tpu_torch.ops import _build

    if sys.argv[1:2] == ["--after-work"]:
        _build.load_extension()
        print(json.dumps(trace_after_work_run(sys.argv[2])), flush=True)
        return 0
    if sys.argv[1:2] == ["--cycles"]:
        _build.load_extension()
        print(json.dumps(gpu_profile_cycle_run(sys.argv[2])), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    if sys.argv[1:2] == ["--fastpath"]:
        print(json.dumps(fastpath_run(smi)), flush=True)
        return 0
    if sys.argv[1:2] == ["--serving"]:
        _build.load_extension()
        print(json.dumps({"outcomes": serving_run(sys.argv[2], smi)}), flush=True)
        return 0

    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.main
    torch.backends.cudnn.allow_tf32 = False
    print(smi, flush=True)
    checks = {"paged_warm_timing": lambda: paged_warm_timing(smi),
              "cupti_record": cupti_record, "gpu_profile_trace": gpu_profile_trace,
              "gpu_profile_cycles": gpu_profile_cycles, "trace_after_work": trace_after_work,
              "serving_variants": lambda: serving_variants(smi),
              "cluster_release_thread": lambda: cluster_release_thread(smi),
              "fastpath_backends": lambda: fastpath_backends(smi)}
    chosen = sys.argv[1:] or list(checks)
    if set(chosen) - {"fastpath_backends"}:  # the one check that runs no kernel
        _build.load_extension()
    summary = {"card": smi, **{name: checks[name]() for name in chosen}}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
