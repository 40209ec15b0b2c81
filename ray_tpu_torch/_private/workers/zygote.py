"""Prefork worker factory — the "zygote" process (copy of
ray_tpu/_private/workers/zygote.py; it pre-imports torch where JAX's
pre-imports jax).

The reference hides Python worker startup latency by prestarting idle
workers (src/ray/raylet/worker_pool.cc PrestartWorkers) — but each
prestart is still a cold interpreter plus the full import chain, and a
TPU host's CPU cores are scarce next to its chips: spawning 50 actors
costs 50 × (interpreter + imports) of the one core the control plane
lives on. The zygote pays the import ONCE, then every worker is a
``fork()`` — milliseconds, with the imported pages shared copy-on-write
across the whole worker pool.

Protocol (newline-delimited JSON over stdin/stdout):

    raylet -> zygote: {"env": {...}, "log_path": "..."}   spawn request
    zygote -> raylet: {"pid": N} | {"error": "..."}
    raylet -> zygote: {"op": "ping"} -> {"ok": true}

The zygote is single-threaded and opens no sockets, so fork is safe: no
locks can be held, no event loop state is duplicated. Children join the
raylet's process group (nothing calls setsid), so group-level teardown
behaves exactly like subprocess-spawned workers. Exited children are
reaped on every protocol message and on a 5 s idle tick.
"""

from __future__ import annotations

import json
import os
import select
import sys


def _reap() -> None:
    while True:
        try:
            pid, _ = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:
            return
        if pid == 0:
            return


def _child(req: dict, protocol_fds) -> None:
    """Become the worker. Never returns."""
    try:
        for fd in protocol_fds:
            try:
                os.close(fd)
            except OSError:
                pass
        log_path = req.get("log_path")
        if log_path:
            logfd = os.open(log_path,
                            os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
            os.dup2(logfd, 1)
            os.dup2(logfd, 2)
            os.close(logfd)
        devnull = os.open(os.devnull, os.O_RDONLY)
        os.dup2(devnull, 0)
        os.close(devnull)
        os.environ.update(req.get("env", {}))
        try:
            # forked children keep the zygote's /proc cmdline; at least
            # stamp the kernel comm (ps -o comm) for diagnosability
            import ctypes

            wid = req.get("env", {}).get("RAY_TPU_WORKER_ID", "")[:7]
            libc = ctypes.CDLL(None, use_errno=True)
            libc.prctl(15, ctypes.c_char_p(f"rtw:{wid}".encode()), 0, 0, 0)
        except Exception:  # noqa: BLE001
            pass
        from ray_tpu_torch._private.workers import default_worker

        default_worker.main()
    except BaseException:  # noqa: BLE001 — a child must never fall back
        import traceback

        traceback.print_exc()
    finally:
        os._exit(1)


def main() -> None:
    # the heavy imports happen ONCE, before the serve loop; every spawn
    # is then a fork of this warmed image. torch is included (import
    # only): actor workers almost always need it, and one warmed copy is
    # shared copy-on-write pool-wide. Nothing here may initialize CUDA:
    # a child forked after cuInit cannot use the card, and
    # torch.cuda.device_count() caches its answer, which a child would
    # inherit under another CUDA_VISIBLE_DEVICES. So no torch.cuda call.
    import torch  # noqa: F401

    import ray_tpu_torch._private.workers.default_worker  # noqa: F401

    inp = sys.stdin.buffer
    out = sys.stdout.buffer
    protocol_fds = (inp.fileno(), out.fileno())
    while True:
        ready, _, _ = select.select([inp], [], [], 5.0)
        _reap()
        if not ready:
            continue
        line = inp.readline()
        if not line:
            return  # raylet closed the pipe; running workers unaffected
        try:
            req = json.loads(line)
        except ValueError:
            continue
        if req.get("op") == "ping":
            out.write(json.dumps({"ok": True}).encode() + b"\n")
            out.flush()
            continue
        try:
            pid = os.fork()
        except OSError as e:
            out.write(json.dumps({"error": str(e)}).encode() + b"\n")
            out.flush()
            continue
        if pid == 0:
            _child(req, protocol_fds)  # never returns
        out.write(json.dumps({"pid": pid}).encode() + b"\n")
        out.flush()


if __name__ == "__main__":
    main()
