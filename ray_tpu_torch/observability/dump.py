"""Flight-recorder dumps: persist every process's black box on failure (copy of
ray_tpu/observability/dump.py).

The per-process event ring (``events.py``) exists precisely for
postmortems, but until now nothing wrote it anywhere when something
died — ROADMAP #5 calls that gap out by name. This module turns a
typed failure (``CollectiveRankFailure``, drain-deadline expiry, serve
504, restarts-exhausted actor death) or an operator signal into a JSON
*shard* per process under one per-run debug directory:

    {events ring, active spans, metrics snapshot, loop-lag samples,
     counter series, reason, clocks}

``tools/obsdump`` merges the shards into a single Chrome/Perfetto
trace with counter tracks. Triggers:

- ``dump_now(reason)``: this process only (rate-limited per reason).
- ``trigger_cluster_dump(reason)``: local shard + a oneway RPC to the
  GCS, which fans ``DebugDump`` out to raylets/drivers/workers.
- ``RAY_TPU_DEBUG_DUMP=1``: every process also dumps at exit.
- ``SIGUSR2``: dump on demand without killing the process.

Shards are cheap (bounded rings, one JSON write) and dumping must
never hurt the failing path more than the failure did — every entry
point swallows its own errors.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

_COUNTER_MAX = 2048       # samples kept per counter series
_THROTTLE_S = 5.0         # min spacing between dumps for one reason

_lock = threading.Lock()
_counters: Dict[str, deque] = {}
_last_dump: Dict[str, float] = {}
_seq = 0
_installed = False
_run_tag: Optional[str] = None


def set_run_tag(tag: str) -> None:
    """Override the per-run directory component (the GCS names the run
    after its own address; everyone else derives it from env)."""
    global _run_tag
    _run_tag = str(tag).replace(":", "-").replace("/", "_")


def debug_dir() -> str:
    """The per-run debug directory. ``RAY_TPU_DEBUG_DIR`` wins (tests,
    operators); otherwise shards land under ``/tmp/ray_tpu_debug/<gcs
    address>`` so every process of one cluster agrees on the directory
    without coordination."""
    explicit = os.environ.get("RAY_TPU_DEBUG_DIR")
    if explicit:
        return explicit
    tag = _run_tag
    if not tag:
        addr = os.environ.get("RAY_TPU_GCS_ADDR", "")
        if not addr:
            try:
                from ray_tpu_torch._private import worker as worker_mod
                w = worker_mod.global_worker
                gcs = getattr(getattr(w, "core", None), "gcs", None)
                addr = f"{gcs.host}:{gcs.port}" if gcs is not None else ""
            except Exception:  # noqa: BLE001 — fall through to "local"
                addr = ""
        tag = (addr or "local").replace(":", "-").replace("/", "_")
    return os.path.join("/tmp", "ray_tpu_debug", f"gcs-{tag}")


def counter_sample(name: str, value: float) -> None:
    """Append one (wall_ts, value) sample to a bounded per-name series;
    obsdump renders these as Chrome-trace counter tracks."""
    with _lock:
        q = _counters.get(name)
        if q is None:
            q = _counters[name] = deque(maxlen=_COUNTER_MAX)
        q.append((time.time(), float(value)))


def counter_series() -> Dict[str, List[List[float]]]:
    with _lock:
        return {n: [list(s) for s in q] for n, q in _counters.items()}


def _loop_lag_samples() -> List[dict]:
    try:
        from ray_tpu_torch._private import rpc as rpc_mod
        return rpc_mod.loop_lag_samples()
    except Exception:  # noqa: BLE001 — rpc not imported in this process
        return []


def _metrics_snapshot() -> List[dict]:
    try:
        from ray_tpu_torch.util.metrics import _Registry
        return _Registry.get().snapshot()
    except Exception:  # noqa: BLE001
        return []


def would_dump(reason: str) -> bool:
    """Cheap throttle pre-check (no state change): lets hot paths skip
    even the thread spawn when a dump for this reason just fired."""
    with _lock:
        return time.monotonic() - _last_dump.get(reason, -1e18) \
            >= _THROTTLE_S


def dump_now(reason: str, extra: Optional[Dict[str, Any]] = None,
             force: bool = False) -> Optional[str]:
    """Write this process's shard; returns the path or None (throttled
    or failed). Never raises."""
    global _seq
    try:
        now = time.monotonic()
        with _lock:
            last = _last_dump.get(reason, -1e18)
            if not force and now - last < _THROTTLE_S:
                return None
            _last_dump[reason] = now
            _seq += 1
            seq = _seq
        from ray_tpu_torch.observability import events as _events
        from ray_tpu_torch.observability import tracing as _tracing

        ident = _events._process_ident()
        shard = {
            "version": 1,
            "reason": reason,
            "ts": time.time(),
            "mono": time.monotonic(),
            "process": ident,
            "pid": os.getpid(),
            "events": _events.local_events(),
            "active_spans": _tracing.active_spans(),
            "metrics": _metrics_snapshot(),
            "loop_lag": _loop_lag_samples(),
            "counters": counter_series(),
            "extra": dict(extra or {}),
        }
        d = debug_dir()
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"{ident}-{os.getpid()}-{seq}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(shard, f, default=repr)
        os.replace(tmp, path)
        try:
            _events.record_event("debug_dump", reason=reason, path=path,
                                 source=ident)
        except Exception:  # noqa: BLE001 — the shard is already on disk
            pass
        return path
    except Exception:  # noqa: BLE001 — dumping must never hurt the caller
        return None


def trigger_cluster_dump(reason: str, **info: Any) -> Optional[str]:
    """Local shard now, plus a oneway ask to the GCS to fan the dump
    out cluster-wide (``TriggerDebugDump`` -> ``DebugDump`` on every
    raylet, driver, and a capped set of actor workers)."""
    path = dump_now(reason, extra=info or None)
    if path is None:
        # throttled: a dump for this reason fired seconds ago and the
        # fan-out rode it — repeating the oneway would only amplify a
        # failure storm (e.g. a 504 burst) into RPC load
        return None
    try:
        from ray_tpu_torch.observability import events as _events
        gcs = _events._gcs_client()
        if gcs is not None:
            gcs.call_oneway("TriggerDebugDump", reason=reason, info=info)
    except Exception:  # noqa: BLE001 — local shard already written
        pass
    return path


def install(process_name: str = "") -> None:
    """Arm the operator triggers for this process: SIGUSR2 dumps on
    demand; with ``RAY_TPU_DEBUG_DUMP=1`` an atexit hook dumps the ring
    at shutdown too. Idempotent; safe off the main thread (the signal
    handler is then simply skipped)."""
    global _installed
    with _lock:
        if _installed:
            return
        _installed = True
    try:
        import signal

        def _on_sig(signum, frame):  # noqa: ARG001 — signal signature
            dump_now("signal", force=True)

        signal.signal(signal.SIGUSR2, _on_sig)
    except (ValueError, OSError, AttributeError):
        pass  # not the main thread / restricted platform
    if os.environ.get("RAY_TPU_DEBUG_DUMP", "0").lower() \
            not in ("0", "", "false"):
        import atexit

        atexit.register(
            lambda: dump_now(f"atexit:{process_name or 'proc'}",
                             force=True))
