"""Structured event bus: per-process flight recorder + GCS shipping (copy of
ray_tpu/observability/events.py).

Reference: src/ray/core_worker/task_event_buffer.h (bounded buffer,
periodic flush to GcsTaskManager) generalized to arbitrary typed events.

Every process owns one :class:`EventBuffer`:

- ``record()`` appends to a bounded *pending* batch (shipped to the
  GCS-side aggregator by a lazy flusher thread) AND to a bounded
  *recent* ring that survives flushing — the flight recorder a
  postmortem can read locally even when the control plane is gone.
- Overflow drops the oldest half of the pending batch and counts the
  drop; the bus never blocks or grows without bound.

Recording is cheap (dict build + two deque appends under a lock) but
not free, so hot paths gate on ``tracing.enabled()`` or an inherited
sampled context before building the event dict.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

_RECENT_MAX = 2048        # flight-recorder ring (per process)
_PENDING_MAX = 8192       # unflushed backlog cap
_FLUSH_PERIOD_S = 0.5

# daemon processes (GCS, raylet) have no global_worker: the GCS ingests
# its own events through a local sink (no RPC to itself) and the raylet
# injects its GCS client explicitly.
_local_sink: Optional[Callable[[List[dict], dict], None]] = None
_gcs_client_override: Any = None
_ident_override: Optional[str] = None


def set_local_sink(sink: Callable[[List[dict], dict], None]) -> None:
    """In-process delivery (the GCS wires its aggregator here): called
    as ``sink(batch, clock)`` with the same clock dict a remote flush
    would carry."""
    global _local_sink
    _local_sink = sink


def set_gcs_client(client: Any) -> None:
    """Explicit GCS client for processes without a global_worker (the
    raylet) so their rings ship instead of requeueing forever."""
    global _gcs_client_override
    _gcs_client_override = client


def set_process_ident(ident: str) -> None:
    """Stable event ``worker`` tag for daemons (e.g. "gcs", "raylet-<id>")."""
    global _ident_override
    _ident_override = ident


def _gcs_client() -> Any:
    if _gcs_client_override is not None:
        return _gcs_client_override
    from ray_tpu_torch._private import worker as worker_mod

    w = worker_mod.global_worker
    return getattr(getattr(w, "core", None), "gcs", None) if w else None


class EventBuffer:
    """Bounded ring + flusher (one per process, lazily created)."""

    _instance: Optional["EventBuffer"] = None
    _instance_lock = threading.Lock()

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._recent: deque = deque(maxlen=_RECENT_MAX)
        self._pending: List[dict] = []
        self._dropped = 0
        self._flusher_started = False

    @classmethod
    def get(cls) -> "EventBuffer":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = EventBuffer()
            return cls._instance

    def record(self, ev: dict) -> None:
        with self._lock:
            self._recent.append(ev)
            self._pending.append(ev)
            if len(self._pending) > _PENDING_MAX:
                drop = _PENDING_MAX // 2
                del self._pending[:drop]
                self._dropped += drop
        self._ensure_flusher()

    def recent(self, etype: Optional[str] = None) -> List[dict]:
        with self._lock:
            evs = list(self._recent)
        if etype is not None:
            evs = [e for e in evs if e.get("type") == etype]
        return evs

    def drain(self) -> List[dict]:
        with self._lock:
            batch, self._pending = self._pending, []
        return batch

    def _ensure_flusher(self) -> None:
        with self._lock:
            if self._flusher_started:
                return
            self._flusher_started = True
        threading.Thread(
            target=self._flush_loop, daemon=True, name="obs-events-flush"
        ).start()

    def flush_once(self) -> bool:
        """One shipping attempt; returns True when the batch reached the
        GCS (or there was nothing to ship). Unshipped events are
        requeued so a control-plane blip loses nothing. The batch
        carries a sender clock pair so the aggregator can reconcile the
        events' monotonic stamps onto its own timebase."""
        batch = self.drain()
        if not batch:
            return True
        clock = {"mono": time.monotonic(), "wall": time.time()}
        if _local_sink is not None:
            try:
                _local_sink(batch, clock)
                return True
            except Exception:  # noqa: BLE001 — aggregator blip: requeue
                self._requeue(batch)
                return False
        gcs = _gcs_client()
        if gcs is None:
            # no GCS client YET (mid-init) or ever (local mode/detached):
            # requeue so events recorded during the startup window ship
            # once the client appears; _PENDING_MAX bounds the backlog in
            # processes where it never does, and the recent ring keeps
            # them readable locally via local_events() either way
            self._requeue(batch)
            return False
        try:
            gcs.call_oneway("ReportClusterEvents", events=batch,
                            clock=clock)
            return True
        except Exception:  # noqa: BLE001 — GCS blip: requeue
            self._requeue(batch)
            return False

    def _requeue(self, batch: List[dict]) -> None:
        with self._lock:
            self._pending[:0] = batch
            if len(self._pending) > _PENDING_MAX:
                overflow = len(self._pending) - _PENDING_MAX
                del self._pending[:overflow]
                self._dropped += overflow

    def _flush_loop(self) -> None:
        while True:
            time.sleep(_FLUSH_PERIOD_S)
            try:
                self.flush_once()
            except Exception:  # noqa: BLE001 — the bus must never die
                pass


def _process_ident() -> str:
    if _ident_override is not None:
        return _ident_override
    from ray_tpu_torch._private import worker as worker_mod

    w = worker_mod.global_worker
    core = getattr(w, "core", None) if w else None
    return getattr(core, "worker_id_hex", "")[:16] or "detached"


def record_event(etype: str, **fields: Any) -> None:
    """Append one typed event to this process's flight recorder (and the
    next GCS batch). Field conventions: ``job_id`` scopes queries,
    ``ts`` is wall-clock seconds (stamped here when absent)."""
    ev: Dict[str, Any] = {"type": etype, "ts": time.time(),
                          "worker": _process_ident()}
    ev.update(fields)
    EventBuffer.get().record(ev)


def local_events(etype: Optional[str] = None) -> List[dict]:
    """This process's flight-recorder ring (most recent last)."""
    return EventBuffer.get().recent(etype)


def flush() -> bool:
    """Ship pending events now (tests / shutdown hooks)."""
    return EventBuffer.get().flush_once()
