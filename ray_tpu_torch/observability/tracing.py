"""Distributed tracing: span contexts that cross process boundaries (copy of
ray_tpu/observability/tracing.py).

Reference: OpenTelemetry-style context propagation grafted onto the
task path the way the reference pipes serialized runtime contexts
through task specs (core_worker.cc task spec builder). A span context
``(trace_id, span_id, job_id, sampled)`` rides task-spec payloads and
actor submits; the executor re-activates it around user code, so the
worker-side span's ``parent_span_id`` is the caller's active span —
across processes and nodes.

Sampling + off-by-default: ``configure(enabled=True, sample_rate=p)``
(or ``RAY_TPU_TRACE=1``) turns the driver into a root sampler. Worker
processes need no configuration — an inherited SAMPLED context forces
span recording there, an unsampled/absent context costs one
thread-local read. Finished spans are events on the bus
(``events.py``) and flow to the GCS aggregator.
"""

from __future__ import annotations

import contextlib
import os
import random
import threading
import time
import uuid
from typing import Any, Dict, Iterator, Optional, Tuple

from ray_tpu_torch.observability import events as _events

_state = threading.local()

_config = {
    "enabled": os.environ.get("RAY_TPU_TRACE", "0").lower()
    not in ("0", "", "false"),
    "sample_rate": float(os.environ.get("RAY_TPU_TRACE_SAMPLE", "1.0")),
}

# Root sampling uses a dedicated Random instance, NOT the process-global
# random module: a seeded chaos run (PreemptionInjector) must not have
# its injection schedule perturbed by trace sampling, and the sampling
# itself becomes reproducible via seed_sampler()/RAY_TPU_TRACE_SEED.
_sampler = random.Random(
    int(os.environ["RAY_TPU_TRACE_SEED"])
    if os.environ.get("RAY_TPU_TRACE_SEED", "").isdigit() else None)


def seed_sampler(seed: int) -> None:
    """Make root-span sampling decisions reproducible (chaos tests)."""
    _sampler.seed(seed)


# spans currently open (sampled only): span_id -> start record. Bounded
# by the live call depth across threads; dump.py snapshots it so a
# postmortem sees what every process was INSIDE when it died.
_active_lock = threading.Lock()
_active: Dict[str, dict] = {}


def active_spans() -> list:
    """Open sampled spans at this instant (for flight-recorder dumps)."""
    with _active_lock:
        return [dict(v) for v in _active.values()]

# wire form: (trace_id, span_id, job_id, sampled) — a plain tuple so it
# rides msgpack/pickle payloads without a custom serializer
Wire = Tuple[str, str, str, bool]


class TraceContext:
    __slots__ = ("trace_id", "span_id", "job_id", "sampled")

    def __init__(self, trace_id: str, span_id: str, job_id: str = "",
                 sampled: bool = True):
        self.trace_id = trace_id
        self.span_id = span_id
        self.job_id = job_id
        self.sampled = sampled

    def to_wire(self) -> Wire:
        return (self.trace_id, self.span_id, self.job_id, self.sampled)

    @classmethod
    def from_wire(cls, wire) -> Optional["TraceContext"]:
        if not wire:
            return None
        t, s, j, sampled = wire
        return cls(t, s, j, bool(sampled))

    def __repr__(self) -> str:
        return (f"TraceContext({self.trace_id[:8]}../{self.span_id[:8]}..,"
                f" sampled={self.sampled})")


def configure(enabled: Optional[bool] = None,
              sample_rate: Optional[float] = None) -> None:
    """Per-process tracing switch (driver-side; workers inherit via
    propagated contexts). ``sample_rate`` applies to ROOT spans only —
    a sampled trace stays sampled end to end."""
    if enabled is not None:
        _config["enabled"] = bool(enabled)
    if sample_rate is not None:
        _config["sample_rate"] = min(1.0, max(0.0, float(sample_rate)))


def enabled() -> bool:
    return _config["enabled"]


def active() -> bool:
    """True when this thread should record bus events: tracing enabled
    in THIS process (the driver, via configure()/RAY_TPU_TRACE) or a
    sampled span context inherited from a caller. Worker processes are
    never configure()d — during a traced task execution the inbound
    span is what turns their task_state/object event recording on, so
    the executor-side data the flight recorder promises isn't silently
    missing. Same hot-path cost as for_outbound(): one thread-local
    getattr, then one dict read."""
    ctx = getattr(_state, "ctx", None)
    if ctx is not None and ctx.sampled:
        return True
    return _config["enabled"]


def current_context() -> Optional[TraceContext]:
    return getattr(_state, "ctx", None)


def for_outbound() -> Optional[Wire]:
    """Wire context to attach to an outgoing task/actor submit, or None.

    This IS the hot-path check: with tracing disabled and no inherited
    span it is one thread-local getattr + one dict read."""
    ctx = getattr(_state, "ctx", None)
    if ctx is not None and ctx.sampled:
        return ctx.to_wire()
    return None


def _job_id_hex() -> str:
    from ray_tpu_torch._private import worker as worker_mod

    w = worker_mod.global_worker
    if w is None:
        return ""
    try:
        return w.job_id.hex()
    except Exception:  # noqa: BLE001
        return ""


def _record_span(ctx: TraceContext, parent_span_id: str, name: str,
                 kind: str, ts: float, dur: float, status: str,
                 attrs: Optional[Dict[str, Any]]) -> None:
    _events.record_event(
        "span",
        trace_id=ctx.trace_id,
        span_id=ctx.span_id,
        parent_span_id=parent_span_id,
        name=name,
        kind=kind,
        job_id=ctx.job_id,
        ts=ts,
        dur=dur,
        status=status,
        attrs=dict(attrs) if attrs else {},
    )


@contextlib.contextmanager
def span(name: str, kind: str = "span",
         attrs: Optional[Dict[str, Any]] = None) -> Iterator[
             Optional[TraceContext]]:
    """Open a span. Yields the active TraceContext, or None when the
    call chain is untraced (disabled and no inherited context) — then
    the only cost is the checks above this line.

    Roots: created when tracing is enabled here and no span is active;
    subject to the sample rate. Children: inherit trace/job ids from
    the active span regardless of this process's own config (that's
    what carries a trace across process boundaries)."""
    parent = getattr(_state, "ctx", None)
    if parent is None:
        if not _config["enabled"]:
            yield None
            return
        if _config["sample_rate"] < 1.0 \
                and _sampler.random() >= _config["sample_rate"]:
            yield None
            return
        trace_id = uuid.uuid4().hex
        parent_span_id = ""
        job_id = _job_id_hex()
    else:
        if not parent.sampled:
            yield None
            return
        trace_id = parent.trace_id
        parent_span_id = parent.span_id
        job_id = parent.job_id
    ctx = TraceContext(trace_id, uuid.uuid4().hex[:16], job_id, True)
    _state.ctx = ctx
    ts = time.time()
    t0 = time.monotonic()
    status = "ok"
    with _active_lock:
        _active[ctx.span_id] = {"span_id": ctx.span_id,
                                "trace_id": trace_id, "name": name,
                                "kind": kind, "ts": ts,
                                "parent_span_id": parent_span_id}
    try:
        yield ctx
    except BaseException:
        status = "error"
        raise
    finally:
        _state.ctx = parent
        with _active_lock:
            _active.pop(ctx.span_id, None)
        _record_span(ctx, parent_span_id, name, kind, ts,
                     time.monotonic() - t0, status, attrs)


def record_span(name: str, kind: str, ts: float, dur: float,
                status: str = "ok",
                attrs: Optional[Dict[str, Any]] = None) -> None:
    """Record an already-completed span with explicit timing, parented
    to the ACTIVE context (for after-the-fact spans like train.step,
    where the interval is only known at its end). No active sampled
    context → no-op. This is the one producer of span-event records
    besides span() itself — both funnel through _record_span so the
    schema has a single owner."""
    parent = getattr(_state, "ctx", None)
    if parent is None or not parent.sampled:
        return
    ctx = TraceContext(parent.trace_id, uuid.uuid4().hex[:16],
                       parent.job_id, True)
    _record_span(ctx, parent.span_id, name, kind, ts, dur, status, attrs)


@contextlib.contextmanager
def activated(wire) -> Iterator[Optional[TraceContext]]:
    """Executor side: activate a propagated wire context for a scope.
    Covers MORE than the user-code span — while active, the worker's
    bus-event gates (``active()``) record task state transitions and
    object put/get around the execution too. No wire context (or
    unsampled) → plain passthrough; the executor never pays for tracing
    nobody asked for."""
    ctx = TraceContext.from_wire(wire)
    if ctx is None or not ctx.sampled:
        yield None
        return
    prev = getattr(_state, "ctx", None)
    _state.ctx = ctx
    try:
        yield ctx
    finally:
        _state.ctx = prev


@contextlib.contextmanager
def inbound_span(wire, name: str, kind: str,
                 attrs: Optional[Dict[str, Any]] = None) -> Iterator[
                     Optional[TraceContext]]:
    """activated() + a child span around the task body, in one step."""
    with activated(wire):
        with span(name, kind=kind, attrs=attrs) as s:
            yield s
