"""Request SLO machinery for the serve front door: deadlines, admission
control, retry policy (copy of ray_tpu/serve/slo.py; reference: the Serve proxy's request lifecycle —
serve/_private/proxy.py timeout handling, backoff in router retries —
plus the load-shedding semantics of production LLM gateways: shed
*before* the first streamed byte, with an honest Retry-After).

Three building blocks, shared by the HTTP and gRPC proxies and the
deployment handle:

* :class:`Deadline` — one absolute monotonic deadline carried from
  ingress through the handle to the replica call. Every wait on the
  request path derives its timeout from the deadline's remaining
  budget; there are no fixed per-hop timeouts left on the serve path.
* :class:`AdmissionController` — a bounded in-flight gate per ingress.
  At capacity, a request waits FIFO for a slot up to the smaller of its
  queue-wait budget and a fraction of its deadline; past that it is
  shed with a retryable signal (HTTP 503 + Retry-After, gRPC
  RESOURCE_EXHAUSTED) *before* any response byte is written.
* :class:`RetryPolicy` — jittered exponential backoff for idempotent
  re-dispatch around dead / draining / saturated replicas. Seeded
  (RC004: chaos runs must be reproducible).

The replica publishes the active request's deadline through a
contextvar (:func:`request_deadline` / :func:`remaining_or`) so code
below the serve layer — batching waits, LLM engine futures — can bound
its own waits by the same budget instead of inventing one.
"""

from __future__ import annotations

import asyncio
import collections
import contextvars
import os
import random
import threading
import time
from typing import Deque, Dict, Optional

from ray_tpu_torch.exceptions import RayTpuError
from ray_tpu_torch.observability import dump as obs_dump

# -- defaults (env-overridable: ops knobs, not API) ---------------------
DEFAULT_TIMEOUT_S = float(os.environ.get(
    "RAY_TPU_SERVE_DEFAULT_TIMEOUT_S", "60.0"))
MAX_TIMEOUT_S = float(os.environ.get(
    "RAY_TPU_SERVE_MAX_TIMEOUT_S", "600.0"))
DEFAULT_MAX_INFLIGHT = int(os.environ.get(
    "RAY_TPU_SERVE_MAX_INFLIGHT", "256"))
DEFAULT_MAX_QUEUE_DEPTH = int(os.environ.get(
    "RAY_TPU_SERVE_MAX_QUEUE_DEPTH", "128"))
DEFAULT_QUEUE_WAIT_S = float(os.environ.get(
    "RAY_TPU_SERVE_QUEUE_WAIT_S", "2.0"))
# of the request's remaining budget, how much may be burned waiting for
# admission (the rest is reserved for actually serving it)
QUEUE_WAIT_DEADLINE_FRACTION = 0.25

# HTTP header carrying the client's per-request budget, in seconds
# (gRPC callers use the native gRPC deadline instead).
TIMEOUT_HEADER = "x-request-timeout-s"


class DeadlineExceededError(RayTpuError, TimeoutError):
    """The request's deadline expired before a result was produced.

    HTTP: 504 + structured JSON body. gRPC: DEADLINE_EXCEEDED."""


class OverloadedError(RayTpuError, RuntimeError):
    """Admission (or every replica) refused the request within its
    queue-wait budget — retryable by the client after ``retry_after_s``.

    HTTP: 503 + Retry-After, *before* the first streamed byte.
    gRPC: RESOURCE_EXHAUSTED. Subclasses RuntimeError: pre-existing
    callers match the handle's overload signal as RuntimeError."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class ReplicasUnavailableError(RayTpuError, ConnectionError):
    """Every retry budget was spent on dead/unreachable replicas (e.g.
    mid-churn with no survivor yet). HTTP: 503. gRPC: UNAVAILABLE."""


class Deadline:
    """Absolute monotonic deadline for one request.

    Created once at ingress and passed by reference; every hop reads
    ``remaining()`` instead of picking its own constant. The wire form
    (:meth:`remaining`) is a *relative* budget — clock-skew safe: the
    replica re-anchors it against its own clock on arrival, so replica
    queue time still counts against the request, while cross-host
    wall-clock offsets do not."""

    __slots__ = ("_at",)

    def __init__(self, timeout_s: float):
        timeout_s = min(float(timeout_s), MAX_TIMEOUT_S)
        self._at = time.monotonic() + timeout_s

    @classmethod
    def from_header(cls, value: Optional[str]) -> "Deadline":
        """Parse the ``x-request-timeout-s`` header value; absent or
        malformed falls back to the proxy default (a malformed budget
        must not grant an unbounded one)."""
        if value:
            try:
                t = float(value)
                if t > 0:
                    return cls(t)
            except (TypeError, ValueError):
                pass
        return cls(DEFAULT_TIMEOUT_S)

    def remaining(self) -> float:
        return self._at - time.monotonic()

    def expired(self) -> bool:
        return time.monotonic() >= self._at

    def remaining_or_raise(self) -> float:
        r = self.remaining()
        if r <= 0:
            raise DeadlineExceededError("request deadline exceeded")
        return r

    def queue_budget(self, cap_s: float) -> float:
        """How long this request may wait for admission: the configured
        cap, bounded by a fraction of what's left of the deadline."""
        return max(0.0, min(cap_s,
                            self.remaining() * QUEUE_WAIT_DEADLINE_FRACTION))

    def __repr__(self) -> str:
        return f"Deadline(remaining={self.remaining():.3f}s)"


# -- replica-side request context --------------------------------------
# Set by Replica.handle_request* around the user callable; read by any
# layer below that needs to bound a wait by the request's budget.
_request_deadline: contextvars.ContextVar[Optional[Deadline]] = \
    contextvars.ContextVar("ray_tpu_serve_request_deadline", default=None)


def request_deadline() -> Optional[Deadline]:
    """The active request's deadline inside a replica (None outside a
    serve request, e.g. unit tests calling the callable directly)."""
    return _request_deadline.get()


def remaining_or(default_s: float) -> float:
    """Remaining budget of the active request, or ``default_s`` when no
    request deadline is in scope. The standard way for engine/batching
    waits to stay deadline-bounded without new plumbing."""
    d = _request_deadline.get()
    if d is None:
        return default_s
    return max(0.001, d.remaining())


def result_within_deadline(fut, default_s: float = MAX_TIMEOUT_S):
    """Resolve a concurrent Future bounded by the active request's
    deadline. A timeout under an ACTIVE deadline is the request's budget
    expiring and surfaces as :class:`DeadlineExceededError` (→ 504 /
    DEADLINE_EXCEEDED at the front door, not a 500) — futures.TimeoutError
    is a distinct class from the builtin on 3.10, so a bare catch at the
    proxy would misfile it as an internal error."""
    import concurrent.futures

    d = _request_deadline.get()
    try:
        return fut.result(timeout=remaining_or(default_s))
    except (TimeoutError, concurrent.futures.TimeoutError):
        if d is not None:
            raise DeadlineExceededError(
                "request deadline exceeded while waiting for the "
                "result") from None
        raise


class _Waiter:
    """One queued admission request: woken either by a freed slot
    (thread or loop, whichever side queued it) or by its own timeout."""

    __slots__ = ("event", "loop", "future", "admitted")

    def __init__(self, loop: Optional[asyncio.AbstractEventLoop]):
        self.loop = loop
        self.admitted = False
        if loop is None:
            self.event: Optional[threading.Event] = threading.Event()
            self.future: Optional[asyncio.Future] = None
        else:
            self.event = None
            self.future = loop.create_future()

    def wake(self) -> None:
        if self.loop is None:
            self.event.set()
        else:
            def _set():
                if not self.future.done():
                    self.future.set_result(True)
            self.loop.call_soon_threadsafe(_set)


class AdmissionController:
    """Bounded in-flight gate with a FIFO wait queue and shed-on-budget.

    ``try_admit`` (async, for the HTTP proxy loop) and ``admit`` (sync,
    for gRPC worker threads) share one counter and one FIFO, so mixed
    ingress load is shed fairly. Shedding raises :class:`OverloadedError`
    with an honest ``retry_after_s`` derived from current depth."""

    def __init__(self, max_inflight: int = DEFAULT_MAX_INFLIGHT,
                 max_queue_depth: int = DEFAULT_MAX_QUEUE_DEPTH,
                 queue_wait_s: float = DEFAULT_QUEUE_WAIT_S):
        self.max_inflight = int(max_inflight)
        self.max_queue_depth = int(max_queue_depth)
        self.queue_wait_s = float(queue_wait_s)
        self._lock = threading.Lock()
        self._inflight = 0
        self._queue: Deque[_Waiter] = collections.deque()
        # counters for stats()/bench — monotonically increasing
        self._admitted = 0
        self._shed_depth = 0      # refused instantly: wait queue full
        self._shed_timeout = 0    # queued but no slot within budget
        self._queued = 0
        self._peak_inflight = 0

    # -- slot bookkeeping ----------------------------------------------
    def _try_acquire_locked(self) -> bool:
        if self._inflight < self.max_inflight:
            self._inflight += 1
            self._peak_inflight = max(self._peak_inflight, self._inflight)
            self._admitted += 1
            return True
        return False

    def release(self) -> None:
        """Free one slot and hand it to the oldest live waiter."""
        wake: Optional[_Waiter] = None
        with self._lock:
            self._inflight -= 1
            while self._queue:
                w = self._queue.popleft()
                if w.admitted:
                    continue  # already timed out and gave up
                w.admitted = True
                self._inflight += 1
                self._peak_inflight = max(self._peak_inflight,
                                          self._inflight)
                self._admitted += 1
                wake = w
                break
        if wake is not None:
            wake.wake()

    def _enqueue(self, w: _Waiter, deadline: Deadline) -> float:
        """Admit now, queue, or shed-by-depth. Returns the wait budget
        (>0) when queued; raises OverloadedError on instant shed; 0.0
        means admitted without waiting."""
        with self._lock:
            if self._try_acquire_locked():
                return 0.0
            if len(self._queue) >= self.max_queue_depth:
                self._shed_depth += 1
                self._sample_shed_locked()
                raise OverloadedError(
                    f"admission queue full "
                    f"({self.max_inflight} in flight, "
                    f"{len(self._queue)} queued)",
                    retry_after_s=self._retry_after_locked())
            budget = deadline.queue_budget(self.queue_wait_s)
            if budget <= 0:
                self._shed_timeout += 1
                self._sample_shed_locked()
                raise OverloadedError(
                    "no admission budget left in the request deadline",
                    retry_after_s=self._retry_after_locked())
            self._queue.append(w)
            self._queued += 1
            return budget

    def _give_up(self, w: _Waiter) -> bool:
        """Waiter timed out. Returns True if it had actually been
        admitted concurrently (keep the slot), False if shed."""
        with self._lock:
            if w.admitted:
                return True
            w.admitted = True  # tombstone: release() skips it
            self._shed_timeout += 1
            self._sample_shed_locked()
            return False

    def _sample_shed_locked(self) -> None:
        """One point on the flight-recorder's shed counter track per
        shed decision (deque append — safe under self._lock)."""
        try:
            obs_dump.counter_sample(
                "serve_shed_total",
                self._shed_depth + self._shed_timeout)
            obs_dump.counter_sample("serve_inflight", self._inflight)
        except Exception:  # noqa: BLE001 — diagnostics never shed harder
            pass

    def _retry_after_locked(self) -> float:
        # depth-proportional hint, capped: a client that honors it
        # arrives when roughly one queue's worth of work has cleared
        return round(min(10.0, 0.25 + 0.05 * len(self._queue)), 2)

    # -- entry points --------------------------------------------------
    async def try_admit(self, deadline: Deadline) -> None:
        """Async admission for proxy-loop callers; raises
        OverloadedError on shed, returns on admit (caller must
        ``release()`` exactly once)."""
        w = _Waiter(asyncio.get_event_loop())
        budget = self._enqueue(w, deadline)
        if budget == 0.0:
            return
        try:
            await asyncio.wait_for(asyncio.shield(w.future), timeout=budget)
            return
        except asyncio.TimeoutError:
            if self._give_up(w):
                return  # slot arrived in the race window — keep it
            raise OverloadedError(
                f"no capacity within the {budget:.2f}s queue-wait budget",
                retry_after_s=self._retry_after_locked()) from None

    def admit(self, deadline: Deadline) -> None:
        """Sync admission for gRPC worker threads; same contract."""
        w = _Waiter(None)
        budget = self._enqueue(w, deadline)
        if budget == 0.0:
            return
        if w.event.wait(timeout=budget):
            return
        if self._give_up(w):
            return
        raise OverloadedError(
            f"no capacity within the {budget:.2f}s queue-wait budget",
            retry_after_s=self._retry_after_locked())

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "inflight": self._inflight,
                "peak_inflight": self._peak_inflight,
                "queued_now": len(self._queue),
                "admitted": self._admitted,
                "queued_total": self._queued,
                "shed_depth": self._shed_depth,
                "shed_timeout": self._shed_timeout,
            }


class RetryPolicy:
    """Jittered exponential backoff for idempotent re-dispatch.

    One instance per proxy/handle; seeded so chaos/soak runs replay
    (RC004). ``backoff(attempt)`` returns the sleep before attempt N
    (0-based first retry), full-jittered: U(0.5, 1.0) * base * 2^N,
    capped. ``max_attempts`` bounds replica-death re-dispatch — sheds as
    ReplicasUnavailableError after that."""

    def __init__(self, base_s: float = 0.02, cap_s: float = 0.5,
                 max_attempts: int = 4, seed: int = 0):
        self.base_s = base_s
        self.cap_s = cap_s
        self.max_attempts = max_attempts
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    def backoff(self, attempt: int) -> float:
        with self._lock:  # random.Random is not thread-safe under races
            jitter = 0.5 + 0.5 * self._rng.random()
        return min(self.cap_s, self.base_s * (2 ** attempt)) * jitter


# -- structured error bodies (HTTP) ------------------------------------
def error_body(code: str, message: str, *,
               retry_after_s: Optional[float] = None,
               terminal: bool = False) -> dict:
    """The one JSON error shape the front door speaks — unary bodies and
    stream terminal frames alike::

        {"error": {"code": "deadline_exceeded", "message": "...",
                   "retryable": false}}

    ``terminal=True`` marks a mid-stream terminal frame (the stream ends
    right after it; the documented replica-death/deadline contract)."""
    err: Dict[str, object] = {
        "code": code,
        "message": message,
        "retryable": retry_after_s is not None,
    }
    if retry_after_s is not None:
        err["retry_after_s"] = retry_after_s
    body: Dict[str, object] = {"error": err}
    if terminal:
        body["terminal"] = True
    return body
