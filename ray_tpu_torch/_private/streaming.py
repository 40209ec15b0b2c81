"""Streaming generators: consume a task's yields while it still runs (copy of
ray_tpu/_private/streaming.py).

Reference: streaming-generator returns in src/ray/core_worker/
task_manager.cc:778 (HandleReportGeneratorItemReturns) and
python/ray/_raylet.pyx ObjectRefGenerator — re-designed for the pickle-RPC
runtime: the executing worker pushes one ``StreamingYield`` RPC per yielded
value to the caller (inline payload or a plasma location), then
``StreamingDone``; the caller-side ``ObjectRefGenerator`` hands out
ObjectRefs in yield order as they arrive.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, TYPE_CHECKING

from ray_tpu_torch._private.ids import ObjectID, TaskID
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch.exceptions import GetTimeoutError

if TYPE_CHECKING:  # pragma: no cover
    from ray_tpu_torch._private.core_worker import CoreWorker


class StreamEnd(Exception):
    """Async end-of-stream marker: ``anext_ref`` cannot raise
    StopIteration (PEP 479 turns it into a bare RuntimeError inside a
    coroutine), so exhaustion surfaces as this instead."""


class _StreamState:
    """Caller-side bookkeeping for one streaming task."""

    def __init__(self) -> None:
        self.cv = threading.Condition()
        self.arrived: Dict[int, ObjectID] = {}  # yield index -> oid
        self.next_index = 0  # next index to hand to the consumer
        self.total: Optional[int] = None  # set by StreamingDone
        self.error: Optional[BaseException] = None
        # async consumers (the serve proxy loop) park a thread-safe
        # waker here instead of blocking a thread on the cv; fired on
        # every state change alongside the cv notify
        self.wakers: List[Callable[[], None]] = []

    def notify_locked(self) -> None:
        """State changed (yield arrived / done / error / abandon): wake
        every consumer. Must be called with ``cv`` held. Wakers are
        drained — an async consumer re-registers per wait."""
        self.cv.notify_all()
        wakers, self.wakers = self.wakers, []
        for w in wakers:
            try:
                w()
            except Exception:  # noqa: BLE001 — a dead consumer loop
                pass  # must not break delivery to the live ones


class ObjectRefGenerator:
    """Iterator over a streaming task's yields (reference:
    python/ray/_raylet.pyx ObjectRefGenerator). Each ``__next__`` returns
    an ObjectRef as soon as that yield has been produced — the task may
    still be running."""

    def __init__(self, core: "CoreWorker", task_id: TaskID, state: _StreamState):
        self._core = core
        self._task_id = task_id
        self._state = state
        self._close_cb = None
        self._close_fired = False

    def _set_close_callback(self, cb) -> None:
        """Invoked exactly once when the stream terminates (exhausted,
        errored, or dropped) — e.g. Serve uses it to release the routing
        slot the stream occupies."""
        self._close_cb = cb

    def _fire_close(self) -> None:
        if self._close_fired:
            return
        self._close_fired = True
        if self._close_cb is not None:
            try:
                self._close_cb()
            except Exception:  # noqa: BLE001
                pass

    def __iter__(self) -> "ObjectRefGenerator":
        return self

    def __next__(self) -> ObjectRef:
        return self._next(timeout=None)

    def next_ref(self, timeout: Optional[float] = None) -> ObjectRef:
        """Like ``next()`` but with a timeout (raises GetTimeoutError)."""
        return self._next(timeout=timeout)

    def _take_locked(self) -> Optional[ObjectRef]:
        """One non-blocking state inspection (``st.cv`` held): returns
        the next ref, raises the stream's terminal error/StopIteration,
        or returns None when the consumer must wait."""
        st = self._state
        if st.next_index in st.arrived:
            oid = st.arrived.pop(st.next_index)
            st.next_index += 1
            return ObjectRef(oid, owner_addr=self._core.address)
        if st.error is not None:
            self._core._streams.pop(self._task_id, None)
            self._fire_close()
            raise st.error
        if st.total is not None and st.next_index >= st.total:
            self._core._streams.pop(self._task_id, None)
            self._fire_close()
            raise StopIteration
        return None

    def _next(self, timeout: Optional[float]) -> ObjectRef:
        st = self._state
        deadline = None if timeout is None else time.monotonic() + timeout
        with st.cv:
            while True:
                ref = self._take_locked()
                if ref is not None:
                    return ref
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise GetTimeoutError(
                        f"no yield from streaming task {self._task_id.hex()[:12]} in time"
                    )
                st.cv.wait(timeout=remaining if remaining is not None else 1.0)

    async def anext_ref(self, timeout: Optional[float] = None) -> ObjectRef:
        """Async ``next_ref``: waits on the consumer's event loop without
        parking a thread per stream (the serve proxy serves hundreds of
        concurrent streams off one loop). Raises GetTimeoutError on
        timeout and :class:`StreamEnd` on exhaustion (StopIteration
        cannot cross a coroutine boundary)."""
        import asyncio

        st = self._state
        loop = asyncio.get_event_loop()
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with st.cv:
                try:
                    ref = self._take_locked()
                except StopIteration:
                    raise StreamEnd() from None
                if ref is not None:
                    return ref
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise GetTimeoutError(
                        f"no yield from streaming task "
                        f"{self._task_id.hex()[:12]} in time")
                fut = loop.create_future()

                def _wake(fut=fut):
                    def _set():
                        if not fut.done():
                            fut.set_result(True)
                    loop.call_soon_threadsafe(_set)

                st.wakers.append(_wake)
            try:
                # bounded re-check even with no deadline: a waker lost to
                # a dying producer must not hang the consumer forever
                await asyncio.wait_for(
                    fut, timeout=min(remaining, 1.0)
                    if remaining is not None else 1.0)
            except asyncio.TimeoutError:
                pass  # loop re-checks state / deadline

    def completed(self) -> bool:
        st = self._state
        with st.cv:
            return st.error is not None or (
                st.total is not None and st.next_index >= st.total
            )

    def __del__(self):
        # dropping the generator abandons the stream: undelivered yields
        # are freed and the producer's next push is refused (the worker
        # then stops producing) — without this a dropped generator pins
        # every yield for the life of the driver
        try:
            self._fire_close()
            abandon = getattr(self._core, "_abandon_stream", None)
            if abandon is not None:
                abandon(self._task_id)
        except Exception:  # noqa: BLE001 — GC context
            pass

    def __repr__(self) -> str:
        return f"ObjectRefGenerator(task={self._task_id.hex()[:12]})"
