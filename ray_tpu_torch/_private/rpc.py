"""Asyncio RPC layer: length-prefixed pickle frames over TCP (copy of
ray_tpu/_private/rpc.py).

Reference analogue: src/ray/rpc/ (GrpcServer grpc_server.h:93,
ClientCallManager client_call.h:61, RetryableGrpcClient) — rebuilt on
asyncio instead of gRPC/protobuf for the Python control plane; the wire
format is a 4-byte length + 1-byte flags + pickle body. Includes the
reference's RPC fault-injection hook (rpc_chaos.h:8) driven by the
``testing_rpc_failure`` config flag ("method=prob" comma list).

Frame layout:
    request:  [u64 call_id][u8 kind][pickle (method, kwargs)]
    response: [u64 call_id][u8 kind][pickle (ok, payload)]
kind: 0 = request, 1 = response, 2 = oneway (no response expected).
The high bit of ``kind`` (0x80) flags an out-of-band framed body:
    [u32 meta_len][meta pickle][u32 nbuffers][u64 len, raw bytes]...
where the payload buffers were captured by the pickle-5 buffer callback
and travel as zero-copy views — large numpy/bytes payloads are never
joined into one bytes object on the send side. Receive-side contract:
out-of-band payloads (buffers >= 4 KiB) reconstruct as READ-ONLY arrays
viewing the frame buffer (np.copy() to mutate); sub-4KiB buffers stay
in-band and arrive writable as before.

Framing fast path: header + body + out-of-band buffers reach the socket
through gather writes (no concatenation of large segments), and small
frames queued within one event-loop tick coalesce into a single
transport write.
"""

from __future__ import annotations

import asyncio
import logging
import pickle
import random
import struct
import sys
import threading
import time
from collections import deque
from typing import Any, Awaitable, Callable, Dict, Optional, Tuple

from ray_tpu_torch._private import debug_locks, fastpath
from ray_tpu_torch._private.config import config

logger = logging.getLogger(__name__)

KIND_REQUEST = 0
KIND_RESPONSE = 1
KIND_ONEWAY = 2
# flag bit on ``kind``: body uses the meta + out-of-band buffer framing
KIND_OOB_FLAG = 0x80
KIND_MASK = 0x7F

_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")

# Event-loop lag flight recorder: dispatches that measurably held the
# loop (the same loop_held the slow-handler warning uses) land in a
# bounded ring, so a failure dump can show WHEN the control plane's
# loop was stalled and by which method — not just that a warning once
# scrolled by. ~1 ms floor keeps the ring to genuinely interesting
# samples; a deque append is cheap enough for the dispatch path.
_LOOP_LAG_MIN_S = 0.001
_loop_lag: deque = deque(maxlen=2048)


def _note_loop_held(server: str, method: str, held_s: float,
                    wall_s: float) -> None:
    _loop_lag.append((time.time(), server, method,
                      round(held_s * 1000.0, 3),
                      round(wall_s * 1000.0, 3)))


def loop_lag_samples() -> list:
    """Recent loop-held samples: [{ts, server, method, held_ms, wall_ms}]."""
    return [{"ts": t, "server": s, "method": m, "held_ms": h,
             "wall_ms": w} for (t, s, m, h, w) in list(_loop_lag)]

# Frames at or below this size coalesce: queued per-writer and flushed in
# one transport write at the end of the current event-loop tick, so a
# burst of small frames (actor-task batches, acks) costs one syscall.
_SMALL_FRAME_MAX = 8192
# Segments at least this large are handed to the transport as views (no
# concatenation); smaller neighbours are joined to bound syscall count.
_GATHER_CUTOFF = 32 * 1024
# Bodies above this size are pickled/unpickled on the executor, not the
# event loop, so one fat CreateActor/PushTask payload cannot stall every
# connection sharing the loop.
_LOOP_DECODE_MAX = 256 * 1024


class RpcError(Exception):
    pass


class RpcConnectionError(RpcError, ConnectionError):
    pass


class RemoteError(RpcError):
    """Handler raised; carries the remote traceback string."""

    def __init__(self, message: str):
        super().__init__(message)


def _chaos_action(method: str) -> Optional[str]:
    """Parse ``testing_rpc_failure`` and roll the dice for one call.

    Spec: comma list of ``Method=prob[:kind]`` where kind is
    ``request`` (drop before the handler runs — the default),
    ``response`` (handler runs, reply is dropped — side effects happen,
    the caller sees a timeout), ``delay:<ms>`` (in-flight latency), or a
    bare number — ``Method=prob:delay_ms`` — which is shorthand for the
    delay kind (latency injection, not a failure). Mirrors the
    reference's Request/Response/InFlight failure kinds
    (src/ray/rpc/rpc_chaos.h:8).
    """
    spec = config.testing_rpc_failure
    if not spec:
        return None
    for part in spec.split(","):
        if "=" not in part:
            continue
        name, rest = part.split("=", 1)
        if name != method and name != "*":
            continue
        bits = rest.split(":", 1)
        try:
            prob = float(bits[0])
        except ValueError:
            return None
        if random.random() >= prob:
            return None
        if len(bits) == 1:
            return "request"
        kind = bits[1]
        try:
            return f"delay:{float(kind):g}"  # Method=prob:delay_ms form
        except ValueError:
            return kind
    return None


async def _read_frame(reader: asyncio.StreamReader) -> Tuple[int, int, bytes]:
    header = await reader.readexactly(13)
    length, call_id, kind = fastpath.unpack_header(header)
    body = await reader.readexactly(length)
    return call_id, kind, body


# buffers below this stay IN-band: they arrive writable (old semantics)
# and a tiny out-of-band segment saves nothing
_OOB_MIN_BYTES = 4096


def _encode_body(obj: Any) -> Tuple[int, list, int]:
    """Pickle an RPC body. LARGE buffer-protocol payloads (numpy arrays,
    ...) are captured by the pickle-5 buffer callback and stay OUT OF
    BAND as zero-copy view segments; sub-4KiB buffers serialize in-band
    (writable on receipt, as before). Returns (kind_flags, segments,
    total_len).

    NOTE the wire layout below deliberately mirrors
    serialization.SerializedValue.segments() / deserialize() — if one
    grows a header field or alignment padding, change both."""
    bufs: list = []

    def _cb(b: pickle.PickleBuffer):
        if b.raw().nbytes < _OOB_MIN_BYTES:
            return True  # truthy = pickle keeps the buffer in-band
        bufs.append(b)
        return False

    meta = pickle.dumps(obj, protocol=5, buffer_callback=_cb)
    if not bufs:
        return 0, [meta], len(meta)
    raws: list = []
    total = 8 + len(meta)
    for b in bufs:
        raw = b.raw()
        if raw.ndim != 1 or raw.format != "B":
            raw = raw.cast("B")
        raws.append(raw)
        total += 8 + raw.nbytes
    if total <= _GATHER_CUTOFF:
        # small OOB body: the coalescing sink would copy each borrowed
        # segment to owned bytes anyway — one codec pass builds the
        # whole owned body instead (fastpath.encode_body, native when
        # the extension is loaded)
        return KIND_OOB_FLAG, [fastpath.encode_body(meta, raws)], total
    segs: list = [_U32.pack(len(meta)), meta, _U32.pack(len(raws))]
    for raw in raws:
        segs.append(_U64.pack(raw.nbytes))
        segs.append(raw)
    return KIND_OOB_FLAG, segs, total


def _decode_body(kind: int, body: bytes) -> Any:
    """Inverse of _encode_body; out-of-band buffers are zero-copy views
    into the received body (fastpath codec: one native parse pass)."""
    if not kind & KIND_OOB_FLAG:
        return pickle.loads(body)
    meta, buffers = fastpath.decode_body(body)
    return pickle.loads(meta, buffers=buffers)


class _FrameSink:
    """Per-connection gather-write sink.

    The FIRST frame of an event-loop tick writes through immediately (a
    lone latency-sensitive call pays zero batching delay); small frames
    that follow in the SAME tick coalesce and go out as one transport
    write at tick end — a burst of N small frames (actor-task batches,
    acks) costs 2 syscalls instead of N. Large frames always write
    through, vectored: the header and sub-cutoff segments join into one
    small write, every large segment is handed to the transport as a
    view, uncopied.

    Borrow safety: on CPython <3.12 ``transport.write`` consumes data
    synchronously (sent, or copied into the transport's bytearray), so
    borrowed views are safe to mutate once write_frame returns. 3.12+
    selector transports may retain the view object in their write deque
    under backpressure, so there large segments are materialized before
    handoff — costs the one copy the old concatenating path always paid,
    only under backpressure-capable interpreters."""

    _WRITE_CONSUMES_VIEWS = sys.version_info < (3, 12)

    __slots__ = ("writer", "_small", "_tick_armed")

    def __init__(self, writer: asyncio.StreamWriter):
        self.writer = writer
        self._small: list = []
        self._tick_armed = False

    def write_frame(self, call_id: int, kind: int, segs: list, total: int) -> None:
        first = not self._tick_armed
        if first:
            self._tick_armed = True
            asyncio.get_event_loop().call_soon(self._end_tick)
        if total <= _SMALL_FRAME_MAX and len(segs) == 1:
            # single-segment small frame (plain pickle body, or an OOB
            # body already joined by the codec): header + body assemble
            # in ONE fastpath allocation — owned bytes, so it is safe
            # both to coalesce and to hand to the transport directly
            frame = fastpath.build_frame(call_id, kind, segs[0])
            if first:
                self._flush_small()
                self.writer.write(frame)
            else:
                self._small.append(frame)
            return
        header = fastpath.pack_header(total, call_id, kind)
        if total <= _SMALL_FRAME_MAX and not first:
            # follower in this tick: coalesce. Segments must be owned
            # bytes, not borrowed views (caller may mutate after return).
            self._small.append(header)
            for s in segs:
                self._small.append(s if isinstance(s, bytes) else bytes(s))
            return
        self._flush_small()  # ordering: queued frames go out first
        acc: list = [header]
        for s in segs:
            n = len(s) if isinstance(s, bytes) else s.nbytes
            if n >= _GATHER_CUTOFF:
                if acc:
                    self.writer.write(b"".join(acc))
                    acc = []
                if not isinstance(s, bytes) and not self._WRITE_CONSUMES_VIEWS:
                    s = bytes(s)  # 3.12+: transport may retain the view
                self.writer.write(s)
            else:
                acc.append(s if isinstance(s, bytes) else bytes(s))
        if acc:
            self.writer.write(b"".join(acc))

    def _end_tick(self) -> None:
        self._tick_armed = False
        self._flush_small()

    def _flush_small(self) -> None:
        if not self._small:
            return
        data = b"".join(self._small)
        self._small.clear()
        try:
            self.writer.write(data)
        except Exception:  # noqa: BLE001 — connection already torn down
            pass


def _sink(writer: asyncio.StreamWriter) -> _FrameSink:
    s = getattr(writer, "_rt_sink", None)
    if s is None:
        s = writer._rt_sink = _FrameSink(writer)
    return s


def _send_frame(writer: asyncio.StreamWriter, call_id: int, kind: int, obj: Any) -> None:
    flags, segs, total = _encode_body(obj)
    _sink(writer).write_frame(call_id, kind | flags, segs, total)


class EventLoopThread:
    """A dedicated asyncio loop running on a daemon thread.

    Reference analogue: instrumented_io_context — each component runs its
    handlers on one loop; we record per-handler latency the same way.
    """

    _singleton: Optional["EventLoopThread"] = None
    _singleton_lock = threading.Lock()

    def __init__(self, name: str = "rpc-io"):
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._started = threading.Event()
        self._thread.start()
        self._started.wait()

    @classmethod
    def get_global(cls) -> "EventLoopThread":
        with cls._singleton_lock:
            if cls._singleton is None or not cls._singleton._thread.is_alive():
                cls._singleton = cls("rpc-io-global")
            return cls._singleton

    def _run(self) -> None:
        asyncio.set_event_loop(self.loop)
        # big default executor: sync handlers (task execution, owner object
        # serving) block threads, and nested tasks must not starve the pool
        from concurrent.futures import ThreadPoolExecutor

        self.loop.set_default_executor(ThreadPoolExecutor(max_workers=128, thread_name_prefix="rpc-exec"))
        self._started.set()
        self.loop.run_forever()

    def run_coro(self, coro: Awaitable, timeout: Optional[float] = None) -> Any:
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        return fut.result(timeout)

    def call_soon(self, cb: Callable, *args) -> None:
        self.loop.call_soon_threadsafe(cb, *args)

    def stop(self) -> None:
        self.loop.call_soon_threadsafe(self.loop.stop)
        # reap the loop thread (bounded: run_forever returns right after
        # the stop above is processed); self-stop from a loop callback
        # must not join itself
        if threading.current_thread() is not self._thread:
            self._thread.join(timeout=5)


class LoopHandle:
    """EventLoopThread-shaped handle for a loop the CALLING process
    already runs on its main thread (the gcs/raylet asyncio daemons).

    An RpcClient bound to this handle does its connection I/O on the
    daemon's own loop, so ``acall`` from a handler coroutine runs
    in-line — the default global EventLoopThread would put every
    outbound control RPC through two cross-thread handoffs (submit +
    wakeup), which on a 1-core host is a large slice of lease-grant and
    actor-creation latency."""

    def __init__(self, loop: asyncio.AbstractEventLoop):
        self.loop = loop

    def run_coro(self, coro: Awaitable, timeout: Optional[float] = None) -> Any:
        """Foreign-thread entry (sync .call paths); never call from the
        owning loop itself — that would deadlock the loop on its result."""
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        return fut.result(timeout)

    def call_soon(self, cb: Callable, *args) -> None:
        self.loop.call_soon_threadsafe(cb, *args)


class RpcServer:
    """Serve registered handlers. Handlers may be sync or async; they run on
    the server's event loop (async) or a thread pool (sync)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, name: str = "rpc"):
        self.host = host
        self.port = port
        self.name = name
        self._handlers: Dict[str, Callable] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self._loop_thread: Optional[EventLoopThread] = None
        self._handler_stats: Dict[str, Tuple[int, float]] = {}
        # awaited after each handler, before its response frame is sent.
        # The GCS hangs its WAL group-commit barrier here: handlers
        # append durable records without fsync, and one fsync covers
        # every record appended by the batch of handlers that completed
        # this tick — durability-before-ack without a disk sync per
        # mutation.
        self.pre_response: Optional[Callable[[], Awaitable[None]]] = None
        # methods that legitimately park for their whole timeout (pubsub
        # long-polls): exempt from the slow-async-handler warning
        self._long_poll: set = set()
        # sync handlers cheap enough to run ON the loop (queue append,
        # memory-store put, dict bookkeeping): skipping the executor
        # handoff saves two thread hops per call — on a 1-core host that
        # is a large slice of small-RPC latency. Inline time counts as
        # loop-held, so the slow-handler warning polices the choice.
        self._inline: set = set()

    def register(self, method: str, handler: Callable,
                 long_poll: bool = False, inline: bool = False) -> None:
        self._handlers[method] = handler
        if long_poll:
            self._long_poll.add(method)
        if inline:
            self._inline.add(method)

    def register_instance(self, obj: Any, prefix: str = "") -> None:
        """Register every public method of ``obj`` as a handler."""
        for name in dir(obj):
            if name.startswith("_"):
                continue
            fn = getattr(obj, name)
            if callable(fn):
                self._handlers[prefix + name] = fn

    # -- lifecycle --------------------------------------------------------
    def start(self, loop_thread: Optional[EventLoopThread] = None) -> Tuple[str, int]:
        self._loop_thread = loop_thread or EventLoopThread(name=f"{self.name}-io")
        self._loop_thread.run_coro(self._start_async())
        return self.host, self.port

    async def _start_async(self) -> None:
        self._server = await asyncio.start_server(self._on_client, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    async def serve_forever(self) -> None:
        """For processes whose main thread is the event loop."""
        self._server = await asyncio.start_server(self._on_client, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        async with self._server:
            await self._server.serve_forever()

    def stop(self) -> None:
        if self._loop_thread and self._server:
            async def _close():
                self._server.close()

            try:
                self._loop_thread.run_coro(_close(), timeout=5)
            except Exception:
                # the owning loop may already be gone at teardown; the
                # socket dies with the process either way
                logger.debug("%s: server close failed", self.name,
                             exc_info=True)

    # -- serving ----------------------------------------------------------
    async def _on_client(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                call_id, kind, body = await _read_frame(reader)
                asyncio.ensure_future(self._dispatch(call_id, kind, body, writer))
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        except Exception:
            logger.exception("%s: connection handler error", self.name)
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def _dispatch(self, call_id: int, kind: int, body: bytes, writer: asyncio.StreamWriter) -> None:
        t0 = time.monotonic()
        # Track time the loop is actually HELD by this dispatch (decode +
        # on-loop handler segments). Executor time is wall-clock for the
        # caller but does not stall sibling connections — the old warning
        # charged the whole handler to the loop and cried wolf on every
        # fat CreateActor that was already safely off-loop.
        loop_held = 0.0
        base_kind = kind & KIND_MASK
        method = "?"
        is_async = False
        loop = asyncio.get_event_loop()
        try:
            if len(body) > _LOOP_DECODE_MAX:
                # decode runs on the executor: wall time, not loop time
                method, kwargs = await loop.run_in_executor(
                    None, _decode_body, kind, body)
            else:
                method, kwargs = _decode_body(kind, body)
                loop_held += time.monotonic() - t0
            chaos = _chaos_action(method)
            if chaos == "request":
                logger.warning("chaos: dropping rpc %s", method)
                return  # simulate lost request
            if chaos and chaos.startswith("delay"):
                ms = float(chaos.split(":", 1)[1]) if ":" in chaos else 100.0
                logger.warning("chaos: delaying rpc %s by %sms", method, ms)
                await asyncio.sleep(ms / 1000.0)
            handler = self._handlers.get(method)
            if handler is None:
                raise RpcError(f"{self.name}: no handler for {method!r}")
            is_async = asyncio.iscoroutinefunction(handler)
            if is_async:
                result = await handler(**kwargs)
            elif method in self._inline:
                # registered inline: cheap bookkeeping handler runs on
                # the loop directly; its time is loop-held by definition
                ti = time.monotonic()
                result = handler(**kwargs)
                loop_held += time.monotonic() - ti
            else:
                # sync handlers never run on the loop: the blocking part
                # of actor bootstrap (ctor-arg unpickling, zygote
                # handshake) executes on the thread pool
                result = await loop.run_in_executor(
                    None, lambda: handler(**kwargs)
                )
            if chaos == "response":
                # handler side effects happened; the reply is lost
                logger.warning("chaos: dropping reply of rpc %s", method)
                return
            if base_kind == KIND_ONEWAY:
                return
            te = time.monotonic()
            flags, segs, total = _encode_body((True, result))
            loop_held += time.monotonic() - te
        except Exception as e:  # noqa: BLE001
            if base_kind == KIND_ONEWAY:
                logger.exception("%s: oneway handler %s failed", self.name, method)
                return
            import traceback

            flags, segs, total = _encode_body(
                (False, f"{type(e).__name__}: {e}\n{traceback.format_exc()}"))
        dt = time.monotonic() - t0
        if loop_held >= _LOOP_LAG_MIN_S:
            _note_loop_held(self.name, method, loop_held, dt)
        # an inline handler's wall time inflates under process-wide GIL
        # saturation (every thread is equally stalled) — warn only well
        # past the threshold so a busy-but-healthy worker doesn't spam
        # slow-handler lines for queue appends
        held_budget_ms = config.event_loop_slow_handler_ms * (
            5 if method in self._inline else 1)
        if loop_held * 1000 > held_budget_ms:
            # decode/encode/framing time — genuinely holds the loop for
            # sync AND async handlers alike
            logger.warning(
                "%s: slow handler %s held the event loop %.1fms "
                "(%.1fms wall)", self.name, method, loop_held * 1000,
                dt * 1000)
        elif is_async and dt * 1000 > config.event_loop_slow_handler_ms \
                and method not in self._long_poll:
            # an async handler's awaits yield the loop, but CPU-bound
            # segments inside it do not — keep the wall-clock warning
            # for async handlers (registered long-polls excepted); sync
            # handlers run on the executor and no longer cry wolf here
            logger.warning("%s: slow handler %s took %.1fms",
                           self.name, method, dt * 1000)
        if self.pre_response is not None:
            try:
                await self.pre_response()
            except Exception:  # noqa: BLE001
                logger.exception("%s: pre_response hook failed", self.name)
        try:
            _sink(writer).write_frame(call_id, KIND_RESPONSE | flags, segs, total)
            await writer.drain()
        except (ConnectionError, RuntimeError):
            pass


_oneway_tasks: set = set()


def _oneway_done(task) -> None:
    _oneway_tasks.discard(task)
    exc = task.exception() if not task.cancelled() else None
    if exc is not None:
        logger.debug("oneway rpc failed: %s", exc)


class RpcClient:
    """Persistent connection with pipelined calls + reconnect/retry."""

    def __init__(self, host: str, port: int, loop_thread: Optional[EventLoopThread] = None):
        self.host = host
        self.port = port
        self._loop_thread = loop_thread or EventLoopThread.get_global()
        self._lock = threading.Lock()
        self._next_id = 0
        self._pending: Dict[int, asyncio.Future] = {}
        self._writer: Optional[asyncio.StreamWriter] = None
        self._reader_task: Optional[asyncio.Task] = None
        self._conn_lock: Optional[asyncio.Lock] = None

    # -- async internals --------------------------------------------------
    async def _ensure_connected(self) -> None:
        if self._conn_lock is None:
            self._conn_lock = asyncio.Lock()
        async with self._conn_lock:
            if self._writer is not None and not self._writer.is_closing():
                return
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(self.host, self.port),
                timeout=config.rpc_connect_timeout_s,
            )
            self._writer = writer
            self._reader_task = asyncio.ensure_future(self._read_loop(reader))

    async def _read_loop(self, reader: asyncio.StreamReader) -> None:
        try:
            while True:
                call_id, kind, body = await _read_frame(reader)
                fut = self._pending.pop(call_id, None)
                if fut is not None and not fut.done():
                    fut.set_result((kind, body))
        except (asyncio.IncompleteReadError, ConnectionError, asyncio.CancelledError):
            pass
        finally:
            self._writer = None
            # teardown must not orphan in-flight response futures: every
            # caller sees ConnectionError, never a silent hang
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(RpcConnectionError(f"connection to {self.host}:{self.port} lost"))
            self._pending.clear()

    async def _call_async(self, method: str, kwargs: dict, oneway: bool, timeout: Optional[float]) -> Any:
        """Must run on self._loop_thread.loop — all connection state
        (writer, pending futures, read loop) is affine to that loop."""
        if timeout is not None and timeout < 0:
            timeout = None  # negative = wait forever (long-running tasks)
        await self._ensure_connected()
        with self._lock:
            self._next_id += 1
            call_id = self._next_id
        if oneway:
            _send_frame(self._writer, call_id, KIND_ONEWAY, (method, kwargs))
            await self._writer.drain()
            return None
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        self._pending[call_id] = fut
        _send_frame(self._writer, call_id, KIND_REQUEST, (method, kwargs))
        await self._writer.drain()
        kind, body = await asyncio.wait_for(fut, timeout=timeout)
        if len(body) > _LOOP_DECODE_MAX:
            ok, payload = await asyncio.get_event_loop().run_in_executor(
                None, _decode_body, kind, body)
        else:
            ok, payload = _decode_body(kind, body)
        if not ok:
            raise RemoteError(payload)
        return payload

    # -- public sync API --------------------------------------------------
    def call(self, method: str, timeout: Optional[float] = None, **kwargs) -> Any:
        timeout = timeout if timeout is not None else config.rpc_call_timeout_s
        outer = None if timeout < 0 else timeout + 5
        return self._loop_thread.run_coro(
            self._call_async(method, kwargs, oneway=False, timeout=timeout),
            timeout=outer,
        )

    def call_retrying(self, method: str, timeout: Optional[float] = None, **kwargs) -> Any:
        """Retry on connection errors with exponential backoff (reference:
        retryable_grpc_client.h)."""
        delay = config.rpc_retry_base_delay_ms / 1000.0
        last: Optional[Exception] = None
        for _ in range(max(1, config.rpc_max_retries)):
            try:
                return self.call(method, timeout=timeout, **kwargs)
            except (RpcConnectionError, ConnectionError, asyncio.TimeoutError, TimeoutError, OSError) as e:
                last = e
                time.sleep(delay)
                delay = min(delay * 2, config.rpc_retry_max_delay_ms / 1000.0)
        raise RpcConnectionError(f"rpc {method} to {self.host}:{self.port} failed after retries: {last}")

    def call_oneway(self, method: str, **kwargs) -> None:
        coro = self._call_async(method, kwargs, oneway=True, timeout=None)
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is self._loop_thread.loop:
            # caller IS the io loop (e.g. a refcount release triggered
            # from a dispatcher coroutine): blocking run_coro here would
            # deadlock the loop on itself — fire and forget instead.
            # Pin the task (asyncio holds only weak refs) so GC cannot
            # collect it mid-flight, and drain its exception.
            task = asyncio.ensure_future(coro)
            _oneway_tasks.add(task)
            task.add_done_callback(_oneway_done)
            return
        self._loop_thread.run_coro(coro, timeout=30)

    async def acall(self, method: str, timeout: Optional[float] = None, **kwargs) -> Any:
        """Async call, safe from ANY event loop: the I/O always executes on
        this client's owning loop (cross-loop use of one cached client was a
        silent-hang bug — futures created on loop A resolved from loop B
        never wake A)."""
        timeout = timeout if timeout is not None else config.rpc_call_timeout_s
        running = asyncio.get_event_loop()
        if running is self._loop_thread.loop:
            return await self._call_async(method, kwargs, oneway=False, timeout=timeout)
        cf = asyncio.run_coroutine_threadsafe(
            self._call_async(method, kwargs, oneway=False, timeout=timeout),
            self._loop_thread.loop,
        )
        return await asyncio.wrap_future(cf)

    def close(self) -> None:
        async def _close():
            # cancel AND await the read loop: a merely-closed writer
            # leaves the reader task alive until the loop is torn down,
            # and asyncio then logs "Task was destroyed but it is
            # pending!" at interpreter exit (BENCH r05 finding)
            task, self._reader_task = self._reader_task, None
            w, self._writer = self._writer, None
            if w is not None:
                try:
                    w.close()
                except Exception:  # noqa: BLE001
                    pass
            if task is not None and not task.done():
                task.cancel()
                try:
                    await task
                except BaseException:  # noqa: BLE001 — CancelledError et al.
                    pass
            # the read loop's finally failed in-flight futures; cover the
            # window where close() ran before the loop ever started
            for fut in list(self._pending.values()):
                if not fut.done():
                    fut.set_exception(RpcConnectionError(
                        f"client to {self.host}:{self.port} closed"))
            self._pending.clear()

        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is self._loop_thread.loop:
            # caller IS the owning loop (a LoopHandle-bound client closed
            # from a gcs/raylet handler): blocking run_coro would deadlock
            # the loop on itself — detach the teardown instead
            task = asyncio.ensure_future(_close())
            _oneway_tasks.add(task)
            task.add_done_callback(_oneway_done)
            return
        try:
            self._loop_thread.run_coro(_close(), timeout=5)
        except Exception:
            # owning loop already stopped at teardown: in-flight futures
            # were failed by the read loop's finally; nothing left to free
            logger.debug("client close to %s:%s failed", self.host,
                         self.port, exc_info=True)


_client_cache: Dict[Tuple[str, int], RpcClient] = {}
# RAY_TPU_DEBUG_LOCKS=1 wraps this (and the other central _private locks)
# in an order-recording proxy that raises on cycle-forming acquisition —
# the dynamic validation of raycheck's static RC002 lock-order model
_client_cache_lock = debug_locks.maybe_wrap(
    threading.Lock(), "rpc._client_cache_lock")


def get_client(addr: Tuple[str, int]) -> RpcClient:
    """Process-wide client cache — one connection per peer."""
    with _client_cache_lock:
        c = _client_cache.get(addr)
        if c is None:
            c = RpcClient(addr[0], addr[1])
            _client_cache[addr] = c
        return c


def clear_client_cache() -> None:
    # Snapshot-then-close: closing INSIDE the lock livelocked shutdown —
    # each close() parks 5s in run_coro while the io loop sits blocked in
    # get_client() on this same lock (observed: a 2,000-actor driver's
    # teardown wedged for hours, 5s per cached client). With the lock
    # dropped first, the loop's get_client proceeds and every close's
    # coroutine actually runs.
    with _client_cache_lock:
        clients = list(_client_cache.values())
        _client_cache.clear()
    for c in clients:
        c.close()
