"""HTTP ingress for Serve deployments — the hardened front door (copy of
ray_tpu/serve/http_proxy.py).

Reference: per-node ProxyActor ASGI app (serve/_private/proxy.py:1098,
uvicorn/starlette), re-built on asyncio streams (dependency-free).
``POST /<deployment>`` with a JSON body dispatches to the deployment
handle; streaming deployments respond with chunked transfer encoding,
one JSON line per yielded value (reference: streamed replica responses,
replica.py:1630).

Request lifecycle (the SLO contract, see README "Serve front door"):

1. **Deadline** — every request carries one, from the
   ``x-request-timeout-s`` header or the proxy default; it is the only
   timeout on the path (no fixed per-hop waits) and rides to the
   replica. Expiry → **504** with a structured JSON error body (unary)
   or the terminal error frame (mid-stream).
2. **Admission** — a bounded in-flight gate sheds load with **503 +
   Retry-After** *before the first response byte* when depth or the
   queue-wait budget is exceeded.
3. **Retry** — idempotent requests (the default; send
   ``x-request-idempotent: 0`` to opt out) are transparently re-routed
   around dead/DRAINING replicas with jittered exponential backoff.
   Streams re-dispatch only before the first byte; a replica dying
   mid-stream produces the documented terminal frame
   ``{"error": {...}, "terminal": true}`` and a clean chunked close.
4. **Dispatch** — requests are submitted and resolved on the proxy's
   event loop (the result lands in the memory store off the
   fastpath-coded RPC loop and is awaited directly); there is no
   executor-thread handoff per request/chunk, so hundreds of concurrent
   streams ride one loop.
"""

from __future__ import annotations

import asyncio
import json
import threading
from typing import Dict, Optional

from ray_tpu_torch._private.streaming import ObjectRefGenerator, StreamEnd
from ray_tpu_torch.exceptions import GetTimeoutError
from ray_tpu_torch.serve import slo
from ray_tpu_torch.serve.deployment import (
    REPLICA_FAILURES,
    DeploymentHandle,
    _resolve_ref_async,
)

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            500: "Internal Server Error", 503: "Service Unavailable",
            504: "Gateway Timeout"}

# payloads above this go through one executor hop for serialization —
# promoting a large arg into shm can block; small JSON bodies (the
# overwhelming case) submit straight from the loop
_OFFLOAD_BODY_BYTES = 64 * 1024


def _json_bytes(obj) -> bytes:
    return json.dumps(obj).encode()


class _ClientGone(Exception):
    """The CLIENT's socket failed mid-response. Distinct from replica
    failures (which are also ConnectionErrors) so a disconnecting
    client is never misread as a dead replica — under client churn that
    misread would spray false down-reports at the controller."""


class _ProxyStats:
    """Front-door counters, exposed via ``http_proxy_stats()`` and the
    soak harness. Lock-free increments would race under the GIL's
    bytecode boundaries; one small lock keeps them exact."""

    FIELDS = ("requests", "ok", "shed", "deadline_exceeded",
              "unavailable", "app_errors", "bad_request", "not_found",
              "stream_terminal_errors", "failure_retries",
              "client_disconnects")

    def __init__(self):
        self._lock = threading.Lock()
        self._c = {f: 0 for f in self.FIELDS}

    def inc(self, field: str, n: int = 1) -> None:
        with self._lock:
            self._c[field] += n
            total = self._c[field]
        if field == "deadline_exceeded":
            # a 504 is a typed SLO failure: leave the cluster's black box
            # behind. Off-loop (file write) and pre-gated on the dump
            # throttle so a 504 storm costs one thread per 5 s, not per
            # request.
            from ray_tpu_torch.observability import dump as obs_dump

            if obs_dump.would_dump("serve_deadline_exceeded"):
                threading.Thread(
                    target=obs_dump.trigger_cluster_dump,
                    args=("serve_deadline_exceeded",),
                    kwargs={"deadline_exceeded_total": total},
                    daemon=True, name="obs-504-dump").start()

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._c)


class _AsyncProxy:
    def __init__(self, host: str = "127.0.0.1", port: int = 8000,
                 max_inflight: int = slo.DEFAULT_MAX_INFLIGHT,
                 max_queue_depth: int = slo.DEFAULT_MAX_QUEUE_DEPTH):
        self.host = host
        self.requested_port = port
        self.port: Optional[int] = None
        self.handles: Dict[str, DeploymentHandle] = {}
        self.admission = slo.AdmissionController(
            max_inflight=max_inflight, max_queue_depth=max_queue_depth)
        self.stats = _ProxyStats()
        self._loop = asyncio.new_event_loop()
        self._server: Optional[asyncio.AbstractServer] = None
        self._ready = threading.Event()
        self._start_error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="serve-http-proxy"
        )
        self._thread.start()
        self._ready.wait(timeout=10)
        if self._start_error is not None:
            raise self._start_error
        if self.port is None:
            raise RuntimeError("HTTP proxy failed to start in time")

    def _run(self) -> None:
        asyncio.set_event_loop(self._loop)
        try:
            self._loop.run_until_complete(self._start())
        except BaseException as e:  # noqa: BLE001 — surface bind errors
            self._start_error = e
            self._ready.set()
            return
        self._ready.set()
        self._loop.run_forever()

    async def _start(self) -> None:
        self._server = await asyncio.start_server(
            self._on_client, self.host, self.requested_port
        )
        self.port = self._server.sockets[0].getsockname()[1]

    def _get_handle_blocking(self, name: str) -> DeploymentHandle:
        from ray_tpu_torch.serve.controller import get_app_handle

        return get_app_handle(name)

    async def _get_handle(self, name: str) -> DeploymentHandle:
        handle = self.handles.get(name)
        if handle is None:
            # first touch resolves through the controller (a blocking
            # RPC) — one executor hop, then cached for the proxy's life
            loop = asyncio.get_event_loop()
            handle = await loop.run_in_executor(
                None, self._get_handle_blocking, name)
            self.handles[name] = handle
        return handle

    # -- request handling ----------------------------------------------
    async def _on_client(self, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                request_line = await reader.readline()
                if not request_line:
                    return
                try:
                    method, path, _version = request_line.decode().split(None, 2)
                except ValueError:
                    return
                headers: Dict[str, str] = {}
                while True:
                    line = await reader.readline()
                    if line in (b"\r\n", b"\n", b""):
                        break
                    k, _, v = line.decode().partition(":")
                    headers[k.strip().lower()] = v.strip()
                body = b""
                length = int(headers.get("content-length", 0))
                if length:
                    body = await reader.readexactly(length)
                keep_alive = headers.get("connection", "keep-alive").lower() != "close"
                await self._dispatch(method, path, body, writer, headers)
                if not keep_alive:
                    return
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass

    def _error_response(self, writer: asyncio.StreamWriter, status: int,
                        code: str, message: str,
                        retry_after_s: Optional[float] = None) -> None:
        body = _json_bytes(slo.error_body(code, message,
                                          retry_after_s=retry_after_s))
        extra = f"Retry-After: {max(1, round(retry_after_s or 0))}\r\n" \
            if retry_after_s is not None else ""
        writer.write(
            f"HTTP/1.1 {status} {_REASONS.get(status, 'Error')}\r\n"
            f"Content-Type: application/json\r\n"
            f"{extra}"
            f"Content-Length: {len(body)}\r\n\r\n".encode() + body
        )

    async def _send(self, writer: asyncio.StreamWriter,
                    data: bytes) -> None:
        try:
            writer.write(data)
            await writer.drain()
        except (ConnectionError, OSError) as e:
            raise _ClientGone() from e

    def _plain_response(self, writer: asyncio.StreamWriter, status: int,
                        data: bytes) -> None:
        writer.write(
            f"HTTP/1.1 {status} {_REASONS.get(status, 'OK')}\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(data)}\r\n\r\n".encode() + data
        )

    async def _dispatch(self, method: str, path: str, body: bytes,
                        writer: asyncio.StreamWriter,
                        headers: Dict[str, str] = None) -> None:
        headers = headers or {}
        segs = path.strip("/").split("?")[0].split("/")
        name = segs[0]
        # ``POST /<deployment>[/<method>]`` — bare deployment path calls
        # __call__; a second segment names the handler (e.g. the llm
        # deployment's generate_stream streaming method)
        call_method = segs[1] if len(segs) > 1 and segs[1] else "__call__"
        self.stats.inc("requests")
        if call_method != "__call__" and call_method.startswith("_"):
            # the same underscore guard DeploymentHandle.__getattr__
            # enforces in-process: the public front door must not reach
            # private/dunder replica methods
            self.stats.inc("not_found")
            self._error_response(writer, 404, "not_found",
                                 f"no such method {call_method!r}")
            await writer.drain()
            return
        deadline = slo.Deadline.from_header(headers.get(slo.TIMEOUT_HEADER))
        idempotent = headers.get("x-request-idempotent", "1").lower() \
            not in ("0", "false", "no")
        # -- admission: shed BEFORE any work / any response byte -------
        try:
            await self.admission.try_admit(deadline)
        except slo.OverloadedError as e:
            self.stats.inc("shed")
            self._error_response(writer, 503, "overloaded", str(e),
                                 retry_after_s=e.retry_after_s)
            await writer.drain()
            return
        try:
            await self._dispatch_admitted(name, call_method, body, writer,
                                          headers, deadline, idempotent)
        finally:
            self.admission.release()

    async def _dispatch_admitted(self, name: str, call_method: str,
                                 body: bytes,
                                 writer: asyncio.StreamWriter,
                                 headers: Dict[str, str],
                                 deadline: slo.Deadline,
                                 idempotent: bool) -> None:
        loop = asyncio.get_event_loop()
        model_id = headers.get("serve_multiplexed_model_id", "")
        try:
            handle = await self._get_handle(name)
        except ValueError as e:
            self.stats.inc("not_found")
            self._error_response(writer, 404, "not_found", str(e))
            await writer.drain()
            return
        except Exception as e:  # noqa: BLE001 — controller unreachable
            self.stats.inc("app_errors")
            self._error_response(writer, 500, "internal", str(e))
            await writer.drain()
            return
        try:
            payload = json.loads(body) if body else None
        except ValueError as e:
            self.stats.inc("bad_request")
            self._error_response(writer, 400, "bad_request",
                                 f"invalid JSON body: {e}")
            await writer.drain()
            return

        def _submit():
            args = (payload,) if payload is not None else ()
            return handle._call(call_method, args, {}, model_id,
                                deadline=deadline)

        try:
            if len(body) > _OFFLOAD_BODY_BYTES:
                result = await loop.run_in_executor(None, _submit)
            else:
                result = _submit()
        except Exception as e:  # noqa: BLE001 — submit-path failure
            self.stats.inc("app_errors")
            self._error_response(writer, 500, "internal", str(e))
            await writer.drain()
            return
        if isinstance(result, ObjectRefGenerator):
            await self._stream_response(writer, result, handle, call_method,
                                        payload, model_id, deadline,
                                        idempotent)
            return
        # -- unary ------------------------------------------------------
        result.retry_on_failure = idempotent
        try:
            value = await result.result_async()
            self.stats.inc("ok")
            self._plain_response(writer, 200,
                                 _json_bytes({"result": value}))
        except slo.DeadlineExceededError as e:
            self.stats.inc("deadline_exceeded")
            self._error_response(writer, 504, "deadline_exceeded", str(e))
        except slo.OverloadedError as e:
            self.stats.inc("shed")
            self._error_response(writer, 503, "overloaded", str(e),
                                 retry_after_s=e.retry_after_s)
        except slo.ReplicasUnavailableError as e:
            self.stats.inc("unavailable")
            self._error_response(writer, 503, "unavailable", str(e),
                                 retry_after_s=1.0)
        except Exception as e:  # noqa: BLE001 — application error
            self.stats.inc("app_errors")
            self._error_response(writer, 500, "internal", str(e))
        await writer.drain()

    # -- streaming ------------------------------------------------------
    async def _stream_first(self, gen, deadline: slo.Deadline):
        """Resolve the stream's first item (or its verdict) BEFORE any
        response byte — shed/deadline/not-found still map to clean HTTP
        statuses. Returns (gen, value|None, ended_before_first)."""
        ref = await gen.anext_ref(timeout=deadline.remaining_or_raise())
        value = await _resolve_ref_async(ref, deadline.remaining_or_raise())
        return value

    async def _stream_response(self, writer: asyncio.StreamWriter, gen,
                               handle, call_method: str, payload,
                               model_id: str, deadline: slo.Deadline,
                               idempotent: bool = True) -> None:
        """Chunked transfer encoding: one JSON line per yielded value,
        sent as each lands. Error semantics: before the first byte the
        stream can still be retried on another replica (shed → 503,
        deadline → 504); after it, failures produce ONE terminal frame
        ``{"error": {...}, "terminal": true}`` then a clean chunked
        close — consumers never see a hung connection."""
        policy = slo.RetryPolicy()
        first = None
        ended_early = False
        attempt = 0
        while True:
            try:
                first = await self._stream_first(gen, deadline)
                break
            except StreamEnd:
                ended_early = True
                break
            except (slo.DeadlineExceededError, GetTimeoutError) as e:
                # GetTimeoutError here means the wait for the first
                # yield consumed the request's remaining budget — a
                # deadline outcome, not an application error
                self.stats.inc("deadline_exceeded")
                self._error_response(writer, 504, "deadline_exceeded",
                                     str(e))
                await writer.drain()
                return
            except (slo.OverloadedError,) + REPLICA_FAILURES as e:
                # nothing sent yet: the whole stream may re-dispatch
                is_shed = isinstance(e, slo.OverloadedError)
                rs = getattr(gen, "_replica_set", None)
                idx = getattr(gen, "_replica_idx", None)
                if not is_shed and rs is not None and idx is not None:
                    self.stats.inc("failure_retries")
                    handle._report_replica_down(rs, idx)
                # a shed never executed, so re-dispatch is always safe;
                # a replica FAILURE may have executed side effects — only
                # idempotent requests re-dispatch (the documented opt-out)
                if (not is_shed and not idempotent) or \
                        attempt + 1 >= policy.max_attempts or \
                        deadline.remaining() < 0.2:
                    if is_shed:
                        self.stats.inc("shed")
                        self._error_response(
                            writer, 503, "overloaded", str(e),
                            retry_after_s=getattr(e, "retry_after_s", 1.0))
                    else:
                        self.stats.inc("unavailable")
                        self._error_response(writer, 503, "unavailable",
                                             str(e), retry_after_s=1.0)
                    await writer.drain()
                    return
                await asyncio.sleep(min(policy.backoff(attempt),
                                        deadline.remaining() / 2))
                attempt += 1
                args = (payload,) if payload is not None else ()
                gen = handle._call(call_method, args, {}, model_id,
                                   deadline=deadline)
            except Exception as e:  # noqa: BLE001 — app error pre-byte
                self.stats.inc("app_errors")
                self._error_response(writer, 500, "internal", str(e))
                await writer.drain()
                return

        def _chunk(data: bytes) -> bytes:
            return f"{len(data):x}\r\n".encode() + data + b"\r\n"

        try:
            await self._send(
                writer,
                b"HTTP/1.1 200 OK\r\n"
                b"Content-Type: application/json\r\n"
                b"Transfer-Encoding: chunked\r\n\r\n")
            if not ended_early:
                await self._send(writer,
                                 _chunk(_json_bytes(first) + b"\n"))
                while True:
                    try:
                        ref = await gen.anext_ref(
                            timeout=deadline.remaining_or_raise())
                        value = await _resolve_ref_async(
                            ref, deadline.remaining_or_raise())
                    except StreamEnd:
                        break
                    await self._send(writer,
                                     _chunk(_json_bytes(value) + b"\n"))
            self.stats.inc("ok")
        except _ClientGone:
            # the consumer hung up: nothing to write, nobody to blame —
            # the dropped generator releases its routing slot on GC
            self.stats.inc("client_disconnects")
            return
        except (slo.DeadlineExceededError, GetTimeoutError) as e:
            self.stats.inc("deadline_exceeded")
            self.stats.inc("stream_terminal_errors")
            writer.write(_chunk(_json_bytes(slo.error_body(
                "deadline_exceeded", str(e), terminal=True)) + b"\n"))
        except REPLICA_FAILURES as e:
            # the documented mid-stream death contract: one terminal
            # frame, then a clean close (no transparent retry — the
            # consumer already saw part of the stream)
            rs = getattr(gen, "_replica_set", None)
            idx = getattr(gen, "_replica_idx", None)
            if rs is not None and idx is not None:
                handle._report_replica_down(rs, idx)
            self.stats.inc("stream_terminal_errors")
            writer.write(_chunk(_json_bytes(slo.error_body(
                "replica_died",
                f"replica failed mid-stream: {e}",
                terminal=True)) + b"\n"))
        except Exception as e:  # noqa: BLE001 — application error
            self.stats.inc("app_errors")
            self.stats.inc("stream_terminal_errors")
            writer.write(_chunk(_json_bytes(slo.error_body(
                "internal", str(e), terminal=True)) + b"\n"))
        try:
            await self._send(writer, b"0\r\n\r\n")
        except _ClientGone:
            self.stats.inc("client_disconnects")

    def stop(self) -> None:
        def _close():
            if self._server is not None:
                self._server.close()
            # wake in-flight connection tasks with CancelledError so they
            # finalize (close writers) before the loop stops — a stopped
            # proxy leaves no "Task was destroyed but it is pending".
            # The stop lands a few ticks later: a task cancelled deep in
            # an await chain needs more than one callback round to unwind
            # its finally blocks.
            for t in asyncio.all_tasks(self._loop):
                t.cancel()
            self._loop.call_later(0.2, self._loop.stop)

        try:
            self._loop.call_soon_threadsafe(_close)
            # run_forever returns right after _close runs; reap the thread
            # so a stopped proxy leaves nothing behind
            if threading.current_thread() is not self._thread:
                self._thread.join(timeout=5)
        except Exception:  # noqa: BLE001
            pass


_proxy: Optional[_AsyncProxy] = None


def start_http_proxy(host: str = "127.0.0.1", port: int = 8000,
                     max_inflight: int = slo.DEFAULT_MAX_INFLIGHT,
                     max_queue_depth: int = slo.DEFAULT_MAX_QUEUE_DEPTH
                     ) -> int:
    """Start the ingress; returns the bound port. Raises if the port can't
    be bound (a failed start is not cached). ``max_inflight`` /
    ``max_queue_depth`` bound the admission gate (see slo.py)."""
    global _proxy
    if _proxy is None:
        _proxy = _AsyncProxy(host, port, max_inflight=max_inflight,
                             max_queue_depth=max_queue_depth)
        if _proxy.port is None:
            _proxy = None
            raise RuntimeError("HTTP proxy failed to start")
    return _proxy.port


def http_proxy_stats() -> Dict[str, int]:
    """Front-door counters + admission stats of the running proxy
    (empty when no proxy is up) — the soak harness's scrape point."""
    if _proxy is None:
        return {}
    out = _proxy.stats.snapshot()
    out.update({f"admission_{k}": v
                for k, v in _proxy.admission.stats().items()})
    return out


def stop_http_proxy() -> None:
    global _proxy
    if _proxy is not None:
        _proxy.stop()
        _proxy = None
