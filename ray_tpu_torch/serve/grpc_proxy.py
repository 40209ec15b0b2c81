"""gRPC ingress (copy of ray_tpu/serve/grpc_proxy.py; reference:
serve/_private/proxy.py:520 gRPCProxy — a second protocol through the
same router as HTTP). ``grpc`` is imported inside the functions that
serve, so importing Serve loads no gRPC.

Generic service, no compiled .proto needed: the gRPC method path names
the deployment and handler — ``/<deployment>/<method>``. The wire
payload is selected by the ``payload`` metadata key:

- ``raw`` (default) — the request bytes become one positional argument;
  the response is the result's bytes (``bytes`` pass through, ``str``
  is utf-8 encoded, anything else is JSON-encoded). Safe for untrusted
  callers.
- ``json`` — the request is a JSON object ``{"args": [...],
  "kwargs": {...}}`` (or a bare JSON array = args); the response is
  JSON. Safe for untrusted callers.
- ``pickle`` — the request is a pickled ``(args, kwargs)`` tuple and
  the response is the pickled result. **pickle.loads on network input
  is arbitrary code execution** (the reference gRPCProxy uses compiled
  user protobufs instead, serve/_private/proxy.py:520), so this mode is
  only accepted when the proxy is bound to loopback or started with
  ``allow_pickle=True`` — never expose it beyond a trusted network.

Generator handlers stream one message per yield. The metadata key
``multiplexed_model_id`` routes to a model-holding replica exactly like
``handle.options(multiplexed_model_id=...)``.

SLO semantics (mirrors the HTTP front door, canonical status codes):

- the client's native gRPC deadline is honored end to end — it becomes
  the request's serve deadline, rides to the replica, and expiry maps
  to ``DEADLINE_EXCEEDED`` (a proxy default applies when the client
  sets none; no wait on the path is unbounded);
- admission control sheds with ``RESOURCE_EXHAUSTED`` *before* any
  response message, with a ``retry-after-s`` trailing metadata hint;
- idempotent unary requests retry transparently around dead/DRAINING
  replicas (metadata ``idempotent: 0`` opts out); exhausted retries
  map to ``UNAVAILABLE``;
- a replica dying mid-stream aborts the stream with ``UNAVAILABLE``
  after the partial messages (the gRPC equivalent of the HTTP terminal
  error frame); unknown deployments map to ``NOT_FOUND`` and
  application errors to ``INTERNAL``.

Python client (trusted, loopback):

    ch = grpc.insecure_channel(f"127.0.0.1:{port}")
    call = ch.unary_unary("/my_app/__call__")
    result = pickle.loads(call(pickle.dumps(((arg,), {})),
                               metadata=(("payload", "pickle"),)))
"""

from __future__ import annotations

import json
import logging
import pickle
import threading
from concurrent import futures
from typing import Any, Dict, Optional

import ray_tpu_torch as rt
from ray_tpu_torch.exceptions import GetTimeoutError
from ray_tpu_torch.serve import slo

logger = logging.getLogger("ray_tpu_torch.serve.grpc")

_PROXY_LOCK = threading.Lock()
_PROXY: Optional["_GrpcProxy"] = None

_LOOPBACK = ("127.0.0.1", "localhost", "::1")


class _PayloadError(Exception):
    pass


def _load_request(data: bytes, mode: str, allow_pickle: bool):
    if mode == "pickle":
        if not allow_pickle:
            raise _PayloadError(
                "payload=pickle is disabled on this proxy (bound beyond "
                "loopback without allow_pickle=True); use payload=json "
                "or raw bytes")
        try:
            args, kwargs = pickle.loads(data)
            if isinstance(args, tuple) and isinstance(kwargs, dict):
                return args, kwargs
        except Exception:  # noqa: BLE001
            pass
        return (data,), {}  # raw payload as one positional arg
    if mode == "json":
        try:
            obj = json.loads(data.decode("utf-8"))
        except Exception as e:  # noqa: BLE001
            raise _PayloadError(f"invalid JSON request: {e}")
        if isinstance(obj, dict) and ("args" in obj or "kwargs" in obj):
            try:
                return (tuple(obj.get("args", ())),
                        dict(obj.get("kwargs", {})))
            except (TypeError, ValueError) as e:
                raise _PayloadError(
                    f"json request 'args' must be a list and 'kwargs' "
                    f"an object: {e}")
        if isinstance(obj, list):
            return tuple(obj), {}
        return (obj,), {}
    if mode == "raw":
        return (data,), {}
    raise _PayloadError(
        f"unknown payload mode {mode!r}: expected raw, json, or pickle")


def _dump_response(out, mode: str) -> bytes:
    if mode == "pickle":
        return pickle.dumps(out)
    if mode == "json":
        return json.dumps(out).encode("utf-8")
    # raw: bytes pass through, str is utf-8, structures fall back to JSON
    if isinstance(out, bytes):
        return out
    if isinstance(out, str):
        return out.encode("utf-8")
    return json.dumps(out).encode("utf-8")


class _GrpcProxy:
    def __init__(self, host: str, port: int,
                 allow_pickle: Optional[bool] = None,
                 max_inflight: int = slo.DEFAULT_MAX_INFLIGHT,
                 max_queue_depth: int = slo.DEFAULT_MAX_QUEUE_DEPTH):
        import grpc

        if allow_pickle is None:
            allow_pickle = host in _LOOPBACK
        self._allow_pickle = allow_pickle
        self._handles: Dict[str, Any] = {}
        self._hlock = threading.Lock()
        self.admission = slo.AdmissionController(
            max_inflight=max_inflight, max_queue_depth=max_queue_depth)

        proxy = self

        class _Generic(grpc.GenericRpcHandler):
            def service(self, handler_call_details):
                parts = handler_call_details.method.strip("/").split("/")
                if len(parts) != 2:
                    return None
                dep, method = parts
                md = dict(handler_call_details.invocation_metadata or ())
                model_id = md.get("multiplexed_model_id", "")
                payload = md.get("payload", "raw")
                idempotent = md.get("idempotent", "1").lower() \
                    not in ("0", "false", "no")

                def unary(request, context):
                    return proxy._call_unary(dep, method, request,
                                             context, model_id, payload,
                                             idempotent)

                def stream(request, context):
                    yield from proxy._call_stream(dep, method, request,
                                                  context, model_id,
                                                  payload)

                if proxy._is_streaming(dep, method):
                    return grpc.unary_stream_rpc_method_handler(
                        stream, request_deserializer=None,
                        response_serializer=None)
                return grpc.unary_unary_rpc_method_handler(
                    unary, request_deserializer=None,
                    response_serializer=None)

        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=32))
        self._server.add_generic_rpc_handlers((_Generic(),))
        self.port = self._server.add_insecure_port(f"{host}:{port}")
        self._server.start()
        logger.info("gRPC proxy on :%d", self.port)

    def _get_handle(self, name: str):
        with self._hlock:
            h = self._handles.get(name)
            if h is None:
                from ray_tpu_torch.serve.controller import get_app_handle

                h = get_app_handle(name)
                self._handles[name] = h
            return h

    def _is_streaming(self, dep: str, method: str) -> bool:
        try:
            return method in self._get_handle(dep)._streaming_methods
        except Exception:  # noqa: BLE001
            return False

    def _deadline(self, context) -> slo.Deadline:
        """The client's gRPC deadline is the request deadline; absent
        one, the proxy default applies (nothing is unbounded). A
        deadline that ALREADY expired in the server queue aborts here —
        executing work for a caller that has hung up, on the full 60s
        default, would invert the contract."""
        import grpc

        remaining = context.time_remaining()
        if remaining is None:
            return slo.Deadline(slo.DEFAULT_TIMEOUT_S)
        if remaining <= 0:
            context.abort(grpc.StatusCode.DEADLINE_EXCEEDED,
                          "client deadline expired before the handler "
                          "started")
        return slo.Deadline(remaining)

    def _admit(self, context, deadline: slo.Deadline) -> bool:
        """Shed with RESOURCE_EXHAUSTED before any response message."""
        import grpc

        try:
            self.admission.admit(deadline)
            return True
        except slo.OverloadedError as e:
            context.set_trailing_metadata(
                (("retry-after-s", str(e.retry_after_s)),))
            context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
            return False  # unreachable — abort raises

    def _target(self, dep: str, method: str, context, model_id: str,
                deadline: Optional[slo.Deadline] = None):
        import grpc

        try:
            handle = self._get_handle(dep)
        except Exception as e:  # noqa: BLE001
            context.abort(grpc.StatusCode.NOT_FOUND,
                          f"no deployment {dep!r}: {e}")
        target = handle.options(
            multiplexed_model_id=model_id,
            timeout_s=None if deadline is None else deadline.remaining())
        return target if method == "__call__" \
            else getattr(target, method)

    def _abort_for(self, context, e: BaseException) -> None:
        """Map a serve-path failure to its canonical status code."""
        import grpc

        from ray_tpu_torch.serve.deployment import REPLICA_FAILURES

        if isinstance(e, slo.DeadlineExceededError):
            context.abort(grpc.StatusCode.DEADLINE_EXCEEDED, str(e))
        if isinstance(e, slo.OverloadedError):
            context.set_trailing_metadata(
                (("retry-after-s", str(e.retry_after_s)),))
            context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
        if isinstance(e, (slo.ReplicasUnavailableError,) + REPLICA_FAILURES):
            context.abort(grpc.StatusCode.UNAVAILABLE,
                          f"{type(e).__name__}: {e}")
        context.abort(grpc.StatusCode.INTERNAL,
                      f"{type(e).__name__}: {e}")

    def _call_unary(self, dep: str, method: str, request: bytes, context,
                    model_id: str, payload: str,
                    idempotent: bool = True) -> bytes:
        import grpc

        deadline = self._deadline(context)
        self._admit(context, deadline)
        try:
            m = self._target(dep, method, context, model_id, deadline)
            try:
                args, kwargs = _load_request(request, payload,
                                             self._allow_pickle)
            except _PayloadError as e:
                context.abort(grpc.StatusCode.PERMISSION_DENIED
                              if "disabled" in str(e)
                              else grpc.StatusCode.INVALID_ARGUMENT, str(e))
            try:
                resp = m.remote(*args, **kwargs)
                resp.retry_on_failure = idempotent
                out = resp.result(timeout=deadline.remaining_or_raise())
                return _dump_response(out, payload)
            except Exception as e:  # noqa: BLE001 — mapped to a status
                self._abort_for(context, e)
        finally:
            self.admission.release()

    def _call_stream(self, dep: str, method: str, request: bytes, context,
                     model_id: str, payload: str):
        import grpc

        from ray_tpu_torch.serve.deployment import REPLICA_FAILURES

        deadline = self._deadline(context)
        self._admit(context, deadline)
        try:
            m = self._target(dep, method, context, model_id, deadline)
            try:
                args, kwargs = _load_request(request, payload,
                                             self._allow_pickle)
            except _PayloadError as e:
                context.abort(grpc.StatusCode.PERMISSION_DENIED
                              if "disabled" in str(e)
                              else grpc.StatusCode.INVALID_ARGUMENT, str(e))
            gen = m.remote(*args, **kwargs)
            sent_any = False
            try:
                while True:
                    try:
                        ref = gen.next_ref(
                            timeout=deadline.remaining_or_raise())
                    except StopIteration:
                        break
                    yield _dump_response(
                        rt.get(ref,
                                    timeout=deadline.remaining_or_raise()),
                        payload)
                    sent_any = True
            except slo.DeadlineExceededError as e:
                context.abort(grpc.StatusCode.DEADLINE_EXCEEDED, str(e))
            except GetTimeoutError:
                context.abort(grpc.StatusCode.DEADLINE_EXCEEDED,
                              "request deadline exceeded mid-stream")
            except (slo.OverloadedError,) + REPLICA_FAILURES as e:
                # before any message a shed maps to RESOURCE_EXHAUSTED;
                # after partial messages a dead replica is UNAVAILABLE
                # (the gRPC terminal-frame equivalent — the client sees
                # a status, never a hung stream)
                if isinstance(e, slo.OverloadedError) and not sent_any:
                    context.set_trailing_metadata(
                        (("retry-after-s",
                          str(getattr(e, "retry_after_s", 1.0))),))
                    context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED,
                                  str(e))
                context.abort(grpc.StatusCode.UNAVAILABLE,
                              f"{type(e).__name__}: {e}")
            except Exception as e:  # noqa: BLE001
                context.abort(grpc.StatusCode.INTERNAL,
                              f"{type(e).__name__}: {e}")
        finally:
            self.admission.release()

    def stop(self) -> None:
        self._server.stop(grace=1.0)


def start_grpc_proxy(host: str = "127.0.0.1", port: int = 9000,
                     allow_pickle: Optional[bool] = None,
                     max_inflight: int = slo.DEFAULT_MAX_INFLIGHT,
                     max_queue_depth: int = slo.DEFAULT_MAX_QUEUE_DEPTH
                     ) -> int:
    """Start (or return) the node's gRPC ingress; returns the bound
    port.

    ``allow_pickle`` gates the ``payload=pickle`` wire mode (arbitrary
    code execution for whoever can reach the port). ``None`` (default)
    enables it only when ``host`` is loopback; pass ``True`` explicitly
    to accept pickle on a non-loopback bind — trusted networks only.
    ``max_inflight`` / ``max_queue_depth`` bound the admission gate.
    """
    global _PROXY
    with _PROXY_LOCK:
        if _PROXY is None:
            _PROXY = _GrpcProxy(host, port, allow_pickle=allow_pickle,
                                max_inflight=max_inflight,
                                max_queue_depth=max_queue_depth)
        elif (allow_pickle is not None
              and allow_pickle != _PROXY._allow_pickle):
            # the singleton must not silently ignore a security setting
            raise ValueError(
                f"gRPC proxy already running with allow_pickle="
                f"{_PROXY._allow_pickle}; stop_grpc_proxy() first to "
                f"change it")
        return _PROXY.port


def grpc_proxy_stats() -> Dict[str, int]:
    """Admission counters of the running gRPC ingress (empty when no
    proxy is up)."""
    with _PROXY_LOCK:
        if _PROXY is None:
            return {}
        return {f"admission_{k}": v
                for k, v in _PROXY.admission.stats().items()}


def stop_grpc_proxy() -> None:
    global _PROXY
    with _PROXY_LOCK:
        if _PROXY is not None:
            _PROXY.stop()
            _PROXY = None
