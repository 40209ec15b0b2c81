"""Worker process entry point — executes tasks and hosts actors (copy of
ray_tpu/_private/workers/default_worker.py; a lease pins cards through
CUDA_VISIBLE_DEVICES where JAX's pins TPU chips).

Reference: python/ray/_private/workers/default_worker.py:23 (worker entry)
+ the execution side of src/ray/core_worker/task_execution/ (TaskReceiver
task_receiver.h:43, ordered actor queues, ConcurrencyGroupManager) and the
Cython task_execution_handler (_raylet.pyx:2318).

The worker:
- registers with its raylet, serves PushTask / CreateActor / PushActorTask,
- owns a CoreWorker so user tasks can submit nested tasks / put objects,
- applies lease context (CUDA_VISIBLE_DEVICES) before running user code,
- orders actor tasks per caller by sequence number (reference:
  sequential_actor_submit_queue.cc semantics).
"""

from __future__ import annotations

import functools
import inspect
import logging
import os
import threading
import time
import traceback
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private.config import config
from ray_tpu_torch._private.core_worker import CoreWorker
from ray_tpu_torch._private.ids import ActorID, JobID, ObjectID, TaskID
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.rpc import RpcClient, get_client
from ray_tpu_torch._private.serialization import deserialize, loads_function, serialize
from ray_tpu_torch.exceptions import RayActorError, RayTaskError
from ray_tpu_torch.observability import dump as obs_dump
from ray_tpu_torch.observability import events as obs_events
from ray_tpu_torch.observability import timeline as obs_timeline
from ray_tpu_torch.observability import tracing as obs_tracing

logger = logging.getLogger("ray_tpu_torch.worker")


def _queue_wait_histogram():
    """Submit→execution-start wait (the scheduling+lease+dispatch part
    of task latency), exposed on the Prometheus scrape next to
    ray_tpu_task_latency_s. Wall-clock across processes — exact on one
    host, NTP-bounded across hosts."""
    from ray_tpu_torch.util.metrics import get_histogram

    return get_histogram(
        "ray_tpu_task_queue_wait_s",
        description="Task submit-to-execution-start wait",
        boundaries=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0),
        tag_keys=("kind",),
    )


def _ray_call_shim(instance, fn, *args, **kwargs):
    return fn(instance, *args, **kwargs)


def _unpack_arg(a: dict) -> Any:
    if a["is_ref"]:
        ref = ObjectRef(ObjectID(a["object_id"]), owner_addr=tuple(a["owner_addr"]) if a["owner_addr"] else None)
        return ("__ref__", ref)
    return ("__val__", a["value"])


class _ActorRunner:
    """Hosts one actor instance.

    Arrival order IS per-caller submission order (the caller's
    _ActorDispatcher sends one enqueue at a time), so the pool's FIFO
    queue preserves ordering with no seqno windows; results are pushed
    back to the owner asynchronously via its ActorTaskDone RPC
    (reference: direct worker→owner reply path of PushTask,
    core_worker.cc:3315).
    """

    _RESULT_CACHE_MAX = 256
    _DELIVERY_ATTEMPTS = 4

    def __init__(self, actor_id: str, instance: Any, max_concurrency: int):
        self.actor_id = actor_id
        self.instance = instance
        # asyncio actors: any `async def` method gives the actor its own
        # event loop; calls overlap without seqno ordering (reference:
        # concurrency_group_manager.cc + fiber.h async actors, whose
        # default max concurrency is high)
        from ray_tpu_torch._private.async_compat import (
            ASYNC_ACTOR_DEFAULT_CONCURRENCY,
            has_async_methods,
        )

        # inspect the CLASS, not the instance: dir+getattr on the instance
        # would execute @property getters during actor init
        self.is_async = has_async_methods(type(instance))
        if self.is_async and max_concurrency <= 1:
            max_concurrency = ASYNC_ACTOR_DEFAULT_CONCURRENCY
        self.max_concurrency = max(1, max_concurrency)
        self.pool = ThreadPoolExecutor(max_workers=self.max_concurrency, thread_name_prefix=f"actor-{actor_id[:8]}")
        self._loop: Optional[Any] = None
        if self.is_async:
            import asyncio

            self._loop = asyncio.new_event_loop()
            t = threading.Thread(
                target=self._loop.run_forever, daemon=True,
                name=f"actor-loop-{actor_id[:8]}",
            )
            t.start()
        self.dead = False
        self.lock = threading.Lock()
        self.inflight: set = set()  # task_id bins accepted but not finished
        # completed results kept until delivery is confirmed (or LRU-evicted)
        # so the caller's QueryActorTaskResult can recover a lost push
        self.results: "OrderedDict[bytes, list]" = OrderedDict()

    def _call_method(self, method_name: str):
        """Build the invoke callable. For asyncio actors EVERY method runs
        on the actor's event loop — coroutines await there (overlapping),
        sync methods execute serialized on the loop thread, preserving the
        actor's single-threaded state guarantee (reference: async actors
        run everything on the loop). Plain actors call on the pool thread."""
        if method_name == "__ray_call__":
            # fn(instance, *args, **kwargs) — arbitrary code against the
            # actor (reference: ray's injected __ray_call__); used by
            # create_collective_group and compiled-DAG exec loops
            method = functools.partial(_ray_call_shim, self.instance)
        else:
            method = getattr(self.instance, method_name)
        if not self.is_async:
            return lambda args, kwargs: method(*args, **kwargs)
        import asyncio

        async def _invoke(args, kwargs):
            if inspect.iscoroutinefunction(method):
                return await method(*args, **kwargs)
            return method(*args, **kwargs)

        def call(args, kwargs):
            fut = asyncio.run_coroutine_threadsafe(_invoke(args, kwargs), self._loop)
            return fut.result()

        return call

    def submit(self, payload: dict) -> bool:
        """Accept-or-refuse atomically: a task that passes the dead
        gate is in ``inflight`` before the gate can flip, so DrainActor
        either waits for it or the caller re-resolves — never neither."""
        with self.lock:
            if self.dead:
                return False
            self.inflight.add(payload["task_id"])
        try:
            self.pool.submit(self._run, payload)
        except RuntimeError:  # pool shut down by a concurrent hard kill
            with self.lock:
                self.inflight.discard(payload["task_id"])
            return False
        return True

    def submit_batch(self, payloads: List[dict]) -> bool:
        """Atomic batched accept (see submit): the dead gate is checked
        once for the whole batch under the lock."""
        with self.lock:
            if self.dead:
                return False
            for p in payloads:
                self.inflight.add(p["task_id"])
        try:
            for p in payloads:
                self.pool.submit(self._run, p)
        except RuntimeError:
            with self.lock:
                for p in payloads:
                    self.inflight.discard(p["task_id"])
            return False
        return True

    def query(self, task_id_bin: bytes) -> dict:
        with self.lock:
            if task_id_bin in self.results:
                result = self.results.pop(task_id_bin)
                return {
                    "status": "done",
                    "returns": result["returns"],
                    "streaming_done": result.get("streaming_done"),
                    "stream_error": result.get("stream_error"),
                    "failed": bool(result.get("retriable_error")
                                   or result.get("stream_error")),
                }
            if task_id_bin in self.inflight:
                return {"status": "running"}
        return {"status": "unknown"}

    def _run(self, payload: dict) -> None:
        if payload.get("streaming"):
            result = _execute_streaming(
                getattr(self.instance, payload["method_name"]),
                payload["args"],
                payload["kwargs"],
                TaskID(payload["task_id"]),
                payload["method_name"],
                tuple(payload["caller_addr"]),
                actor_id=ActorID.from_hex(payload["actor_id"]),
                trace_ctx=payload.get("trace_ctx"),
                submit_ts=payload.get("submit_ts", 0.0),
            )
        else:
            result = _execute_callable(
                self._call_method(payload["method_name"]),
                payload["args"],
                payload["kwargs"],
                payload["num_returns"],
                TaskID(payload["task_id"]),
                payload["method_name"],
                actor_id=ActorID.from_hex(payload["actor_id"]),
                caller_addr=tuple(payload["caller_addr"]),
                trace_ctx=payload.get("trace_ctx"),
                submit_ts=payload.get("submit_ts", 0.0),
            )
        task_bin = payload["task_id"]
        with self.lock:
            self.inflight.discard(task_bin)
            self.results[task_bin] = result
            while len(self.results) > self._RESULT_CACHE_MAX:
                self.results.popitem(last=False)
        # hand the push to the shared deliverer: the execution thread must
        # NOT block on a result round-trip (a 1-thread actor would
        # serialize every call behind its predecessor's delivery), and
        # batching pushes per caller costs one RPC per batch, not per task
        _deliverer().deliver(self, tuple(payload["caller_addr"]), task_bin, {
            "task_id_bin": task_bin,
            "returns": result["returns"],
            "dropped_borrows": result.get("dropped_borrows") or [],
            # streaming methods: the done RPC is the reliable finalizer
            # in case the StreamingDone push was lost
            "streaming_done": result.get("streaming_done"),
            "stream_error": result.get("stream_error"),
            "failed": bool(result.get("retriable_error")
                           or result.get("stream_error")),
        })


class _ResultDeliverer:
    """Asynchronous, batched ActorTasksDone delivery (reference: the
    direct worker→owner reply path of PushTask, core_worker.cc:3315 —
    replies ride the io_context, never an execution thread).

    Execution threads enqueue results; one drain task per caller on the
    worker's io loop sends them in batches. On delivery failure after
    retries the result stays in the runner's cache for the caller's
    requery to collect."""

    _MAX_BATCH = 64
    _DELIVERY_ATTEMPTS = 4

    def __init__(self, loop_thread):
        self._loop = loop_thread.loop
        self._queues: Dict[Tuple[str, int], list] = {}
        self._draining: set = set()

    def deliver(self, runner: "_ActorRunner", caller_addr: Tuple[str, int],
                task_bin: bytes, result_kwargs: dict) -> None:
        import asyncio

        def _enqueue():
            self._queues.setdefault(caller_addr, []).append(
                (runner, task_bin, result_kwargs))
            if caller_addr not in self._draining:
                self._draining.add(caller_addr)
                asyncio.ensure_future(self._drain(caller_addr))

        self._loop.call_soon_threadsafe(_enqueue)

    async def _drain(self, addr: Tuple[str, int]) -> None:
        try:
            while True:
                q = self._queues.get(addr)
                if not q:
                    return  # no await between this check and finally:
                    # a racing _enqueue can't slip past the discard
                batch = q[: self._MAX_BATCH]
                del q[: self._MAX_BATCH]
                await self._send(addr, batch)
        finally:
            self._draining.discard(addr)

    async def _send(self, addr: Tuple[str, int], batch: list) -> None:
        import asyncio

        delay = 0.5
        for attempt in range(self._DELIVERY_ATTEMPTS):
            try:
                await get_client(addr).acall(
                    "ActorTasksDone",
                    results=[kw for _, _, kw in batch], timeout=30)
            except Exception as e:  # noqa: BLE001
                if attempt == self._DELIVERY_ATTEMPTS - 1:
                    # leave results cached; the caller's requery will
                    # collect them if the caller is still alive
                    logger.warning(
                        "could not deliver %d actor task result(s) to "
                        "%s: %s", len(batch), addr, e)
                    return
                await asyncio.sleep(delay)
                delay *= 2
            else:
                for runner, task_bin, _ in batch:
                    with runner.lock:
                        runner.results.pop(task_bin, None)
                return


_DELIVERER: Optional[_ResultDeliverer] = None
_DELIVERER_LOCK = threading.Lock()


def _deliverer() -> _ResultDeliverer:
    with _DELIVERER_LOCK:
        global _DELIVERER
        if _DELIVERER is None:
            _DELIVERER = _ResultDeliverer(
                worker_mod.global_worker.core.loop_thread)
        return _DELIVERER


def _resolve_args(packed_args: List[dict], packed_kwargs: Dict[str, dict]) -> Tuple[tuple, dict]:
    w = worker_mod.global_worker
    args = []
    for a in packed_args:
        kind, v = _unpack_arg(a)
        if kind == "__ref__":
            args.append(w.core.get([v])[0])
        else:
            args.append(deserialize(v))
    kwargs = {}
    for k, a in packed_kwargs.items():
        kind, v = _unpack_arg(a)
        kwargs[k] = w.core.get([v])[0] if kind == "__ref__" else deserialize(v)
    return tuple(args), kwargs


def _execute_callable(
    fn,
    packed_args: List[dict],
    packed_kwargs: Dict[str, dict],
    num_returns: int,
    task_id: TaskID,
    name: str,
    actor_id: Optional[ActorID] = None,
    caller_addr: Optional[Tuple[str, int]] = None,
    trace_ctx=None,
    submit_ts: float = 0.0,
) -> dict:
    """Run user code; package returns (inline small / shared-memory big).

    The propagated trace context is activated for the WHOLE body — not
    just the user-code span — so the worker-side bus gates record the
    RUNNING transition and result-packaging object events too."""
    with obs_tracing.activated(trace_ctx):
        return _execute_callable_body(
            fn, packed_args, packed_kwargs, num_returns, task_id, name,
            actor_id, caller_addr, submit_ts)


def _execute_callable_body(
    fn,
    packed_args: List[dict],
    packed_kwargs: Dict[str, dict],
    num_returns: int,
    task_id: TaskID,
    name: str,
    actor_id: Optional[ActorID],
    caller_addr: Optional[Tuple[str, int]],
    submit_ts: float,
) -> dict:
    from ray_tpu_torch._private.serialization import collect_object_refs

    kind = "actor_task" if actor_id else "task"
    w = worker_mod.global_worker
    w.set_task_context(task_id, actor_id)
    # execution start: gives the timeline its queued-vs-running split
    # (reference: task_event_buffer.h RUNNING state transition)
    try:
        w.core._record_task_event(task_id, name, "RUNNING", kind=kind)
        if submit_ts:
            _queue_wait_histogram().observe(
                max(0.0, time.time() - submit_ts), tags={"kind": kind})
    except Exception:  # noqa: BLE001
        pass
    all_borrows: List[tuple] = []  # every AddBorrower sent for this task
    try:
        args, kwargs = _resolve_args(packed_args, packed_kwargs)
        # the active (propagated) context makes this execution a child
        # span of the caller's active span (cross-process parenting);
        # untraced tasks fall straight through
        with obs_tracing.span(
                name, kind=kind, attrs={"task_id": task_id.hex()}):
            result = fn(args, kwargs)
        if num_returns == 1:
            values = [result]
        else:
            values = list(result)
            if len(values) != num_returns:
                raise ValueError(f"expected {num_returns} return values, got {len(values)}")
        from ray_tpu_torch._private.serialization import serialize_prepare

        returns = []
        for i, v in enumerate(values):
            with collect_object_refs() as col:
                sv = serialize_prepare(v)
            # refs nested in the return value: register the CALLER as
            # borrower with each owner BEFORE replying, while our own
            # refs still pin the objects (reference_counter.h:44 —
            # borrower handoff on task return). The registered handoffs
            # ride back in the reply ("borrows") so the caller can
            # deregister any it never claims by deserializing (advisor
            # finding, round 1: unclaimed handoffs pinned forever).
            borrows = []
            if col.refs and caller_addr is not None:
                for r in col.refs:
                    owner = r.owner_address or w.core.address
                    if tuple(owner) == tuple(caller_addr):
                        continue  # caller owns it already
                    try:
                        rep = get_client(tuple(owner)).call(
                            "AddBorrower",
                            object_id_bin=r.id().binary(),
                            borrower=tuple(caller_addr),
                            timeout=10,
                        )
                        entry = (
                            r.id().binary(), tuple(owner),
                            (rep or {}).get("epoch") or 0,
                        )
                        borrows.append(entry)
                        all_borrows.append(entry)
                    except Exception:
                        pass
            try:
                if sv.total <= config.object_store_inline_max_bytes:
                    returns.append({"kind": "inline",
                                    "data": sv.to_bytes(copy_path="inline"),
                                    "borrows": borrows})
                else:
                    oid = ObjectID.from_index(task_id, i + 1)
                    # big returns go straight into the reserved mapping
                    # (Create → write-in-place → Seal): 0 payload copies
                    w.core._plasma_put_segments(oid, sv)
                    # big returns bypass put_serialized, so the bus event is
                    # recorded here (executor-side, gated on the activated
                    # trace context like every worker event)
                    if obs_tracing.active():
                        obs_events.record_event(
                            "object_put", size=sv.total,
                            job_id=w.core.job_id.hex(), inline=False)
                    returns.append(
                        {"kind": "plasma", "node_id": w.core.node_id,
                         "borrows": borrows}
                    )
            finally:
                sv.release()
        return {"returns": returns}
    except BaseException as e:  # noqa: BLE001
        tb = traceback.format_exc()
        err = RayTaskError(name, tb, e if isinstance(e, Exception) else None)
        data = serialize(err)
        return {
            "returns": [{"kind": "inline", "data": data} for _ in range(num_returns)],
            "retriable_error": True,
            # borrows registered before the failure (e.g. value 0 packaged,
            # value 1 raised): report them so the caller's ledger can
            # deregister — the error reply drops the values they rode in on
            "dropped_borrows": all_borrows,
        }
    finally:
        w.set_task_context(None, None)


def _execute_streaming(
    fn,
    packed_args: List[dict],
    packed_kwargs: Dict[str, dict],
    task_id: TaskID,
    name: str,
    caller_addr: Tuple[str, int],
    actor_id: Optional[ActorID] = None,
    trace_ctx=None,
    submit_ts: float = 0.0,
) -> dict:
    """Run a generator task, pushing one StreamingYield per value to the
    caller as it is produced (reference: task_manager.cc:778 generator
    item returns). The per-yield ack is the backpressure: the generator
    does not advance until the caller has registered the previous item."""
    w = worker_mod.global_worker
    w.set_task_context(task_id, actor_id)
    if submit_ts:
        try:
            _queue_wait_histogram().observe(
                max(0.0, time.time() - submit_ts),
                tags={"kind": "actor_task" if actor_id else "task"})
        except Exception:  # noqa: BLE001
            pass
    client = get_client(tuple(caller_addr))
    idx = 0
    try:
        args, kwargs = _resolve_args(packed_args, packed_kwargs)
        with obs_tracing.inbound_span(
                trace_ctx, name=name,
                kind="actor_task" if actor_id else "task",
                attrs={"task_id": task_id.hex(), "streaming": True}):
            from ray_tpu_torch._private.serialization import serialize_prepare

            for value in fn(*args, **kwargs):
                sv = serialize_prepare(value)
                try:
                    if sv.total <= config.object_store_inline_max_bytes:
                        rep = client.call(
                            "StreamingYield", task_id_bin=task_id.binary(),
                            index=idx, kind="inline",
                            data=sv.to_bytes(copy_path="inline"),
                            timeout=60,
                        )
                    else:
                        oid = ObjectID.from_index(task_id, idx + 1)
                        w.core._plasma_put_segments(oid, sv)
                        if obs_tracing.active():
                            obs_events.record_event(
                                "object_put", size=sv.total,
                                job_id=w.core.job_id.hex(), inline=False)
                        rep = client.call(
                            "StreamingYield", task_id_bin=task_id.binary(),
                            index=idx, kind="plasma", node_id=w.core.node_id,
                            timeout=60,
                        )
                finally:
                    sv.release()
                if not (rep or {}).get("ok", True):
                    break  # consumer abandoned the stream — stop producing
                idx += 1
                # consumer backpressure: pause while the un-consumed buffer
                # on the caller is deep (reference: generator_backpressure_
                # num_objects); the registration ack alone doesn't bound it
                limit = config.streaming_generator_buffer_size
                while (rep or {}).get("pending", 0) >= limit:
                    time.sleep(0.02)
                    try:
                        rep = client.call(
                            "StreamingCredit", task_id_bin=task_id.binary(),
                            timeout=30,
                        )
                    except Exception:  # noqa: BLE001
                        break
                    if not rep.get("ok", True):
                        rep = {"ok": False}
                        break
                if not (rep or {}).get("ok", True):
                    break
        done = {"count": idx, "error": None}
    except BaseException as e:  # noqa: BLE001
        tb = traceback.format_exc()
        err = RayTaskError(name, tb, e if isinstance(e, Exception) else None)
        done = {"count": idx, "error": serialize(err)}
    finally:
        w.set_task_context(None, None)
    try:
        client.call(
            "StreamingDone", task_id_bin=task_id.binary(),
            count=done["count"], error=done["error"], timeout=60,
        )
    except Exception:  # noqa: BLE001 — the reply carries the same info
        pass
    reply = {"returns": [], "streaming_done": done["count"]}
    if done["error"] is not None:
        reply["stream_error"] = done["error"]
    return reply


class WorkerServer:
    def __init__(self, core: CoreWorker, raylet_addr: Tuple[str, int], worker_id: str):
        self.core = core
        self.worker_id = worker_id
        self.raylet_addr = raylet_addr
        # the node's visible cards, read before any lease narrows them
        # ([] = all): a lease's card ids index this list
        self._node_visible = [
            v for v in os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",") if v]
        self.actors: Dict[str, _ActorRunner] = {}
        self._task_pool = ThreadPoolExecutor(max_workers=8, thread_name_prefix="exec")
        from collections import OrderedDict

        # bytes -> fn, LRU-bounded: each entry pins the full cloudpickle
        # byte string as its key, so an unbounded dict would grow with
        # every distinct closure this worker ever ran
        self._function_cache: Any = OrderedDict()
        self._fn_by_key: Any = OrderedDict()  # content hash -> fn (LRU)
        # task_id bin -> executing thread ident, for CancelTask; the lock
        # makes register/raise/unregister mutually exclusive so a cancel
        # cannot target a thread that already moved on to another task
        self._running_tasks: Dict[bytes, int] = {}
        self._cancel_lock = threading.Lock()
        # node drain recall: once set, task pushes are refused with a
        # node_draining reply — the caller returns the warm lease and
        # re-leases elsewhere for free, so a sustained task stream
        # doesn't pin its lease to the dying node for the full deadline
        self._node_draining = False
        core.server.register("NotifyNodeDraining", self.NotifyNodeDraining,
                             inline=True)
        core.server.register("PushTask", self.PushTask)
        core.server.register("PushTaskBatch", self.PushTaskBatch)
        core.server.register("CancelTask", self.CancelTask)
        core.server.register("CreateActor", self.CreateActor)
        # enqueue-and-ack handlers only append to the runner's pool queue:
        # inline (no executor handoff) — the ack is on the wire the same
        # loop tick the push frame decodes
        # single-item fallback of PushActorTasks — raycheck: disable=RC003
        core.server.register("PushActorTask", self.PushActorTask,
                             inline=True)
        core.server.register("PushActorTasks", self.PushActorTasks,
                             inline=True)
        core.server.register("QueryActorTaskResult",
                             self.QueryActorTaskResult, inline=True)
        core.server.register("KillActor", self.KillActor)
        core.server.register("DrainActor", self.DrainActor)
        core.server.register("SetLeaseContext", self.SetLeaseContext)
        # operator/debug endpoint: ask a worker to exit gracefully out of
        # band (the raylet path signals instead) — raycheck: disable=RC003
        core.server.register("Exit", self.Exit)

    # -- lease context: assign cards before user code runs ---------------
    def SetLeaseContext(self, lease_id: str, gpu_ids: List[int], resources: Dict[str, float]) -> dict:
        """Pin the lease's cards: CUDA_VISIBLE_DEVICES lists them (through
        the visible list the worker inherited, if any), or is empty for a
        lease with none, as Ray hides every card from a task that asks for
        none. The raylet leases a worker only the card set of its first
        lease, so this never changes what an initialized CUDA sees."""
        from ray_tpu_torch.accelerators.gpu import NvidiaGPUAcceleratorManager

        if resources.get("GPU") and len(gpu_ids) < int(resources["GPU"]):
            raise RuntimeError(
                f"lease {lease_id[:8]} asks for {resources['GPU']} cards and "
                f"was given ids {list(gpu_ids)}")
        node = self._node_visible
        if node and any(i >= len(node) for i in gpu_ids):
            raise RuntimeError(
                f"card ids {list(gpu_ids)} past the {len(node)} cards this node "
                f"sees (CUDA_VISIBLE_DEVICES={','.join(node)})")
        NvidiaGPUAcceleratorManager.set_current_process_visible_accelerator_ids(
            [node[i] if node else str(i) for i in gpu_ids])
        w = worker_mod.global_worker
        w.assigned_resources = dict(resources)
        w.assigned_resources["gpu_ids"] = list(gpu_ids)
        w.current_lease_id = lease_id
        return {"ok": True}

    @staticmethod
    def _apply_py_paths(paths) -> None:
        import sys

        for p in paths or []:
            if p not in sys.path:
                sys.path.append(p)

    def _apply_runtime_env(self, env) -> None:
        """Apply a prepared runtime env (env_vars / working_dir /
        py_modules packages) — idempotent per env hash; marks this
        worker like the reference's env-dedicated workers."""
        if not env:
            return
        import tempfile

        from ray_tpu_torch._private import runtime_env as rt

        cache = os.path.join(tempfile.gettempdir(), "ray_tpu_rtenv")
        os.makedirs(cache, exist_ok=True)
        try:
            rt.apply_runtime_env(env, self.core.gcs, cache)
        except Exception:  # noqa: BLE001
            logger.exception("runtime_env application failed")
            raise

    # -- normal tasks ---------------------------------------------------
    _FN_KEY_CACHE_MAX = 512
    _FN_BYTES_CACHE_MAX = 64

    def _resolve_function(self, spec_payload: dict):
        """Function bytes ship once per worker: later pushes carry only
        ``function_key`` (content hash of the cloudpickle bytes) and hit
        the key cache (reference: the function table exported through
        the GCS once per job, _private/function_manager.py). Returns
        (fn, None) or (None, error_reply)."""
        key = spec_payload.get("function_key")
        fn_bytes = spec_payload.get("serialized_function")
        if fn_bytes is None:
            fn = self._fn_by_key.get(key)
            if fn is None:
                # evicted (or a restarted worker the driver mistook for
                # warm): ask for the bytes instead of failing the task
                return None, {"need_function": True}
            self._fn_by_key.move_to_end(key)
            return fn, None
        fn = self._function_cache.get(fn_bytes)
        if fn is not None:
            self._function_cache.move_to_end(fn_bytes)
        else:
            try:
                fn = loads_function(fn_bytes)
            except BaseException as e:  # noqa: BLE001
                err = serialize(
                    RayTaskError(
                        spec_payload["function_name"],
                        f"Failed to deserialize the remote function: "
                        f"{type(e).__name__}: {e}\n{traceback.format_exc()}",
                    )
                )
                if spec_payload.get("streaming"):
                    # streams have no return slots: surface via stream error
                    return None, {"returns": [], "streaming_done": 0,
                                  "stream_error": err}
                return None, {
                    "returns": [
                        {"kind": "inline", "data": err}
                        for _ in range(spec_payload["num_returns"])
                    ]
                }
            self._function_cache[fn_bytes] = fn
            while len(self._function_cache) > self._FN_BYTES_CACHE_MAX:
                self._function_cache.popitem(last=False)
        if key:
            self._fn_by_key[key] = fn
            self._fn_by_key.move_to_end(key)
            while len(self._fn_by_key) > self._FN_KEY_CACHE_MAX:
                self._fn_by_key.popitem(last=False)
        return fn, None

    def NotifyNodeDraining(self) -> dict:
        self._node_draining = True
        return {"ok": True}

    def PushTask(self, spec_payload: dict) -> dict:
        if self._node_draining and not spec_payload.get("drain_final"):
            # drain_final marks work that was leased HERE before the
            # drain and cannot run anywhere else — the drain deadline
            # exists so exactly this work can finish; refuse the rest
            return {"node_draining": True}
        self._apply_py_paths(spec_payload.get("py_paths"))
        self._apply_runtime_env(spec_payload.get("runtime_env"))
        fn, err_reply = self._resolve_function(spec_payload)
        if err_reply is not None:
            return err_reply
        caller_addr = spec_payload.get("caller_addr")
        if spec_payload.get("streaming"):
            fut = self._task_pool.submit(
                _execute_streaming,
                fn,
                spec_payload["args"],
                spec_payload["kwargs"],
                TaskID(spec_payload["task_id"]),
                spec_payload["function_name"],
                tuple(caller_addr),
                trace_ctx=spec_payload.get("trace_ctx"),
                submit_ts=spec_payload.get("submit_ts", 0.0),
            )
            return fut.result()
        task_bin = spec_payload["task_id"]

        def _runner():
            with self._cancel_lock:
                self._running_tasks[task_bin] = threading.get_ident()
            task_hex = bytes(task_bin).hex() if obs_timeline.enabled() \
                else ""
            if task_hex:
                obs_timeline.mark_task(task_hex, "run_start")
            try:
                return _execute_callable(
                    lambda args, kwargs: fn(*args, **kwargs),
                    spec_payload["args"],
                    spec_payload["kwargs"],
                    spec_payload["num_returns"],
                    TaskID(task_bin),
                    spec_payload["function_name"],
                    None,
                    tuple(caller_addr) if caller_addr else None,
                    trace_ctx=spec_payload.get("trace_ctx"),
                    submit_ts=spec_payload.get("submit_ts", 0.0),
                )
            finally:
                if task_hex:
                    obs_timeline.mark_task(task_hex, "run_end")
                with self._cancel_lock:
                    self._running_tasks.pop(task_bin, None)

        return self._task_pool.submit(_runner).result()

    def PushTaskBatch(self, spec_payloads: list) -> dict:
        """Execute a batch of queued same-class tasks serially in one
        RPC roundtrip (reference: the raylet's lease reuse amortizes
        scheduling, but each reference task still pays one PushTask RPC
        — batching amortizes the roundtrip too, which dominates for
        small tasks).

        Each task's reply is pushed to the caller the moment it
        finishes (oneway ``NormalTaskDone``) so an early result is
        visible to ``ray.wait`` while later batch members still run;
        the positional ``replies`` in the final return are the reliable
        fallback for a lost push — the caller claims each (task,
        attempt) exactly once."""
        if self._node_draining and \
                not all(p.get("drain_final") for p in spec_payloads):
            return {"node_draining": True}
        replies = []
        for p in spec_payloads:
            r = self.PushTask(p)
            replies.append(r)
            addr = p.get("caller_addr")
            if addr and not r.get("need_function") \
                    and not r.get("node_draining"):
                try:
                    get_client(tuple(addr)).call_oneway(
                        "NormalTaskDone",
                        task_id_bin=p["task_id"],
                        attempt_number=p.get("attempt_number", 0),
                        reply=r,
                    )
                except Exception:  # noqa: BLE001 — fallback is the reply
                    pass
        return {"replies": replies}

    def CancelTask(self, task_id_bin: bytes, force: bool = False) -> dict:
        """Interrupt a RUNNING task (reference: CoreWorker::HandleCancelTask,
        core_worker.cc CancelTask). Non-force raises TaskCancelledError in
        the executing thread at its next bytecode boundary; force kills the
        worker process.

        The register/raise/unregister critical sections share _cancel_lock,
        so the raise only targets a thread still registered for THIS task.
        (As in the reference's Python-level cancel, delivery is
        asynchronous: a task finishing in the same instant can see the
        exception surface in its packaging code — the caller discards that
        reply since its returns are already poisoned.)"""
        from ray_tpu_torch.exceptions import TaskCancelledError

        if force:
            threading.Timer(0.05, lambda: os._exit(1)).start()
            return {"ok": True, "forced": True}
        import ctypes

        with self._cancel_lock:
            ident = self._running_tasks.get(bytes(task_id_bin))
            if ident is None:
                return {"ok": False, "running": False}
            n = ctypes.pythonapi.PyThreadState_SetAsyncExc(
                ctypes.c_ulong(ident), ctypes.py_object(TaskCancelledError)
            )
            if n > 1:  # hit more than one thread: undo
                ctypes.pythonapi.PyThreadState_SetAsyncExc(ctypes.c_ulong(ident), None)
        return {"ok": n == 1}

    # -- actors ---------------------------------------------------------
    def CreateActor(self, actor_id: str, serialized_spec: bytes) -> dict:
        import pickle

        if obs_timeline.enabled():
            # marked at CreateActor ARRIVAL, not backdated to fork: a
            # prestarted/pooled worker's spawn predates the actor's
            # whole lifecycle and would scramble the phase order.
            # spawn_age_s distinguishes the two offline — near-zero
            # means this lease paid for a cold fork+boot.
            spawned = os.environ.get("RAY_TPU_WORKER_SPAWNED_MONO")
            obs_timeline.mark_actor(
                actor_id, "worker_started",
                spawn_age_s=round(time.monotonic() - float(spawned), 3)
                if spawned else None)
        spec = pickle.loads(serialized_spec)
        self._apply_py_paths(spec.get("py_paths"))
        try:
            self._apply_runtime_env(spec.get("runtime_env"))
            cls = loads_function(spec["serialized_class"])
            args, kwargs = _resolve_args(spec["args"], spec["kwargs"])
            instance = cls(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001
            return {"ok": False, "error": f"{type(e).__name__}: {e}\n{traceback.format_exc()}"}
        obs_timeline.mark_actor(actor_id, "init_done")
        self.actors[actor_id] = _ActorRunner(actor_id, instance, spec.get("max_concurrency", 1))
        return {"ok": True}

    def PushActorTask(self, payload: dict) -> dict:
        """Enqueue-and-ack: execution result goes back via ActorTaskDone."""
        runner = self.actors.get(payload["actor_id"])
        if runner is None or not runner.submit(payload):
            return {"accepted": False}
        return {"accepted": True}

    def PushActorTasks(self, payloads: List[dict]) -> dict:
        """Batched enqueue-and-ack (one RPC per caller batch): payloads
        enqueue in list order, preserving per-caller submission order.
        All-or-nothing: if the batch races the drain gate, nothing is
        enqueued and the caller re-resolves the whole batch — a partial
        accept would double-run the accepted prefix elsewhere."""
        if not payloads:
            return {"accepted": True}
        runner = self.actors.get(payloads[0]["actor_id"])
        if runner is None or not runner.submit_batch(payloads):
            return {"accepted": False}
        return {"accepted": True}

    def QueryActorTaskResult(self, actor_id: str, task_id_bin: bytes) -> dict:
        """Recovery path for a lost ActorTaskDone push."""
        runner = self.actors.get(actor_id)
        if runner is None:
            return {"status": "unknown"}
        return runner.query(task_id_bin)

    def DrainActor(self, actor_id: str, timeout_s: float = 30.0) -> dict:
        """Graceful actor handoff for a draining node: stop accepting
        new tasks (PushActorTasks answers accepted=False, so callers
        re-resolve to the restarted incarnation) and wait for every
        ACCEPTED task to finish — their results are still delivered /
        queryable, so a drain loses no in-flight actor call. The GCS
        restarts the actor elsewhere only after this returns."""
        runner = self.actors.get(actor_id)
        if runner is None:
            return {"ok": True, "absent": True}
        with runner.lock:  # atomic with submit's accept (see submit)
            runner.dead = True  # gates acceptance only; the pool keeps running
        deadline = time.monotonic() + max(0.0, timeout_s)
        while time.monotonic() < deadline:
            with runner.lock:
                if not runner.inflight:
                    break
            time.sleep(0.02)
        with runner.lock:
            leftover = len(runner.inflight)
        return {"ok": True, "drained": leftover == 0, "inflight": leftover}

    def KillActor(self, actor_id: str) -> dict:
        runner = self.actors.get(actor_id)
        if runner is not None:
            with runner.lock:
                runner.dead = True
            runner.pool.shutdown(wait=False, cancel_futures=True)
            # keep the runner REGISTERED: its results cache must stay
            # queryable while ActorTaskDone pushes are still in flight.
            # Popping it here turned a racing lost delivery into an
            # authoritative-looking "unknown" from a live worker — the
            # caller then failed a task whose result actually existed
            # (flaked test_actor_restarts_elsewhere_on_drain). The
            # process exit below is what frees everything.
            # a dedicated-actor worker exits so its resources free up
            if all(r.dead for r in self.actors.values()):
                threading.Timer(0.5, lambda: os._exit(0)).start()
        return {"ok": True}

    def Exit(self) -> dict:
        threading.Timer(0.1, lambda: os._exit(0)).start()
        return {"ok": True}


def main() -> None:
    logging.basicConfig(level="INFO", format="[worker] %(levelname)s %(message)s")
    worker_id = os.environ["RAY_TPU_WORKER_ID"]
    raylet_host, raylet_port = os.environ["RAY_TPU_RAYLET_ADDR"].rsplit(":", 1)
    gcs_host, gcs_port = os.environ["RAY_TPU_GCS_ADDR"].rsplit(":", 1)
    store_socket = os.environ["RAY_TPU_STORE_SOCKET"]
    node_id = os.environ["RAY_TPU_NODE_ID"]
    config.from_json(os.environ.get("RAY_TPU_CONFIG_JSON", "{}"))

    w = worker_mod.Worker()
    w.mode = worker_mod.WORKER_MODE
    worker_mod.global_worker = w

    core = CoreWorker(
        gcs_addr=(gcs_host, int(gcs_port)),
        raylet_addr=(raylet_host, int(raylet_port)),
        store_socket=store_socket,
        node_id=node_id,
        job_id=JobID.from_int(0),
        is_driver=False,
        worker_id_hex=worker_id,
    )
    w.core = core
    w.reference_counter.set_on_zero_callback(core.free_object)
    WorkerServer(core, (raylet_host, int(raylet_port)), worker_id)

    # process-lifetime client: the raylet owns this process and the
    # block-forever wait below never falls through —
    # raycheck: disable=RC006
    raylet = RpcClient(raylet_host, int(raylet_port), core.loop_thread)
    reply = raylet.call_retrying("RegisterWorker", worker_id=worker_id, addr=core.address)
    if not reply.get("ok"):
        logger.error("raylet rejected registration")
        raylet.close()
        return
    logger.info("worker %s serving at %s", worker_id[:8], core.address)

    # block forever; raylet owns our lifetime
    threading.Event().wait()


if __name__ == "__main__":
    main()
