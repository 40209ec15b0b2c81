"""LocalModeRuntime — in-process execution backend (copy of
ray_tpu/_private/local_mode.py, advertising the cards where JAX's
advertises TPU chips).

Reference analogue: python/ray/_private/worker.py LOCAL_MODE. Tasks run on a
thread pool, actors get a dedicated serial executor (or a pool of
``max_concurrency`` threads), objects live in the in-process memory store.
Used by ``init(local_mode=True)`` and as the substrate for unit tests that
don't need process isolation.
"""

from __future__ import annotations

import inspect
import threading
import traceback
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private.core import ActorOptions, CoreRuntime, TaskOptions
from ray_tpu_torch._private.ids import ActorID, JobID, NodeID, ObjectID, TaskID
from ray_tpu_torch._private.memory_store import MemoryStore
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch.accelerators.gpu import NvidiaGPUAcceleratorManager
from ray_tpu_torch.exceptions import (
    ActorDiedError,
    RayActorError,
    RayTaskError,
    TaskCancelledError,
)


class _LocalActor:
    def __init__(self, actor_id: ActorID, cls, args, kwargs, opts: ActorOptions):
        self.actor_id = actor_id
        self.opts = opts
        self.dead = False
        from ray_tpu_torch._private.async_compat import (
            ASYNC_ACTOR_DEFAULT_CONCURRENCY,
            has_async_methods,
        )

        self.is_async = has_async_methods(cls)
        n_workers = max(1, opts.max_concurrency)
        if self.is_async and n_workers == 1:
            n_workers = ASYNC_ACTOR_DEFAULT_CONCURRENCY
        self.executor = ThreadPoolExecutor(
            max_workers=n_workers, thread_name_prefix=f"actor-{actor_id.hex()[:8]}"
        )
        self._loop = None
        self._loop_lock = threading.Lock()
        self.instance = None
        self.init_error: Optional[BaseException] = None
        self._init_done = threading.Event()

        def _init():
            try:
                self.instance = cls(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001
                self.init_error = e
            finally:
                self._init_done.set()

        self.executor.submit(_init)

    def run_call(self, method, args, kwargs):
        """Asyncio actor: EVERY method runs on the actor's event loop —
        coroutines overlap, sync methods serialize on the loop thread
        (single-threaded actor state stays safe)."""
        import asyncio

        with self._loop_lock:
            if self._loop is None:
                self._loop = asyncio.new_event_loop()
                threading.Thread(
                    target=self._loop.run_forever, daemon=True,
                    name=f"actor-loop-{self.actor_id.hex()[:8]}",
                ).start()

        async def _invoke():
            if inspect.iscoroutinefunction(method):
                return await method(*args, **kwargs)
            return method(*args, **kwargs)

        fut = asyncio.run_coroutine_threadsafe(_invoke(), self._loop)
        return fut.result()

    def wait_ready(self, timeout=None) -> None:
        self._init_done.wait(timeout)
        if self.init_error is not None:
            raise self.init_error


class LocalModeRuntime(CoreRuntime):
    def __init__(self, resources: Optional[Dict[str, float]] = None, num_cpus: float = 8,
                 num_gpus: Optional[float] = None):
        self.job_id = JobID.from_int(1)
        self.node_id = NodeID.from_random()
        self.store = MemoryStore()
        self._pool = ThreadPoolExecutor(max_workers=64, thread_name_prefix="task")
        self._actors: Dict[ActorID, _LocalActor] = {}
        self._named_actors: Dict[Tuple[str, str], ActorID] = {}
        self._cancelled: set = set()
        self._task_for_ref: Dict[ObjectID, TaskID] = {}
        self._streams: Dict[TaskID, Any] = {}  # streaming generator states
        self.address = None  # local refs need no owner address
        self._lock = threading.Lock()
        self._resources: Dict[str, float] = {"CPU": float(num_cpus)}
        if resources:
            self._resources.update(resources)
        # detect local cards so num_gpus=n works in local mode; the runtime
        # picks no device: tasks and actors run what they run
        n = num_gpus if num_gpus is not None else \
            NvidiaGPUAcceleratorManager.get_current_node_num_accelerators()
        if n and "GPU" not in self._resources:
            self._resources["GPU"] = float(n)

    # ------------------------------------------------------------------
    def put(self, value: Any) -> ObjectRef:
        w = worker_mod.global_worker
        oid = ObjectID.from_index(w.current_task_id, w.next_put_index())
        self.store.put(oid, value)
        w.reference_counter.add_owned_object(oid)
        return ObjectRef(oid)

    def get(self, refs: Sequence[ObjectRef], timeout: Optional[float] = None) -> List[Any]:
        import time as _time

        deadline = None if timeout is None else _time.monotonic() + timeout
        out = []
        for r in refs:
            remaining = None if deadline is None else max(0.0, deadline - _time.monotonic())
            try:
                v = self.store.get(r.id(), timeout=remaining)
            except RayTaskError as e:
                raise e.as_instanceof_cause()
            out.append(v)
        return out

    def wait(self, refs, num_returns, timeout, fetch_local=True):
        futures = [(r, self.store.as_future(r.id())) for r in refs]
        ready: List[ObjectRef] = []
        done_evt = threading.Event()

        def _on_done(_f):
            done_evt.set()

        for _, f in futures:
            f.add_done_callback(_on_done)
        import time

        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            ready = [r for r, f in futures if f.done()]
            if len(ready) >= num_returns:
                ready = ready[:num_returns]
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
            done_evt.clear()
            wait_t = 0.05 if deadline is None else min(0.05, max(0.0, deadline - time.monotonic()))
            done_evt.wait(wait_t)
        ready_set = {id(r) for r in ready}
        not_ready = [r for r in refs if id(r) not in ready_set]
        return ready, not_ready

    def as_future(self, ref: ObjectRef) -> Future:
        return self.store.as_future(ref.id())

    def free_object(self, oid: ObjectID) -> None:
        self.store.delete(oid)
        self._task_for_ref.pop(oid, None)

    def _abandon_stream(self, task_id: TaskID) -> None:
        st = self._streams.pop(task_id, None)
        if st is None:
            return
        with st.cv:
            oids = list(st.arrived.values())
            st.arrived.clear()
            if st.total is None:
                st.total = st.next_index
            st.cv.notify_all()
        for oid in oids:
            self.free_object(oid)

    # ------------------------------------------------------------------
    def _resolve_args(self, args, kwargs):
        def _res(v):
            if isinstance(v, ObjectRef):
                return self.get([v])[0]
            return v

        return tuple(_res(a) for a in args), {k: _res(v) for k, v in kwargs.items()}

    def _store_returns(self, return_ids: List[ObjectID], result: Any, num_returns: int):
        if num_returns == 1:
            self.store.put(return_ids[0], result)
            return
        try:
            vals = list(result)
        except TypeError:
            vals = [result]
        if len(vals) != num_returns:
            err = RayTaskError(
                "task",
                f"Task returned {len(vals)} values, expected num_returns={num_returns}",
                ValueError(f"expected {num_returns} return values, got {len(vals)}"),
            )
            for oid in return_ids:
                self.store.put(oid, err, is_exception=True)
            return
        for oid, v in zip(return_ids, vals):
            self.store.put(oid, v)

    def submit_task(self, remote_function, args, kwargs, opts: TaskOptions):
        w = worker_mod.global_worker
        task_id = TaskID.for_normal_task(self.job_id)
        if opts.num_returns == "streaming":
            return self._submit_streaming(remote_function, args, kwargs, task_id)
        return_ids = [ObjectID.from_index(task_id, i + 1) for i in range(opts.num_returns)]
        for oid in return_ids:
            w.reference_counter.add_owned_object(oid, pending_creation=True)
        fn = remote_function._function

        def _run():
            if task_id in self._cancelled:
                err = TaskCancelledError(f"Task {task_id.hex()} was cancelled")
                for oid in return_ids:
                    self.store.put(oid, err, is_exception=True)
                return
            try:
                rargs, rkwargs = self._resolve_args(args, kwargs)
                result = fn(*rargs, **rkwargs)
                self._store_returns(return_ids, result, opts.num_returns)
            except BaseException as e:  # noqa: BLE001
                tb = traceback.format_exc()
                err = RayTaskError(remote_function._name, tb, e if isinstance(e, Exception) else None)
                for oid in return_ids:
                    self.store.put(oid, err, is_exception=True)

        self._pool.submit(_run)
        refs = [ObjectRef(oid) for oid in return_ids]
        for oid in return_ids:
            self._task_for_ref[oid] = task_id
        return refs

    def _submit_streaming(self, remote_function, args, kwargs, task_id: TaskID):
        """Streaming generator task, in-process (same ObjectRefGenerator as
        the cluster runtime; yields land in the local store)."""

        def produce():
            rargs, rkwargs = self._resolve_args(args, kwargs)
            return remote_function._function(*rargs, **rkwargs)

        return self._run_stream(self._pool, task_id, remote_function._name, produce)

    def _run_stream(self, executor, task_id: TaskID, name: str, produce):
        """Shared streaming driver: run ``produce()`` (an iterator factory)
        on ``executor``, landing yields in the local store as they appear."""
        from ray_tpu_torch._private.streaming import ObjectRefGenerator, _StreamState

        w = worker_mod.global_worker
        st = _StreamState()
        self._streams[task_id] = st

        def _run():
            idx = 0
            try:
                for value in produce():
                    oid = ObjectID.from_index(task_id, idx + 1)
                    w.reference_counter.add_owned_object(oid)
                    self.store.put(oid, value)
                    abandoned = False
                    with st.cv:
                        if st.total is not None:
                            abandoned = True  # consumer dropped the stream
                        else:
                            st.arrived[idx] = oid
                            st.cv.notify_all()
                    if abandoned:
                        self.free_object(oid)
                        break
                    idx += 1
                with st.cv:
                    if st.total is None:
                        st.total = idx
                    st.cv.notify_all()
            except BaseException as e:  # noqa: BLE001
                tb = traceback.format_exc()
                err = RayTaskError(name, tb, e if isinstance(e, Exception) else None)
                with st.cv:
                    st.error = err.as_instanceof_cause()
                    st.total = idx
                    st.cv.notify_all()

        executor.submit(_run)
        return ObjectRefGenerator(self, task_id, st)

    # ------------------------------------------------------------------
    def create_actor(self, actor_class, args, kwargs, opts: ActorOptions):
        name_key = None
        if opts.name:
            name_key = (opts.namespace or "default", opts.name)
            with self._lock:
                existing = self._named_actors.get(name_key)
                if existing is not None:
                    if opts.get_if_exists:
                        return existing
                    raise ValueError(f"Actor with name {opts.name!r} already exists")
        actor_id = ActorID.of(self.job_id)
        actor = _LocalActor(actor_id, actor_class._cls, args, kwargs, opts)
        with self._lock:
            self._actors[actor_id] = actor
            if name_key:
                self._named_actors[name_key] = actor_id
        return actor_id

    def submit_actor_task(self, handle, method_name, args, kwargs, opts: TaskOptions):
        actor = self._actors.get(handle._actor_id)
        task_id = TaskID.for_actor_task(handle._actor_id)
        streaming = opts.num_returns == "streaming"
        n_returns = 0 if streaming else opts.num_returns
        return_ids = [ObjectID.from_index(task_id, i + 1) for i in range(n_returns)]
        w = worker_mod.global_worker
        for oid in return_ids:
            w.reference_counter.add_owned_object(oid, pending_creation=True)
        if actor is None or actor.dead:
            err = ActorDiedError()
            if streaming:
                raise err
            for oid in return_ids:
                self.store.put(oid, err, is_exception=True)
            return [ObjectRef(oid) for oid in return_ids]

        if streaming:
            return self._submit_actor_streaming(actor, method_name, args, kwargs, task_id)

        def _run():
            try:
                actor.wait_ready()
            except BaseException as e:  # noqa: BLE001
                err = RayActorError(f"Actor creation failed: {e!r}")
                for oid in return_ids:
                    self.store.put(oid, err, is_exception=True)
                return
            try:
                rargs, rkwargs = self._resolve_args(args, kwargs)
                method = getattr(actor.instance, method_name)
                if actor.is_async:
                    result = actor.run_call(method, rargs, rkwargs)
                else:
                    result = method(*rargs, **rkwargs)
                self._store_returns(return_ids, result, opts.num_returns)
            except BaseException as e:  # noqa: BLE001
                tb = traceback.format_exc()
                err = RayTaskError(method_name, tb, e if isinstance(e, Exception) else None)
                for oid in return_ids:
                    self.store.put(oid, err, is_exception=True)

        actor.executor.submit(_run)
        return [ObjectRef(oid) for oid in return_ids]

    def _submit_actor_streaming(self, actor, method_name, args, kwargs, task_id: TaskID):
        def produce():
            actor.wait_ready()
            rargs, rkwargs = self._resolve_args(args, kwargs)
            return getattr(actor.instance, method_name)(*rargs, **rkwargs)

        return self._run_stream(actor.executor, task_id, method_name, produce)

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True) -> None:
        with self._lock:
            actor = self._actors.pop(actor_id, None)
            for k, v in list(self._named_actors.items()):
                if v == actor_id:
                    del self._named_actors[k]
        if actor:
            actor.dead = True
            actor.executor.shutdown(wait=False, cancel_futures=True)

    def get_actor(self, name: str, namespace: Optional[str] = None):
        with self._lock:
            actor_id = self._named_actors.get((namespace or "default", name))
        if actor_id is None:
            raise ValueError(f"Failed to look up actor with name '{name}'")
        return actor_id

    def cancel(self, ref: ObjectRef, force=False, recursive=True) -> None:
        tid = self._task_for_ref.get(ref.id())
        if tid is not None:
            self._cancelled.add(tid)

    # ------------------------------------------------------------------
    def cluster_resources(self) -> Dict[str, float]:
        return dict(self._resources)

    def available_resources(self) -> Dict[str, float]:
        return dict(self._resources)

    def nodes(self) -> List[Dict[str, Any]]:
        return [
            {
                "NodeID": self.node_id.hex(),
                "Alive": True,
                "NodeManagerAddress": "127.0.0.1",
                "Resources": dict(self._resources),
            }
        ]

    def shutdown(self) -> None:
        for actor in list(self._actors.values()):
            actor.dead = True
            actor.executor.shutdown(wait=False, cancel_futures=True)
        self._actors.clear()
        self._pool.shutdown(wait=False, cancel_futures=True)
