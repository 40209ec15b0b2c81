"""The per-process Worker singleton and the init/shutdown/get/put/wait API
(copy of ray_tpu/_private/worker.py, local mode only so far).

Reference: python/ray/_private/worker.py (Worker :442, init :1438,
connect :2026, shutdown :2069, get/put/wait :2841+). The Worker binds the
public API to a CoreRuntime backend (local-mode or cluster) and holds
per-process state: ids, reference counter, serialization, task context.
"""

from __future__ import annotations

import atexit
import logging
import threading
from typing import Any, Dict, List, Optional, Sequence, Union

from ray_tpu_torch._private.ids import ActorID, JobID, TaskID, WorkerID
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.reference_counter import ReferenceCounter

logger = logging.getLogger(__name__)

# the row of ROADMAP.md that every mode past local mode waits for
ITEM_10B = "ROADMAP.md Queue A item 10b, 'the actor runtime in cluster mode'"


def waits_for_cluster_mode(what: str) -> NotImplementedError:
    """The error of a mode the port's local-mode runtime does not run."""
    return NotImplementedError(
        f"{what} waits for {ITEM_10B}; ray_tpu_torch runs init(local_mode=True) "
        f"only so far")

LOCAL_MODE = "LOCAL_MODE"


class Worker:
    def __init__(self) -> None:
        self.mode: Optional[str] = None
        self.core = None  # CoreRuntime
        self.worker_id = WorkerID.from_random()
        self.job_id = JobID.from_int(0)
        self.reference_counter = ReferenceCounter()
        self.current_task_id = TaskID.for_normal_task(self.job_id)
        self.current_actor_id: Optional[ActorID] = None
        self.current_node_id = None
        self._put_index = 0
        self._put_lock = threading.Lock()
        self._task_context = threading.local()

    @property
    def connected(self) -> bool:
        return self.core is not None

    def next_put_index(self) -> int:
        # put object indices are negative-range in the reference; we use a
        # high offset so they never collide with return indices.
        with self._put_lock:
            self._put_index += 1
            return 1_000_000 + self._put_index

    # task-execution context (set by the executor around user code)
    def set_task_context(self, task_id: TaskID, actor_id: Optional[ActorID] = None) -> None:
        self._task_context.task_id = task_id
        self._task_context.actor_id = actor_id

    def get_task_context(self):
        tid = getattr(self._task_context, "task_id", None)
        aid = getattr(self._task_context, "actor_id", None)
        return tid, aid


global_worker: Optional[Worker] = None
_init_lock = threading.Lock()


def _require_connected() -> Worker:
    if global_worker is None or not global_worker.connected:
        raise RuntimeError("ray_tpu_torch.init() must be called before using the API.")
    return global_worker


def init(
    address: Optional[str] = None,
    *,
    num_cpus: Optional[float] = None,
    num_gpus: Optional[float] = None,
    resources: Optional[Dict[str, float]] = None,
    local_mode: bool = False,
    runtime_env: Optional[Dict[str, Any]] = None,
    ignore_reinit_error: bool = False,
) -> Dict[str, Any]:
    """Start a ray_tpu_torch runtime.

    - ``local_mode=True``: in-process threads (tasks on a thread pool,
      actors on their own executors, objects in the in-process store).
      ``num_gpus`` sets the "GPU" resource; by default it is the count
      of visible cards.
    - ``address=None`` (a new single-node cluster), ``address="<host:port>"``
      or ``"auto"`` (connect to one) and ``"ray://..."`` (a remote driver)
      raise NotImplementedError: they wait for the cluster runtime, and so
      do JAX's keywords that only it reads (``object_store_memory``,
      ``dashboard``, ``namespace``, ``log_to_driver``, ``_system_config``).
    """
    global global_worker
    if not local_mode:
        if address and str(address).startswith("ray://"):
            raise waits_for_cluster_mode(f"init(address={address!r}), a remote driver,")
        if address:
            raise waits_for_cluster_mode(f"init(address={address!r}), joining a cluster,")
        raise waits_for_cluster_mode("init() without local_mode=True, a new cluster,")
    with _init_lock:
        if global_worker is not None and global_worker.connected:
            if ignore_reinit_error:
                return {"already_initialized": True}
            raise RuntimeError(
                "ray_tpu_torch.init() called twice; use ignore_reinit_error=True")

        w = Worker()
        w.mode = LOCAL_MODE
        from ray_tpu_torch._private.local_mode import LocalModeRuntime

        w.core = LocalModeRuntime(resources=resources, num_cpus=num_cpus or 8,
                                  num_gpus=num_gpus)
        if runtime_env:
            # in-process execution: env_vars apply directly; packaged
            # fields are meaningless without worker processes
            import os as _os

            for k, v in (runtime_env.get("env_vars") or {}).items():
                _os.environ[str(k)] = str(v)
        w.reference_counter.set_on_zero_callback(w.core.free_object)
        global_worker = w
        atexit.register(_atexit_shutdown)
        return {
            "node_id": w.core.nodes()[0]["NodeID"] if w.core.nodes() else None,
            "address": getattr(w.core, "address", "local"),
        }


def _atexit_shutdown() -> None:
    try:
        shutdown()
    except Exception:
        logger.debug("atexit shutdown failed", exc_info=True)


def shutdown() -> None:
    global global_worker
    # detach under the lock, tear down outside it
    with _init_lock:
        w, global_worker = global_worker, None
    if w is None:
        return
    w.reference_counter.freeze()
    try:
        w.core.shutdown()
    except Exception:
        logger.exception("Error during shutdown")


def is_initialized() -> bool:
    return global_worker is not None and global_worker.connected


def get(
    refs: Union[ObjectRef, Sequence[ObjectRef]],
    *,
    timeout: Optional[float] = None,
) -> Any:
    w = _require_connected()
    single = isinstance(refs, ObjectRef)
    ref_list = [refs] if single else list(refs)
    for r in ref_list:
        if not isinstance(r, ObjectRef):
            raise TypeError(f"ray_tpu_torch.get() expects ObjectRef(s), got {type(r)}")
    values = w.core.get(ref_list, timeout=timeout)
    return values[0] if single else values


def put(value: Any) -> ObjectRef:
    w = _require_connected()
    if isinstance(value, ObjectRef):
        raise TypeError("Calling put() on an ObjectRef is not allowed")
    return w.core.put(value)


def wait(
    refs: Sequence[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: Optional[float] = None,
    fetch_local: bool = True,
):
    w = _require_connected()
    refs = list(refs)
    if len(set(refs)) != len(refs):
        raise ValueError("wait() got duplicate ObjectRefs")
    if num_returns > len(refs):
        raise ValueError("num_returns cannot exceed the number of refs")
    return w.core.wait(refs, num_returns, timeout, fetch_local)


def kill(actor_handle, *, no_restart: bool = True) -> None:
    w = _require_connected()
    from ray_tpu_torch.actor import ActorHandle

    if not isinstance(actor_handle, ActorHandle):
        raise TypeError("kill() expects an ActorHandle")
    w.core.kill_actor(actor_handle._actor_id, no_restart)


def cancel(ref: ObjectRef, *, force: bool = False, recursive: bool = True) -> None:
    w = _require_connected()
    w.core.cancel(ref, force=force, recursive=recursive)


def get_actor(name: str, namespace: Optional[str] = None):
    w = _require_connected()
    from ray_tpu_torch.actor import ActorHandle

    actor_id = w.core.get_actor(name, namespace)
    return ActorHandle._from_actor_id(actor_id)


def nodes() -> List[Dict[str, Any]]:
    return _require_connected().core.nodes()


def cluster_resources() -> Dict[str, float]:
    return _require_connected().core.cluster_resources()


def available_resources() -> Dict[str, float]:
    return _require_connected().core.available_resources()
