"""The per-process Worker singleton and the init/shutdown/get/put/wait API
(copy of ray_tpu/_private/worker.py: local mode and a one-node cluster).

Reference: python/ray/_private/worker.py (Worker :442, init :1438,
connect :2026, shutdown :2069, get/put/wait :2841+). The Worker binds the
public API to a CoreRuntime backend (local-mode or cluster) and holds
per-process state: ids, reference counter, serialization, task context.
"""

from __future__ import annotations

import atexit
import logging
import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Union

from ray_tpu_torch._private.config import config
from ray_tpu_torch._private.ids import ActorID, JobID, TaskID, WorkerID
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.reference_counter import ReferenceCounter

logger = logging.getLogger(__name__)

# init(address=None) connects here when set: the GCS address that a job
# submitted through the dashboard, or ``scripts submit``, is given
ADDRESS_ENV = "RAY_TPU_ADDRESS"


SCRIPT_MODE = "SCRIPT_MODE"
WORKER_MODE = "WORKER_MODE"
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
# set while no teardown is in flight: shutdown() clears it before the
# slow lock-free teardown and sets it when done, so a concurrent init()
# waits for the old runtime's client-cache sweep instead of having its
# fresh RPC clients closed out from under it
_teardown_done = threading.Event()
_teardown_done.set()


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
    object_store_memory: Optional[int] = None,
    dashboard: bool = False,
    namespace: Optional[str] = None,
    runtime_env: Optional[Dict[str, Any]] = None,
    _system_config: Optional[Dict[str, Any]] = None,
    ignore_reinit_error: bool = False,
    log_to_driver: bool = True,
) -> Dict[str, Any]:
    """Start (or connect to) a ray_tpu_torch runtime.

    - ``local_mode=True``: in-process threads (tasks on a thread pool,
      actors on their own executors, objects in the in-process store).
    - ``address=None``: connect to ``$RAY_TPU_ADDRESS`` when it is set (a
      job that the dashboard or ``scripts submit`` started), else start a
      new single-node cluster (GCS + raylet + shared-memory object store +
      worker processes, as child processes) and connect as driver. The
      raylet leases the cards ("GPU") as instances: a ``num_gpus=n`` task
      or actor runs in a worker whose ``CUDA_VISIBLE_DEVICES`` lists its n
      cards.
    - ``address="<host:port>"``: connect as driver to the GCS of a
      running cluster (one that ``python -m ray_tpu_torch.scripts.scripts
      start --head`` printed, or another driver's ``init()``).
    - ``address="ray://<host:port>"``: a remote driver, every call an RPC
      to the client server that ``start --head`` runs beside the head
      (``ray_tpu_torch.util.client``).

    ``num_gpus`` sets the "GPU" resource; by default it is the count of
    visible cards. ``dashboard`` is accepted and unused, as in the JAX
    package: the dashboard comes from ``start --head`` or
    ``ray_tpu_torch.dashboard.DashboardHead``. ``address="auto"`` raises
    ValueError: nothing discovers a running cluster.
    """
    global global_worker
    if address is None and not local_mode:
        address = os.environ.get(ADDRESS_ENV) or None
    if address == "auto":
        raise ValueError(
            "init(address='auto'): ray_tpu_torch does not discover a running "
            "cluster (the JAX package's 'auto' has no working form either); "
            "pass the address that 'python -m ray_tpu_torch.scripts.scripts "
            f"start --head' printed, or set {ADDRESS_ENV}")
    with _init_lock:
        # serialize against an in-flight shutdown() teardown (which runs
        # outside _init_lock — see shutdown's RC002 note). Waiting UNDER
        # the lock is deadlock-free (the event's setter never takes the
        # lock) and closes the check-then-act gap a pre-lock wait would
        # leave; bounded by the timeout — raycheck: disable=RC002
        if not _teardown_done.wait(timeout=60):
            logger.warning(
                "previous runtime teardown still in flight after 60s; "
                "proceeding with init")
        if global_worker is not None and global_worker.connected:
            if ignore_reinit_error:
                return {"already_initialized": True}
            raise RuntimeError(
                "ray_tpu_torch.init() called twice; use ignore_reinit_error=True")

        config.initialize(_system_config)
        w = Worker()
        w.mode = LOCAL_MODE if local_mode else SCRIPT_MODE

        if local_mode:
            from ray_tpu_torch._private.local_mode import LocalModeRuntime

            w.core = LocalModeRuntime(resources=resources, num_cpus=num_cpus or 8,
                                      num_gpus=num_gpus)
        elif address and str(address).startswith("ray://"):
            # remote driver over TCP (reference: ray client, util/client/):
            # the whole CoreRuntime proxies to a head-side ClientServer
            from ray_tpu_torch.util.client import ClientRuntime

            w.core = ClientRuntime(str(address)[len("ray://"):])
            w.core.job_runtime_env = runtime_env or {}
        else:
            from ray_tpu_torch._private.cluster_runtime import ClusterRuntime

            w.core = ClusterRuntime.create(
                address=address,
                num_cpus=num_cpus,
                num_gpus=num_gpus,
                resources=resources,
                object_store_memory=object_store_memory,
                namespace=namespace,
                dashboard=dashboard,
            )
            w.job_id = w.core.job_id
            # job-level runtime env: merged under every task/actor env
            w.core.job_runtime_env = runtime_env or {}
        if local_mode and runtime_env:
            # in-process execution: env_vars apply directly; packaged
            # fields are meaningless without worker processes
            import os as _os

            for k, v in (runtime_env.get("env_vars") or {}).items():
                _os.environ[str(k)] = str(v)
        w.reference_counter.set_on_zero_callback(w.core.free_object)
        if hasattr(w.core, "_on_borrow_released"):
            w.reference_counter.set_borrow_release_callback(w.core._on_borrow_released)
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
    # RC002: detach inside the lock, tear down outside it. core.shutdown()
    # closes RPC clients and waits on them, and holding _init_lock
    # across that would wedge any thread entering init/shutdown; a
    # concurrent init() waits on the _teardown_done event instead
    with _init_lock:
        w = global_worker
        if w is not None:
            global_worker = None
            _teardown_done.clear()
    if w is None:
        # a concurrent shutdown() may still be mid-teardown: return only
        # once it is done (atexit relies on it)
        _teardown_done.wait(timeout=60)
        return
    try:
        if w.core is not None:
            w.reference_counter.freeze()
            try:
                w.core.shutdown()
            except Exception:
                logger.exception("Error during shutdown")
    finally:
        _teardown_done.set()


def is_initialized() -> bool:
    return global_worker is not None and global_worker.connected


def get(
    refs: Union[ObjectRef, Sequence[ObjectRef]],
    *,
    timeout: Optional[float] = None,
) -> Any:
    from ray_tpu_torch.dag_compiled import CompiledDAGRef

    if isinstance(refs, CompiledDAGRef):
        # compiled-DAG results live in channels, not the object store
        return refs.get(timeout)
    w = _require_connected()
    single = isinstance(refs, ObjectRef)
    ref_list = [refs] if single else list(refs)
    if any(isinstance(r, CompiledDAGRef) for r in ref_list):
        if not all(isinstance(r, CompiledDAGRef) for r in ref_list):
            raise TypeError(
                "ray_tpu_torch.get() cannot mix CompiledDAGRefs with ObjectRefs")
        return [r.get(timeout) for r in ref_list]
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
