"""ray_tpu_torch.util.collective — process-group collective API (PyTorch
port of ray_tpu/util/collective/collective.py).

Reference surface: python/ray/util/collective/collective.py —
`init_collective_group`, `create_collective_group`, `allreduce`,
`barrier`, `broadcast`, `allgather`, `reducescatter`, `send`/`recv`.

Backends: NCCL (the card; the JAX package's XLA backend) and GLOO (the
CPU), both through ``nccl_group.NCCLGroup``, and OBJSTORE, the JAX
package's host collectives through the object store and shared memory
(``objstore_group.ObjStoreGroup``: numpy in and out, no process group).
``create_collective_group`` declares a group over actors from the
driver."""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch.util.collective.types import Backend, ReduceOp

_groups: Dict[str, Any] = {}
_lock = threading.Lock()


class CollectiveHandle:
    """Future for one async collective op (:func:`async_allreduce`).

    ``result(timeout)`` returns the op's output or re-raises its
    failure. Always pass a timeout on paths that must stay responsive:
    a bare ``result()`` waits for every op queued before this one."""

    def __init__(self, op: str, group_name: str):
        self.op = op
        self.group_name = group_name
        self._done = threading.Event()
        self._value: Any = None
        self._exc: Optional[BaseException] = None

    def _finish(self, value: Any = None,
                exc: Optional[BaseException] = None) -> None:
        self._value = value
        self._exc = exc
        self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"async collective {self.op} on group "
                f"'{self.group_name}' not done within {timeout}s")
        if self._exc is not None:
            raise self._exc
        return self._value


class _AsyncWorker:
    """Per-group FIFO worker draining async collective submissions.

    One daemon thread per group, lazily started: collective ops on one
    group must stay strictly ordered (every member's op N is the same
    op), so a single consumer IS the ordering guarantee — callers get
    overlap (compute while the op runs), never reordering. Once a group
    has a worker, its synchronous ops queue on it too, behind the async
    ones submitted before them."""

    def __init__(self, group_name: str):
        self._q: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(
            target=self._run, name=f"collective-async-{group_name}",
            daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, handle = item
            try:
                handle._finish(value=fn())
            except BaseException as e:  # noqa: BLE001 — delivered via handle
                handle._finish(exc=e)

    def submit(self, fn, handle: CollectiveHandle) -> None:
        self._q.put((fn, handle))

    def stop(self) -> None:
        self._q.put(None)
        # bounded join: an in-flight op finishes before the sentinel is
        # consumed; don't hang destroy on a wedged op
        self._thread.join(timeout=5.0)


_async_workers: Dict[str, _AsyncWorker] = {}


def _async_worker(group_name: str) -> _AsyncWorker:
    with _lock:
        w = _async_workers.get(group_name)
        if w is None:
            w = _async_workers[group_name] = _AsyncWorker(group_name)
        return w


def init_collective_group(
    world_size: int,
    rank: int,
    backend: str = "nccl",
    group_name: str = "default",
) -> None:
    """Declare this process a member of a collective group
    (reference: collective.py:149). ``backend`` "nccl" (the card; raises
    without one), "gloo" (the CPU) or "objstore" (host collectives over
    the cluster runtime: needs ``ray_tpu_torch.init`` first)."""
    backend = Backend.resolve(backend)
    with _lock:
        if group_name in _groups:
            raise RuntimeError(f"Group {group_name} already initialized")
        if backend == Backend.OBJSTORE:
            from ray_tpu_torch.util.collective.objstore_group import ObjStoreGroup

            _groups[group_name] = ObjStoreGroup(world_size, rank, group_name)
        else:
            from ray_tpu_torch.util.collective.nccl_group import NCCLGroup

            _groups[group_name] = NCCLGroup(world_size, rank, group_name, backend)


def create_collective_group(
    actors: List[Any],
    world_size: int,
    ranks: List[int],
    backend: str = "nccl",
    group_name: str = "default",
) -> None:
    """Declarative setup: make ``actors`` a collective group by invoking
    init on each (reference: collective.py:186), through the actor's own
    ``_init_collective(world_size, rank, backend, group_name)`` if it has
    one, else ``__ray_call__``. On NCCL or gloo the actors run on one
    node: a group of several ranks joins a fresh default process group of
    ``world_size`` processes first (``bootstrap.local_process_specs``: a
    free port on this host) in every actor that has none. An OBJSTORE
    group needs no process group. Waits for every member."""
    import ray_tpu_torch
    from ray_tpu_torch.parallel.bootstrap import local_process_specs

    backend = Backend.resolve(backend).value
    specs = ([dataclasses.asdict(s) for s in local_process_specs(world_size)]
             if world_size > 1 and backend != Backend.OBJSTORE.value
             else [None] * world_size)
    futs = [
        a._init_collective.remote(world_size, r, backend, group_name)
        if hasattr(a, "_init_collective")
        else a.__ray_call__.remote(
            lambda self, w=world_size, rk=r, b=backend, g=group_name, sp=specs[r]:
            _join_collective_group(w, rk, b, g, sp)
        )
        for a, r in zip(actors, ranks)
    ]
    ray_tpu_torch.get(futs)


def _join_collective_group(world_size: int, rank: int, backend: str, group_name: str,
                           spec: Optional[Dict[str, Any]]) -> None:
    """One actor's part of ``create_collective_group``: the default
    process group from ``spec`` when the process has none, then the
    group."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel.bootstrap import HostGroupSpec, initialize_host

    if spec is not None and not dist.is_initialized():
        initialize_host(HostGroupSpec(**spec), backend)
    init_collective_group(world_size, rank, backend, group_name)


def is_group_initialized(group_name: str = "default") -> bool:
    return group_name in _groups


def destroy_collective_group(group_name: str = "default") -> None:
    """Forget the group, stop its async worker and destroy its torch
    group."""
    with _lock:
        g = _groups.pop(group_name, None)
        w = _async_workers.pop(group_name, None)
    if w is not None:
        w.stop()
    if g is not None:
        g.close()


def get_rank(group_name: str = "default") -> int:
    g = _groups.get(group_name)
    return g.rank if g else -1


def get_collective_group_size(group_name: str = "default") -> int:
    g = _groups.get(group_name)
    return g.world_size if g else -1


def _group(group_name: str):
    g = _groups.get(group_name)
    if g is None:
        raise RuntimeError(
            f"Collective group '{group_name}' is not initialized; call "
            "init_collective_group() first."
        )
    return g


def _run(group_name: str, op: str, fn):
    """Run a synchronous op: behind the group's queued async ops when it
    has a worker, else right here."""
    w = _async_workers.get(group_name)
    if w is None:
        return fn()
    handle = CollectiveHandle(op, group_name)
    w.submit(fn, handle)
    return handle.result()


def allreduce(tensor: Any, group_name: str = "default",
              op: ReduceOp = ReduceOp.SUM):
    g = _group(group_name)
    return _run(group_name, "allreduce", lambda: g.allreduce(tensor, op))


def _snapshot(tensor: Any) -> Any:
    if isinstance(tensor, (list, tuple)):
        return [_snapshot(t) for t in tensor]
    if isinstance(tensor, torch.Tensor):
        return tensor.detach().clone()
    return np.array(tensor, copy=True)


def async_allreduce(tensor: Any, group_name: str = "default",
                    op: ReduceOp = ReduceOp.SUM) -> CollectiveHandle:
    """Submit an allreduce and return a :class:`CollectiveHandle`
    immediately — the op runs on the group's async worker thread while
    the caller computes. Submission order IS execution order (single
    FIFO worker per group, which the group's later synchronous ops queue
    on too), so mixing async and sync ops is safe as long as every
    member mixes them identically.

    The tensor is snapshotted (copied) at submission: callers routinely
    overwrite their buffer with the next step's values while the op is
    in flight."""
    g = _group(group_name)
    snap = _snapshot(tensor)
    handle = CollectiveHandle("allreduce", group_name)
    _async_worker(group_name).submit(lambda: g.allreduce(snap, op), handle)
    return handle


def allgather(tensor: Any, group_name: str = "default"):
    g = _group(group_name)
    return _run(group_name, "allgather", lambda: g.allgather(tensor))


def reducescatter(tensor: Any, group_name: str = "default",
                  op: ReduceOp = ReduceOp.SUM):
    g = _group(group_name)
    return _run(group_name, "reducescatter", lambda: g.reducescatter(tensor, op))


def broadcast(tensor: Any, src_rank: int = 0, group_name: str = "default"):
    g = _group(group_name)
    return _run(group_name, "broadcast", lambda: g.broadcast(tensor, src_rank))


def barrier(group_name: str = "default") -> None:
    g = _group(group_name)
    _run(group_name, "barrier", g.barrier)


def send(tensor: Any, dst_rank: int, group_name: str = "default") -> None:
    g = _group(group_name)
    _run(group_name, "send", lambda: g.send(tensor, dst_rank))


def recv(src_rank: int, group_name: str = "default"):
    g = _group(group_name)
    return _run(group_name, "recv", lambda: g.recv(src_rank))
