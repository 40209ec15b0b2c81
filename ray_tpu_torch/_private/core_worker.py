"""CoreWorker — per-process runtime for the multi-process cluster backend (copy of
ray_tpu/_private/core_worker.py).

Reference: src/ray/core_worker/core_worker.h:168 (CoreWorker) and its
submodules: NormalTaskSubmitter (task_submission/normal_task_submitter.h:87,
lease caching + OnWorkerIdle), TaskManager (task_manager.h:195 — retries,
completion), ReferenceCounter (reference_counter.h:44), memory store
(memory_store.h:48), plasma provider (plasma_store_provider.h:94),
ActorTaskSubmitter (actor_task_submitter.h:69 — seqno ordering).

Every process (driver or executor worker) owns one CoreWorker: it serves
owner RPCs (GetObject — the ownership model's data path), submits tasks via
raylet leases, and resolves objects from {memory store, shared-memory store,
remote owner}.

Object entry formats in the owner memory store:
    ("inline", bytes)   — serialized value (may deserialize to RayTaskError)
    ("plasma", node_id) — sealed in the node's shared-memory store
"""

from __future__ import annotations

import asyncio
import functools
import logging
import queue
import threading
import time
import uuid
import concurrent.futures
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch._private import debug_locks
from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private.config import config
from ray_tpu_torch._private.core import ActorOptions, CoreRuntime, TaskOptions
from ray_tpu_torch._private.ids import ActorID, JobID, NodeID, ObjectID, TaskID
from ray_tpu_torch._private.memory_store import MemoryStore
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.object_store.client import StoreClient
from ray_tpu_torch._private.rpc import (
    EventLoopThread,
    RemoteError,
    RpcClient,
    RpcConnectionError,
    RpcServer,
    get_client,
)
from ray_tpu_torch._private.serialization import deserialize, serialize
from ray_tpu_torch._private.task_spec import (
    FunctionDescriptor,
    SchedulingStrategy,
    TaskArg,
    TaskSpec,
    TaskType,
)
from ray_tpu_torch.exceptions import (
    ActorDiedError,
    ActorUnavailableError,
    GetTimeoutError,
    ObjectLostError,
    ObjectStoreFullError,
    RayActorError,
    RayTaskError,
    TaskCancelledError,
    WorkerCrashedError,
)
from ray_tpu_torch.observability import dump as obs_dump
from ray_tpu_torch.observability import events as obs_events
from ray_tpu_torch.observability import timeline as obs_timeline
from ray_tpu_torch.observability import tracing as obs_tracing

logger = logging.getLogger(__name__)


def _task_latency_histogram():
    """Submit→completion latency histogram (caller-side), merged into the
    util/metrics.py scrape endpoint. Import stays lazy so the metrics
    pusher thread only exists in processes that complete tasks."""
    from ray_tpu_torch.util.metrics import get_histogram

    return get_histogram(
        "ray_tpu_task_latency_s",
        description="Task submit-to-completion latency",
        boundaries=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0),
        tag_keys=("kind",),
    )


class _InfeasibleStrategyError(Exception):
    """A hard scheduling-strategy constraint can never be satisfied."""


class _TransientSchedulingError(Exception):
    """The node view is unavailable right now (GCS blip) — retry, don't
    fail the tasks."""


class _LeaseEntry:
    __slots__ = ("lease_id", "worker_addr", "busy", "last_used",
                 "raylet_addr", "warm", "drain_final_pushes")

    def __init__(
        self,
        lease_id: str,
        worker_addr: Tuple[str, int],
        raylet_addr: Optional[Tuple[str, int]] = None,
    ):
        self.lease_id = lease_id
        self.worker_addr = worker_addr
        # which raylet granted this lease (spillback may land on a remote
        # node); ReturnWorkerLease must go back to the same raylet
        self.raylet_addr = raylet_addr
        self.busy = False
        self.last_used = time.monotonic()
        # the lease already completed at least one push: the worker was
        # healthy AFTER grant. A ConnectionError on a warm lease means
        # the keepalive cache outlived its worker (SIGKILL, node drain)
        # — that is a lease-layer fault, retried for FREE rather than
        # burning the task's max_retries (reference: lease-level retries
        # in normal_task_submitter never charge the app retry budget)
        self.warm = False
        # recall-override pushes already spent on this (draining) lease
        # — see CoreWorker._handle_lease_recalled
        self.drain_final_pushes = 0


class _ActorDispatcher:
    """Event-driven per-actor task dispatch on the core worker's io loop
    (reference: ActorTaskSubmitter, actor_task_submitter.cc:167 SubmitTask
    / :534 SendPendingTasks — every actor's submit queue is driven from one
    io_context, with actor state PUSHED to the submitter, not polled).

    No thread per actor: ``submit()`` appends to the send queue and wakes
    an asyncio sender task shared per (caller, actor). The sender drains
    the queue into ORDERED batches — one ``PushActorTasks`` RPC carries up
    to ``_MAX_BATCH`` payloads — so a burst of small calls costs one
    enqueue-ack round-trip per batch, not per call. Per-caller ordering
    holds because batch N's enqueue ack is awaited before batch N+1 is
    sent and the worker enqueues a batch in list order; no seqno windows,
    so ordering survives actor restarts. Execution results come back
    asynchronously via the caller's ``ActorTasksDone`` RPC.

    While tasks are pending, ONE long-poll ``WaitActorUpdate`` watcher per
    actor (GCS pushes state changes to it) detects death/restart the
    moment it is published — replacing the old 1 s ``GetActorInfo``
    polling threads; the same watcher requeries old pending tasks to
    recover lost result pushes.
    """

    _MAX_BATCH = 64
    # pending tasks older than this on a healthy actor are re-queried at the
    # worker (covers a lost ActorTasksDone delivery)
    _REQUERY_AGE_S = 10.0

    def __init__(self, core: "CoreWorker", aid: str):
        self.core = core
        self.aid = aid
        self._dead = False
        self._closed = False
        self._state_lock = threading.Lock()
        self._items: List[Tuple[dict, List[ObjectID]]] = []
        self._loop = core.loop_thread.loop
        self._wake = asyncio.Event()
        self._watcher: Optional[asyncio.Task] = None
        self._sender = asyncio.run_coroutine_threadsafe(
            self._run(), self._loop)

    @property
    def alive(self) -> bool:
        return not (self._dead or self._closed or self._sender.done())

    def submit(self, payload: dict, return_oids: List[ObjectID]) -> None:
        with self._state_lock:
            if not self._dead and not self._closed:
                self._items.append((payload, return_oids))
                self._loop.call_soon_threadsafe(self._wake.set)
                return
        self.core._fail_actor_task(
            TaskID(payload["task_id"]), return_oids,
            ActorDiedError(f"Actor {self.aid[:12]} is dead"),
        )

    def stop(self) -> None:
        self._closed = True
        try:
            self._loop.call_soon_threadsafe(self._wake.set)
        except RuntimeError:
            pass  # loop already closed at shutdown

    # -- sender (io loop) ----------------------------------------------
    async def _run(self) -> None:
        try:
            while True:
                try:
                    await asyncio.wait_for(self._wake.wait(), timeout=5.0)
                except asyncio.TimeoutError:
                    pass
                self._wake.clear()
                if self._closed or self.core._shutdown:
                    # fail anything still queued — a silent exit would
                    # leave the tasks' return objects unresolved forever
                    with self._state_lock:
                        leftovers, self._items = self._items, []
                    err = RayActorError(
                        f"caller shut down before task reached actor "
                        f"{self.aid[:12]}")
                    for payload, oids in leftovers:
                        self.core._fail_actor_task(
                            TaskID(payload["task_id"]), oids, err)
                    return
                with self._state_lock:
                    items, self._items = self._items, []
                pos = 0
                while pos < len(items) and not self._dead:
                    batch = items[pos:pos + self._MAX_BATCH]
                    try:
                        await self._send_batch(batch)
                    except BaseException as e:  # noqa: BLE001 — must survive
                        logger.exception(
                            "actor dispatch failed for %s", self.aid[:12])
                        for payload, oids in batch:
                            self.core._fail_actor_task(
                                TaskID(payload["task_id"]), oids,
                                RayActorError(
                                    f"Failed to dispatch task to actor "
                                    f"{self.aid[:12]}: {e!r}"))
                    pos += self._MAX_BATCH
                if self._dead:
                    self._retire(items[pos:])
                    return
                # one persistent watcher per dispatcher, started at the
                # first send — NOT per pending burst, which would cost a
                # GCS round-trip per call on the sync path
                if items and (self._watcher is None
                              or self._watcher.done()):
                    self._watcher = asyncio.ensure_future(self._watch())
        finally:
            if self._watcher is not None and not self._watcher.done():
                self._watcher.cancel()

    def _has_pending(self) -> bool:
        with self.core._actor_pending_lock:
            return any(
                info["aid"] == self.aid
                for info in self.core._pending_actor_tasks.values()
            )

    def _retire(self, leftovers) -> None:
        """Actor is DEAD: fail queued work and deregister."""
        with self._state_lock:
            self._dead = True
            items = list(leftovers) + self._items
            self._items = []
        err = ActorDiedError(f"Actor {self.aid[:12]} is dead")
        for payload, oids in items:
            self.core._fail_actor_task(TaskID(payload["task_id"]), oids, err)
        with self.core._actor_disp_lock:
            if self.core._actor_dispatchers.get(self.aid) is self:
                del self.core._actor_dispatchers[self.aid]

    async def _send_batch(
        self, batch: List[Tuple[dict, List[ObjectID]]],
    ) -> None:
        deadline = time.monotonic() + config.actor_task_resend_timeout_s

        def _fail_all(err: Exception) -> None:
            for payload, oids in batch:
                self.core._fail_actor_task(
                    TaskID(payload["task_id"]), oids, err)

        while True:
            try:
                addr = await self.core._resolve_actor_async(self.aid)
            except ActorDiedError as e:
                self._dead = True
                _fail_all(e)
                return
            except (ActorUnavailableError, RayActorError) as e:
                _fail_all(e)
                return
            except Exception as e:  # noqa: BLE001 — e.g. GCS briefly down
                if time.monotonic() > deadline:
                    _fail_all(RayActorError(
                        f"Could not resolve actor {self.aid[:12]}: {e}"))
                    return
                await asyncio.sleep(0.5)
                continue
            # register pending BEFORE the push: the done RPC can arrive
            # before the enqueue ack returns
            now = time.monotonic()
            with self.core._actor_pending_lock:
                for payload, oids in batch:
                    self.core._pending_actor_tasks[
                        TaskID(payload["task_id"])] = {
                        "aid": self.aid,
                        "return_oids": oids,
                        "addr": addr,
                        "method": payload.get("method_name", "actor_task"),
                        "ts": now,
                        "submit_ts": payload.get("submit_ts", 0.0),
                    }
            try:
                reply = await get_client(addr).acall(
                    "PushActorTasks",
                    payloads=[p for p, _ in batch], timeout=30,
                )
            except (RpcConnectionError, ConnectionError, OSError,
                    TimeoutError) as e:
                self._unregister(batch)
                # Planned loss first: if the GCS already moved this actor
                # off the address we pushed to (node drain migrates
                # actors BEFORE their workers die), the dead worker had
                # stopped accepting — the batch was never enqueued there,
                # so resending to the new incarnation keeps at-most-once.
                if await self._moved_by_drain(addr):
                    self.core._invalidate_actor_addr(self.aid, addr)
                    if time.monotonic() > deadline:
                        _fail_all(RayActorError(
                            f"Actor {self.aid[:12]} not reachable at a "
                            f"stable address"))
                        return
                    await asyncio.sleep(0.2)
                    continue
                # Unplanned: the push may or may not have reached the
                # worker before the connection broke, so resending could
                # execute it twice. Actor tasks are at-most-once
                # (reference: actor tasks are not retried unless
                # max_task_retries > 0) — report the fault (triggers
                # restart per max_restarts) and fail THIS batch; queued
                # successors will reach the new incarnation.
                await self.core._report_actor_fault_async(
                    self.aid, addr, str(e))
                _fail_all(RayActorError(
                    f"Actor {self.aid[:12]} became unreachable while a "
                    f"task batch was being delivered: {e}"))
                return
            if not reply.get("accepted"):
                # live worker without this actor: stale address (restart)
                self._unregister(batch)
                self.core._invalidate_actor_addr(self.aid, addr)
                if time.monotonic() > deadline:
                    _fail_all(RayActorError(
                        f"Actor {self.aid[:12]} not reachable at a "
                        f"stable address"))
                    return
                await asyncio.sleep(0.2)
                continue
            return

    def _unregister(self, batch) -> None:
        with self.core._actor_pending_lock:
            for payload, _ in batch:
                self.core._pending_actor_tasks.pop(
                    TaskID(payload["task_id"]), None)

    async def _moved_by_drain(self, pushed_addr: Tuple[str, int]) -> bool:
        """True when the GCS has already restarted this actor away from
        ``pushed_addr`` BECAUSE ITS NODE DRAINED — i.e. the address we
        pushed to was a planned casualty. Requires the drain cause, not
        just a state change: a crash can also reach the GCS (raylet
        death report) before we process our own ConnectionError, and
        resending after a crash could double-execute an at-most-once
        actor task. Drain is safe: the old instance stopped ACCEPTING
        before the restart was published, so a connection-failed push
        was never enqueued there."""
        try:
            info = await self.core.gcs.acall(
                "GetActorInfo", actor_id=self.aid, timeout=10)
        except Exception:  # noqa: BLE001
            return False
        if not info or "draining" not in (info.get("death_cause") or ""):
            return False
        if info.get("state") == "RESTARTING":
            return True
        cur = tuple(info["worker_addr"]) if info.get("worker_addr") else None
        return info.get("state") == "ALIVE" and cur is not None \
            and cur != tuple(pushed_addr)

    # -- watcher (io loop): pushed actor state + lost-result recovery ---
    async def _watch(self) -> None:
        """Wakes on THIS actor's state changes via the process-wide
        actor-state hub — one shared GCS ``Subscribe`` long-poll serves
        every dispatcher in the process (the per-actor WaitActorUpdate
        design cost N/5 RPC/s with N actors pending; a 2,000-actor burst
        saturated the control plane on polls alone). GetActorInfo runs
        only when the hub reports a change; the lost-push requery sweep
        runs off the local clock with the cached address."""
        ev = self.core._actor_hub.watch(self.aid)
        try:
            # one unconditional fetch: a state change BEFORE the hub
            # registration must not be missed
            changed = True
            while not (self._closed or self._dead or self.core._shutdown):
                with self.core._actor_pending_lock:
                    mine = {
                        t: i
                        for t, i in self.core._pending_actor_tasks.items()
                        if i["aid"] == self.aid
                    }
                current = None
                if changed:
                    try:
                        info = await self.core.gcs.acall(
                            "GetActorInfo", actor_id=self.aid, timeout=15)
                    except asyncio.CancelledError:
                        raise
                    except Exception:  # noqa: BLE001 — GCS blip; retry
                        await asyncio.sleep(1.0)
                        continue
                    if info is None or info["state"] == "DEAD":
                        cause = (info or {}).get(
                            "death_cause", "actor no longer exists")
                        for t, i in mine.items():
                            self.core._fail_actor_task(
                                t, i["return_oids"],
                                ActorDiedError(
                                    f"Actor {self.aid[:12]} died: "
                                    f"{cause}"))
                        self._dead = True
                        self._retire([])
                        return
                    current = tuple(info["worker_addr"]) \
                        if info.get("worker_addr") else None
                else:
                    cached = self.core._actor_addr_cache.get(self.aid)
                    current = cached[0] if cached else None
                now = time.monotonic()
                for t, i in mine.items():
                    # enqueued on an incarnation that is gone: before
                    # declaring it lost, ask the OLD worker — a drained
                    # node's actor finishes its accepted tasks before the
                    # restart is published, so the result is usually
                    # sitting in its cache (or the done push already
                    # landed); only an unreachable/amnesiac old worker
                    # fails the task. Re-checked on the periodic sweep
                    # too: a "running" reply from the old incarnation
                    # must not park the task forever if that worker then
                    # dies without another state event.
                    stale = now - i.get("ts", now) > self._REQUERY_AGE_S
                    if i["addr"] != current and (changed or stale):
                        await self._requery(t, i, i["addr"],
                                            fail_unreachable=True)
                    elif current is not None and i["addr"] == current \
                            and stale:
                        # healthy actor, old pending task: the result
                        # push may have been lost — ask the worker
                        await self._requery(t, i, current)
                if not mine and not self._has_pending():
                    # idle: deregister from the hub (40k idle actors must
                    # cost zero RPC); _run re-arms us at the next send
                    return
                changed = False
                try:
                    await asyncio.wait_for(ev.wait(),
                                           timeout=self._REQUERY_AGE_S)
                    changed = True
                    ev.clear()
                except asyncio.TimeoutError:
                    pass
        finally:
            self.core._actor_hub.unwatch(self.aid, ev)

    async def _requery(
        self, tid: TaskID, info: dict, addr: Tuple[str, int],
        fail_unreachable: bool = False,
    ) -> None:
        try:
            reply = await get_client(addr).acall(
                "QueryActorTaskResult",
                actor_id=self.aid,
                task_id_bin=tid.binary(),
                timeout=10,
            )
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001
            if fail_unreachable:
                # the incarnation this task was enqueued on is gone AND
                # unreachable — the task is lost for real
                self.core._fail_actor_task(
                    tid, info["return_oids"],
                    RayActorError(
                        f"Actor {self.aid[:12]} restarted; task "
                        f"{tid.hex()[:12]} was lost"))
            return  # connection-level failures are the watcher's job
        status = reply.get("status")
        if status == "done":
            self.core._handle_actor_task_done(
                tid.binary(), reply["returns"],
                streaming_done=reply.get("streaming_done"),
                stream_error=reply.get("stream_error"),
                failed=bool(reply.get("failed")),
            )
        elif status == "unknown":
            self.core._fail_actor_task(
                tid, info["return_oids"],
                RayActorError(
                    f"Actor {self.aid[:12]} has no record of task "
                    f"{tid.hex()[:12]}; it was lost"),
            )
        # "running": leave it pending


class _ActorStateHub:
    """Process-wide fan-out of GCS actor-state events (reference:
    src/ray/pubsub — every subscriber shares the publisher's channel;
    the reference never opens one poll per actor, and at 2k+ actors
    neither can we). One ``Subscribe("actor_state")`` long-poll feeds
    per-actor asyncio.Events; the loop runs only while someone is
    watching and dies when the last watcher leaves."""

    def __init__(self, core: "CoreWorker"):
        self.core = core
        self._events: Dict[str, set] = {}  # aid -> set of Events
        # freshest event payload per WATCHED actor ({state, version,
        # worker_addr, death_cause}): the event itself resolves the
        # actor, so a woken waiter usually needs no GetActorInfo
        # round-trip. Pruned with the watcher set — unwatched actors'
        # events are never recorded.
        self.last_event: Dict[str, dict] = {}
        self._seq = 0
        self._task: Optional[asyncio.Task] = None

    def watch(self, aid: str) -> asyncio.Event:
        """io-loop only. Returns an Event set on every state change of
        ``aid`` (coalesced; consumer clears)."""
        ev = asyncio.Event()
        self._events.setdefault(aid, set()).add(ev)
        if self._task is None or self._task.done():
            self._task = asyncio.ensure_future(self._loop())
        return ev

    def unwatch(self, aid: str, ev: asyncio.Event) -> None:
        s = self._events.get(aid)
        if s is not None:
            s.discard(ev)
            if not s:
                del self._events[aid]
                self.last_event.pop(aid, None)

    async def _loop(self) -> None:
        while self._events and not self.core._shutdown:
            after = self._seq
            try:
                rep = await self.core.gcs.acall(
                    "Subscribe", channel="actor_state",
                    after_seq=after, timeout_s=30.0, timeout=45)
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — GCS blip/restart
                await asyncio.sleep(1.0)
                # a restarted GCS renumbers its pubsub sequence; resync
                # and wake everyone so they re-fetch their actor's state
                self._seq = 0
                for s in self._events.values():
                    for ev in s:
                        ev.set()
                continue
            self._seq = rep.get("next_seq", self._seq)
            if after < rep.get("dropped_floor", 0):
                # the publisher's ring evicted events past our cursor:
                # anything between after and the floor is gone, and a
                # missed DEAD/restart transition would hang its watcher's
                # pending tasks forever — wake EVERY watcher so each
                # re-fetches its actor's state (changed=True path)
                self._seq = max(self._seq, rep["dropped_floor"])
                for s in self._events.values():
                    for ev in s:
                        ev.set()
            for _seqno, aid, payload in rep.get("events", ()):
                if isinstance(payload, dict) and \
                        payload.get("state") != "ALIVE":
                    # the cached resolve address is stale the moment the
                    # actor leaves ALIVE (drain migration, restart): drop
                    # it so new submits block on the fresh address
                    # instead of pushing at the doomed incarnation
                    self.core._actor_addr_cache.pop(aid, None)
                watchers = self._events.get(aid)
                if not watchers:
                    continue
                if isinstance(payload, dict):
                    prev = self.last_event.get(aid)
                    if prev is None or payload.get("version", 0) >= \
                            prev.get("version", 0):
                        self.last_event[aid] = payload
                for ev in watchers:
                    ev.set()


def _check_card_quantity(resources: Dict[str, float]) -> None:
    """The raylet leases whole cards (instances): a fractional "GPU"
    request is refused here, by the accelerator manager's rule."""
    from ray_tpu_torch.accelerators.gpu import NvidiaGPUAcceleratorManager

    n = (resources or {}).get("GPU")
    if n:
        ok, why = NvidiaGPUAcceleratorManager.validate_resource_request_quantity(n)
        if not ok:
            raise ValueError(f"num_gpus={n}: {why}")


class CoreWorker(CoreRuntime):
    def __init__(
        self,
        gcs_addr: Tuple[str, int],
        raylet_addr: Tuple[str, int],
        store_socket: str,
        node_id: str,
        job_id: JobID,
        is_driver: bool,
        worker_id_hex: Optional[str] = None,
    ):
        self.gcs_addr = gcs_addr
        self.raylet_addr = raylet_addr
        self.node_id = node_id
        self.job_id = job_id
        self.is_driver = is_driver
        self.worker_id_hex = worker_id_hex or uuid.uuid4().hex

        # ONE io loop per process (reference: the core worker's
        # io_context drives clients, server, and actor submitters alike):
        # sharing the global loop keeps get_client() connections, the
        # owner server, and the actor dispatchers loop-affine — a second
        # loop would cost two cross-thread handoffs per actor-task send
        self.loop_thread = EventLoopThread.get_global()
        self.gcs = RpcClient(gcs_addr[0], gcs_addr[1], self.loop_thread)
        self.raylet = RpcClient(raylet_addr[0], raylet_addr[1], self.loop_thread)
        self.plasma = StoreClient(store_socket)
        self.memory_store = MemoryStore()
        # node_id -> raylet addr, for pulling remote plasma objects
        # (owner-based location directory: the owner's memory-store entry
        # names the node; this maps it to that node's object manager)
        self._node_addrs: Dict[str, Tuple[str, int]] = {}
        self._node_addrs_lock = debug_locks.maybe_wrap(
            threading.Lock(), "core_worker.CoreWorker._node_addrs_lock")

        # owner RPC server (GetObject / WaitObject / health). Handlers
        # that only touch the memory store / pending tables register
        # inline: they run on the io loop with no executor handoff —
        # the result-delivery hop of every warm actor call rides these.
        self.server = RpcServer(name=f"core-{self.worker_id_hex[:8]}")
        # single-item endpoint kept for debugging/compat (the runtime
        # itself uses the batched GetObjectsStatus) — raycheck: disable=RC003
        self.server.register("GetObject", self._handle_get_object,
                             inline=True)
        self.server.register("GetObjectsStatus",
                             self._handle_get_objects_status, inline=True)
        self.server.register("WaitObject", self._handle_wait_object)
        self.server.register("RecoverObject", self._handle_recover_object)
        self.server.register("AddBorrower", self._handle_add_borrower,
                             inline=True)
        self.server.register("RemoveBorrower", self._handle_remove_borrower,
                             inline=True)
        # single-item fallback of ActorTasksDone — raycheck: disable=RC003
        self.server.register("ActorTaskDone", self._handle_actor_task_done,
                             inline=True)
        self.server.register("ActorTasksDone", self._handle_actor_tasks_done,
                             inline=True)
        self.server.register("NormalTaskDone", self._handle_normal_task_done)
        self.server.register("StreamingYield", self._handle_streaming_yield,
                             inline=True)
        self.server.register("StreamingDone", self._handle_streaming_done,
                             inline=True)
        self.server.register("StreamingCredit",
                             self._handle_streaming_credit, inline=True)
        self.server.register("Ping", lambda: "pong", inline=True)
        # flight-recorder: the GCS fans failure dumps out to every
        # process it can reach; drivers and workers alike answer here
        self.server.register("DebugDump", self._handle_debug_dump)
        self.server.start(self.loop_thread)
        self.address: Tuple[str, int] = (self.server.host, self.server.port)
        obs_dump.install("driver" if is_driver else "worker")

        # scheduling-strategy state
        self._node_view_cache: Optional[Tuple[float, List[dict]]] = None
        self._spread_rr = -1

        # task submission state
        self._lock = debug_locks.maybe_wrap(
            threading.Lock(), "core_worker.CoreWorker._lock")
        self._leases: Dict[Any, List[_LeaseEntry]] = {}  # scheduling_class -> entries
        self._lease_requests_inflight: Dict[Any, int] = {}
        # keep-alive sweeper for idle granted leases (io-loop task,
        # armed lazily on the first idle lease)
        self._lease_sweeper: Optional[asyncio.Task] = None
        # deques: 100k queued tasks must pop O(1), not O(n)
        self._task_queue: Dict[Any, Any] = {}  # sc -> deque[TaskSpec]
        self._pending_tasks: Dict[TaskID, Dict[str, Any]] = {}
        # worker_addr -> function_keys whose bytes that worker has cached
        self._fns_shipped: Dict[Tuple[str, int], set] = {}

        # streaming generators: task_id -> _StreamState (task_manager.cc:778)
        self._streams: Dict[TaskID, Any] = {}

        # Lineage (reference: task_manager.h:195 lineage pinning +
        # object_recovery_manager.h:41). For every completed normal task
        # with in-scope plasma returns we keep the spec — arg refs stay
        # pinned — so a lost object can be reconstructed by resubmission.
        self._lineage_lock = threading.Lock()
        self._lineage_tasks: Dict[TaskID, Dict[str, Any]] = {}  # tid -> {spec, live}
        self._lineage_by_oid: Dict[ObjectID, TaskID] = {}
        self._recovery_inflight: Dict[TaskID, threading.Event] = {}
        # actor state
        self._actor_addr_cache: Dict[str, Tuple[Tuple[str, int], int]] = {}  # id -> (addr, version)
        self._actor_hub = _ActorStateHub(self)
        self._actor_dispatchers: Dict[str, _ActorDispatcher] = {}
        self._actor_disp_lock = threading.Lock()
        self._pending_actor_tasks: Dict[TaskID, Dict[str, Any]] = {}
        self._actor_task_contained: Dict[TaskID, List[ObjectID]] = {}
        # actors whose first round-trip (create → first task result) has
        # been stamped on the lifecycle timeline already
        self._actor_first_ping_seen: set = set()
        self._actor_pending_lock = debug_locks.maybe_wrap(
            threading.Lock(), "core_worker.CoreWorker._actor_pending_lock")

        # blocked-in-get tracking (CPU release protocol, see get())
        self._blocked_depth = 0
        self._blocked_lock = threading.Lock()

        # Borrow interest ledger. The owner keeps a borrower *set* (one
        # entry per borrower process, idempotent add); this process sends
        # RemoveBorrower exactly once — when its total interest in the oid
        # (deserialized claims + unclaimed handed-off borrows) hits zero.
        # oid -> {"owner": addr, "interest": int, "claimed": bool}
        self._borrow_state: Dict[ObjectID, Dict[str, Any]] = {}
        # owned put-objects whose payload contains nested refs (pinned)
        self._put_contained: Dict[ObjectID, List[ObjectID]] = {}
        # return-oid -> borrows a remote worker registered on OUR behalf
        # (handed-off borrows; interest released at outer-ref release —
        # advisor finding, round 1: unclaimed handoffs pinned forever)
        self._handoff_borrows: Dict[ObjectID, List[Tuple[ObjectID, Tuple[str, int]]]] = {}
        self._borrow_lock = debug_locks.maybe_wrap(
            threading.Lock(), "core_worker.CoreWorker._borrow_lock")
        from concurrent.futures import ThreadPoolExecutor as _TPE

        self._borrow_release_pool = _TPE(max_workers=1, thread_name_prefix="borrow-release")
        # releases that a reference count reaching zero starts (free_object,
        # _on_borrow_released) run on this thread, in order: see
        # _defer_release
        self._release_queue: "queue.SimpleQueue" = queue.SimpleQueue()
        threading.Thread(target=self._release_loop, daemon=True,
                         name="borrow-release-queue").start()
        w = worker_mod.global_worker
        if w is not None:
            w.reference_counter.set_borrow_release_callback(self._on_borrow_released)

        self._shutdown = False
        # task-event buffer → GCS (reference: task_event_buffer.h feeding
        # GcsTaskManager; drives the state API's task listings)
        self._task_events: List[dict] = []
        self._task_events_lock = threading.Lock()
        threading.Thread(
            target=self._task_event_flush_loop, daemon=True,
            name="task-events",
        ).start()
        if is_driver and config.log_to_driver:
            threading.Thread(
                target=self._log_to_driver_loop, daemon=True,
                name="log-to-driver",
            ).start()
        # owner-side borrower liveness sweep (dead borrowers must not pin
        # objects forever; reference: WaitForRefRemoved)
        self._borrower_ping_failures: Dict[Tuple[str, int], int] = {}
        t = threading.Thread(
            target=self._borrower_liveness_loop, daemon=True,
            name="borrower-sweep",
        )
        t.start()

    def _handle_debug_dump(self, reason: str = "requested",
                           info: Optional[dict] = None) -> dict:
        """GCS-initiated flight-recorder dump (failure fan-out)."""
        path = obs_dump.dump_now(reason, extra=info)
        return {"ok": path is not None, "path": path}

    # ==================================================================
    # Task events (reference: task_event_buffer.h → GcsTaskManager)
    # ==================================================================
    def _record_task_event(self, task_id: TaskID, name: str, state: str,
                           kind: str = "task") -> None:
        ev = {
            "task_id": task_id.hex(),
            "name": name,
            "state": state,  # SUBMITTED | FINISHED | FAILED
            "kind": kind,  # task | actor_task
            "job_id": self.job_id.hex(),
            "worker": self.worker_id_hex[:16],
            "ts": time.time(),
        }
        with self._task_events_lock:
            self._task_events.append(ev)
            if len(self._task_events) > 10_000:
                del self._task_events[:5_000]
        if obs_tracing.active():
            # mirror lifecycle transitions onto the event bus so the
            # flight recorder shows them interleaved with spans
            obs_events.record_event("task_state", **ev)

    def _task_event_flush_loop(self) -> None:
        while not self._shutdown:
            time.sleep(1.0)
            with self._task_events_lock:
                batch, self._task_events = self._task_events, []
            if not batch:
                continue
            try:
                self.gcs.call_oneway("ReportTaskEvents", events=batch)
            except Exception:  # noqa: BLE001
                pass

    def _log_to_driver_loop(self) -> None:
        """Print worker log lines on the driver (reference:
        _private/log_monitor.py tailing worker logs to the driver)."""
        import sys

        # start at the CURRENT tail: a fresh driver must not replay the
        # cluster's whole historical log backlog
        seq = None
        while not self._shutdown:
            time.sleep(1.0)
            try:
                reply = self.gcs.call(
                    "GetLogs", after_seq=seq or 0, limit=0 if seq is None else 1000,
                    timeout=10,
                )
            except Exception:  # noqa: BLE001
                continue
            if seq is None:
                seq = reply.get("latest_seq", 0)
                continue
            for s, node_id, worker_id, line in reply.get("lines", []):
                seq = max(seq, s)
                print(f"({worker_id[:8]} {node_id[:8]}) {line}",
                      file=sys.stderr)

    # ==================================================================
    # Owner-side object services
    # ==================================================================
    def _handle_get_object(self, object_id_bin: bytes) -> dict:
        oid = ObjectID(object_id_bin)
        e = self.memory_store.get_if_exists(oid)
        if e is not None:
            kind = e.value[0]
            if kind == "inline":
                return {"status": "inline", "data": e.value[1]}
            return {"status": "plasma", "node_id": e.value[1]}
        # distinguish "not created yet" from "owner already freed it" so
        # borrowers get ObjectLostError instead of waiting forever
        if self._ref_counter().has_reference(oid):
            return {"status": "pending"}
        return {"status": "freed"}

    def _handle_get_objects_status(self, object_id_bins: List[bytes]) -> List[dict]:
        """Batched GetObject — one RPC covers every ref wait() is watching
        on this owner (replaces the per-ref polling the round-2 review
        flagged; reference: pubsub object-location channel)."""
        return [self._handle_get_object(b) for b in object_id_bins]

    def _handle_wait_object(self, object_id_bin: bytes, timeout_s: float = 10.0) -> dict:
        oid = ObjectID(object_id_bin)
        state = self._handle_get_object(object_id_bin)
        if state["status"] != "pending":
            return state
        f = self.memory_store.as_future(oid)
        try:
            f.result(timeout=timeout_s)
        except Exception:
            pass
        return self._handle_get_object(object_id_bin)

    def _handle_add_borrower(self, object_id_bin: bytes, borrower: Tuple[str, int]) -> dict:
        oid = ObjectID(object_id_bin)
        # add_borrower is atomic: it refuses to resurrect an entry for an
        # already-freed object (the borrower then gets status "freed")
        epoch = self._ref_counter().add_borrower(oid, tuple(borrower))
        if epoch is not None:
            return {"ok": True, "epoch": epoch}
        return {"ok": False, "freed": True}

    def _handle_remove_borrower(
        self, object_id_bin: bytes, borrower: Tuple[str, int], epoch: int = None
    ) -> dict:
        w = worker_mod.global_worker
        if w is not None:
            w.reference_counter.remove_borrower(
                ObjectID(object_id_bin), tuple(borrower), epoch=epoch
            )
        return {"ok": True}

    # -- borrower side (this process holds refs it does not own) --------
    #
    # Interest ledger: the owner keeps one registration per borrower
    # process; this process sends RemoveBorrower once, when its total
    # interest (claims + unclaimed handoffs) hits zero, carrying the
    # highest registration epoch it knows — the owner discards a Remove
    # older than its stored epoch, so a queued Remove racing a concurrent
    # re-borrow of the same oid cannot wipe the fresh registration.
    def on_ref_created(self, oid: ObjectID, owner_addr: Tuple[str, int]) -> None:
        """Called by ObjectRef.__init__ for refs carrying an owner address.
        First sighting of a borrowed oid → synchronously register with the
        owner (synchronous so the sender's pin is still alive — closing
        the free-before-borrow race). If a handed-off borrow already
        registered this process, only the claim is recorded locally."""
        if owner_addr == self.address or self._ref_counter().is_owned(oid):
            return
        with self._borrow_lock:
            st = self._borrow_state.get(oid)
            if st is None:
                st = {"owner": owner_addr, "interest": 0, "claimed": False,
                      "epoch": 0}
                self._borrow_state[oid] = st
                need_send = True
            else:
                if st["claimed"]:
                    return
                need_send = False
            st["claimed"] = True
            st["interest"] += 1

        if need_send:
            try:
                rep = get_client(owner_addr).call(
                    "AddBorrower", object_id_bin=oid.binary(),
                    borrower=self.address, timeout=10,
                )
                self._note_borrow_epoch(oid, (rep or {}).get("epoch"))
            except Exception:
                pass  # owner gone: get() will surface ObjectLostError

    def _note_borrow_epoch(self, oid: ObjectID, epoch) -> None:
        if epoch is None:
            return
        with self._borrow_lock:
            st = self._borrow_state.get(oid)
            if st is not None and epoch > st["epoch"]:
                st["epoch"] = epoch

    @staticmethod
    def _parse_borrow(entry) -> Tuple[ObjectID, Tuple[str, int], int]:
        # wire format: (oid_bin, owner_addr, epoch); epoch 0 = unknown
        b, addr, epoch = entry
        return ObjectID(b), tuple(addr), int(epoch or 0)

    def _record_handoff_borrows(self, outer: ObjectID, ret: dict) -> None:
        borrows = ret.get("borrows")
        if not borrows:
            return
        pairs = [self._parse_borrow(e) for e in borrows]
        with self._borrow_lock:
            for inner, owner, epoch in pairs:
                st = self._borrow_state.get(inner)
                if st is None:
                    self._borrow_state[inner] = {
                        "owner": owner, "interest": 1, "claimed": False,
                        "epoch": epoch,
                    }
                else:
                    st["interest"] += 1
                    if epoch > st["epoch"]:
                        st["epoch"] = epoch
            # Fire-and-forget ordering: the outer return ref can already be
            # released before the reply lands — then free_object has already
            # run and nothing will ever pop this entry. Release now.
            if self._ref_counter().has_reference(outer):
                self._handoff_borrows[outer] = pairs
                pairs = None
        if pairs:
            self._dec_borrow_interest([p[0] for p in pairs])

    def _release_unclaimed_handoffs(self, outer: ObjectID) -> None:
        """Outer return ref released: drop one interest unit per nested
        handed-off borrow (claims hold their own unit)."""
        with self._borrow_lock:
            pairs = self._handoff_borrows.pop(outer, None)
        if pairs:
            self._dec_borrow_interest([p[0] for p in pairs])

    def _absorb_dropped_handoffs(self, reply: dict) -> None:
        """A reply we will never hand to the user (late/failed/retried task)
        may still carry borrows an executing worker registered on our
        behalf; deregister any the ledger has no interest in."""
        dropped = list(reply.get("dropped_borrows") or [])
        for ret in reply.get("returns") or []:
            dropped.extend(ret.get("borrows") or [])
        if not dropped:
            return
        to_remove = []
        with self._borrow_lock:
            for entry in dropped:
                inner, owner, epoch = self._parse_borrow(entry)
                st = self._borrow_state.get(inner)
                if st is None:
                    to_remove.append((inner, owner, epoch))
                elif epoch > st["epoch"]:
                    st["epoch"] = epoch  # ledger covers it; track epoch
        self._queue_remove_borrowers(to_remove)

    def _dec_borrow_interest(self, oids: List[ObjectID]) -> None:
        to_remove = []
        with self._borrow_lock:
            for oid in oids:
                st = self._borrow_state.get(oid)
                if st is None:
                    continue
                st["interest"] -= 1
                if st["interest"] <= 0:
                    del self._borrow_state[oid]
                    to_remove.append((oid, st["owner"], st["epoch"]))
        self._queue_remove_borrowers(to_remove)

    def _queue_remove_borrowers(
        self, pairs: List[Tuple[ObjectID, Tuple[str, int], int]]
    ) -> None:
        if not pairs:
            return

        def _send():
            for inner, owner, epoch in pairs:
                with self._borrow_lock:
                    if inner in self._borrow_state:
                        continue  # re-borrowed since queued; still live
                try:
                    get_client(owner).call_oneway(
                        "RemoveBorrower", object_id_bin=inner.binary(),
                        borrower=self.address, epoch=epoch or None,
                    )
                except Exception:
                    pass

        self._borrow_release_pool.submit(_send)

    def _borrower_liveness_loop(self) -> None:
        period = max(1.0, config.borrower_liveness_period_s)
        while not self._shutdown:
            time.sleep(period)
            try:
                self._borrower_liveness_sweep()
            except Exception:
                pass

    def _borrower_liveness_sweep(self) -> None:
        # remove_borrower is irreversible, and a live-but-busy borrower
        # (GIL held by a multi-GB deserialize, host pause) can miss pings:
        # require 3 consecutive failures with generous timeouts (~90s of
        # silence at the default 30s period) before declaring it dead.
        # Pings run CONCURRENTLY — a serial sweep is O(borrowers × 10s
        # timeout) on one thread (round-2 review finding).
        from concurrent.futures import ThreadPoolExecutor

        rc = self._ref_counter()
        by_addr = rc.borrower_addrs()
        for addr in list(self._borrower_ping_failures):
            if addr not in by_addr:
                self._borrower_ping_failures.pop(addr, None)
        if not by_addr:
            return

        def ping(addr):
            try:
                get_client(addr).call("Ping", timeout=10)
                return addr, True
            except Exception:  # noqa: BLE001
                return addr, False

        with ThreadPoolExecutor(max_workers=min(16, len(by_addr))) as pool:
            results = list(pool.map(ping, by_addr))
        for addr, alive in results:
            if alive:
                self._borrower_ping_failures.pop(addr, None)
                continue
            n = self._borrower_ping_failures.get(addr, 0) + 1
            self._borrower_ping_failures[addr] = n
            if n >= 3:
                self._borrower_ping_failures.pop(addr, None)
                for oid in by_addr[addr]:
                    rc.remove_borrower(oid, addr)

    def _defer_release(self, fn, *args) -> None:
        """Run a release on the release thread. A reference count reaches
        zero in ObjectRef.__del__, which a garbage collection can run
        inside any locked section of this process, on that section's
        thread; a release run there inline takes the memory store's lock,
        the store client's, the borrow lock or the release pool's own
        and deadlocked on itself (ROADMAP.md Queue C; JAX's copy releases
        inline or through the pool). ``SimpleQueue.put`` is reentrant: safe
        from __del__."""
        self._release_queue.put((fn, args))

    def _release_loop(self) -> None:
        while True:
            item = self._release_queue.get()
            if item is None:
                return
            fn, args = item
            try:
                fn(*args)
            except Exception:  # noqa: BLE001 — a release must not stop the loop
                logger.debug("release %s failed", fn.__name__, exc_info=True)

    def _on_borrow_released(self, oid: ObjectID) -> None:
        """Last local ObjectRef for a borrowed oid died: the release runs on
        the release thread (``_defer_release``)."""
        self._defer_release(self._release_borrow, oid)

    def _release_borrow(self, oid: ObjectID) -> None:
        """Drop the claim's interest unit. The RemoveBorrower (if interest
        hits zero) goes out on the pool thread, where a dead owner's
        connect timeout must not stall the releaser."""
        with self._borrow_lock:
            st = self._borrow_state.get(oid)
            if st is None or not st["claimed"]:
                return
            st["claimed"] = False
        self._dec_borrow_interest([oid])

    # ==================================================================
    # Objects
    # ==================================================================
    def _ref_counter(self):
        w = worker_mod.global_worker
        if w is None:  # interpreter/driver shutdown race: no-op counter
            from ray_tpu_torch._private.reference_counter import ReferenceCounter

            return ReferenceCounter()
        return w.reference_counter

    def put(self, value: Any) -> ObjectRef:
        w = worker_mod.global_worker
        oid = ObjectID.from_index(w.current_task_id, w.next_put_index())
        from ray_tpu_torch._private.serialization import (
            collect_object_refs,
            serialize_prepare,
        )

        with collect_object_refs() as col:
            sv = serialize_prepare(value)
        try:
            self.put_prepared(oid, sv)
        finally:
            sv.release()
        rc = self._ref_counter()
        rc.add_owned_object(oid)
        if col.refs:
            # pin refs nested inside the stored value for the outer
            # object's lifetime; released when the outer object is freed
            inner = [r.id() for r in col.refs]
            for i in inner:
                rc.add_submitted_task_ref(i)
            with self._borrow_lock:
                self._put_contained[oid] = inner
        return ObjectRef(oid, owner_addr=self.address)

    def put_prepared(self, oid: ObjectID, sv) -> None:
        """Store a prepared (two-phase) serialized value as an owned
        object: inline in the memory store below the threshold, else
        written in place into the reserved shm mapping
        (Create → write-in-place → Seal — 0 intermediate payload
        copies). The caller releases ``sv``."""
        if obs_tracing.active():
            obs_events.record_event(
                "object_put", size=sv.total, job_id=self.job_id.hex(),
                inline=sv.total <= config.object_store_inline_max_bytes)
        if sv.total <= config.object_store_inline_max_bytes:
            # small objects stay inline in the owner memory store; the
            # join is expected here and counted on the "inline" series,
            # keeping the zero-copy "put" invariant series clean
            self.memory_store.put(
                oid, ("inline", sv.to_bytes(copy_path="inline")))
        else:
            self._plasma_put_segments(oid, sv)
            self.memory_store.put(oid, ("plasma", self.node_id))

    def put_serialized(self, oid: ObjectID, data: bytes) -> None:
        if obs_tracing.active():
            obs_events.record_event(
                "object_put", size=len(data), job_id=self.job_id.hex(),
                inline=len(data) <= config.object_store_inline_max_bytes)
        if len(data) <= config.object_store_inline_max_bytes:
            self.memory_store.put(oid, ("inline", data))
        else:
            self._plasma_put_with_backpressure(oid, data)
            self.memory_store.put(oid, ("plasma", self.node_id))

    def _plasma_create_backpressure(self, oid: ObjectID, size: int):
        """Create in the local store; on FULL ask the raylet to spill and
        retry (reference: plasma/create_request_queue.h backpressure —
        ours is client-retry over raylet-driven disk spilling)."""
        if size > self.plasma.pool_size:
            raise ObjectStoreFullError(
                f"object of {size} bytes exceeds store capacity "
                f"{self.plasma.pool_size}"
            )
        deadline = time.monotonic() + 60.0
        while True:
            try:
                return self.plasma.create(oid, size)
            except ObjectStoreFullError:
                # hard bound even while spills keep freeing (concurrent
                # producers can otherwise livelock this loop)
                if time.monotonic() > deadline:
                    raise
                freed = 0
                try:
                    reply = self.raylet.call(
                        "SpillObjects", needed_bytes=size, timeout=120
                    )
                    freed = reply.get("freed", 0)
                except Exception:  # noqa: BLE001
                    pass
                if not freed:
                    time.sleep(config.object_store_full_delay_ms / 1000.0)

    def _plasma_put_with_backpressure(self, oid: ObjectID, data: bytes) -> None:
        """Write a serialized object into the local store, spilling on
        pressure; no-op if the object already exists."""
        try:
            buf = self._plasma_create_backpressure(oid, len(data))
        except FileExistsError:
            return
        try:
            buf.data[:] = data
            buf.seal()
        except BaseException:
            buf.abort()
            raise

    def _plasma_put_segments(self, oid: ObjectID, sv) -> None:
        """Zero-copy plasma put: reserve ``sv.total`` bytes, write the
        serialized frame in place (payload moves source → shm exactly
        once), seal. No-op if the object already exists."""
        try:
            buf = self._plasma_create_backpressure(oid, sv.total)
        except FileExistsError:
            return
        try:
            sv.write_into(buf.data)
            buf.seal()
        except BaseException:
            buf.abort()
            raise

    def _node_raylet_addr(self, node_id: str) -> Optional[Tuple[str, int]]:
        with self._node_addrs_lock:
            addr = self._node_addrs.get(node_id)
        if addr is not None:
            return addr
        try:
            infos = self.gcs.call_retrying("GetAllNodeInfo")
        except Exception:  # noqa: BLE001
            return None
        with self._node_addrs_lock:
            for n in infos:
                self._node_addrs[n["NodeID"]] = (n["NodeManagerAddress"], n["NodeManagerPort"])
            return self._node_addrs.get(node_id)

    def _lookup_moved_object(self, oid: ObjectID,
                             not_node: str) -> Optional[str]:
        """A drained node pushed its primary copies to a survivor and
        registered them with the GCS — consult that directory before
        declaring the object lost."""
        try:
            rep = self.gcs.call_retrying(
                "LookupObjectLocations", object_id_bins=[oid.binary()],
                timeout=10)
        except Exception:  # noqa: BLE001
            return None
        new_node = (rep or {}).get(oid.binary())
        return new_node if new_node and new_node != not_node else None

    def _pull_remote_object(self, oid: ObjectID, node_id: str,
                            _retry: bool = True,
                            _check_moved: bool = True) -> None:
        """Fetch a plasma object from another node's store into the local
        store, chunked (reference: object_manager.cc:221 Pull + :614
        ReceiveObjectChunk; ours is reader-driven over the raylet RPC).
        When the recorded node is gone (drained/preempted), falls back to
        the GCS moved-object directory before giving up."""
        if _check_moved:
            try:
                return self._pull_remote_object(
                    oid, node_id, _retry=_retry, _check_moved=False)
            except ObjectLostError:
                new_node = self._lookup_moved_object(oid, node_id)
                if new_node is None:
                    raise
                logger.info(
                    "object %s moved off drained node %s -> %s",
                    oid.hex()[:12], node_id[:12], new_node[:12])
                self._pull_remote_object(
                    oid, new_node, _retry=_retry, _check_moved=False)
                if self._ref_counter().is_owned(oid):
                    # later reads go straight to the new primary. OWNED
                    # entries only: writing a location entry into a
                    # BORROWER's store would shadow its owner-mediated
                    # path (_get_one asks the owner, who can reconstruct
                    # from lineage) with a dead end once this copy and
                    # the directory entry are gone
                    self.memory_store.put(oid, ("plasma", new_node))
                return
        addr = self._node_raylet_addr(node_id)
        if addr is None:
            raise ObjectLostError(
                f"object {oid.hex()} lives on unknown node {node_id[:12]}"
            )
        chunk_len = config.object_pull_chunk_bytes
        client = get_client(addr)

        def _chunk(offset: int) -> dict:
            try:
                rep = client.call(
                    "PullObjectChunk", object_id_bin=oid.binary(), offset=offset,
                    length=chunk_len, timeout=60,
                )
            except (RpcConnectionError, ConnectionError, OSError, TimeoutError) as e:
                raise ObjectLostError(
                    f"object {oid.hex()} unreachable: node {node_id[:12]} is down ({e})"
                ) from None
            if rep.get("status") != "ok":
                raise ObjectLostError(
                    f"object {oid.hex()} is gone from node {node_id[:12]}"
                )
            return rep

        first = _chunk(0)
        total = first["total"]
        try:
            buf = self._plasma_create_backpressure(oid, total)
        except FileExistsError:
            # another thread's pull is in flight: wait for its seal WITHOUT
            # a long blocking store get (the store client is one shared
            # locked connection — a parked get would block the puller's
            # seal() and deadlock until timeout)
            deadline = time.monotonic() + config.rpc_call_timeout_s
            while time.monotonic() < deadline:
                state = self.plasma.contains_state(oid)
                if state == 0:
                    return  # sealed
                if state == 2:
                    break  # the other pull aborted — take over
                time.sleep(0.005)
            if _retry:
                return self._pull_remote_object(oid, node_id, _retry=False)
            raise ObjectLostError(
                f"object {oid.hex()}: concurrent local pull never sealed"
            )
        ok = False
        try:
            data = first["data"]
            buf.data[: len(data)] = data
            off = len(data)
            while off < total:
                rep = _chunk(off)
                d = rep["data"]
                buf.data[off : off + len(d)] = d
                off += len(d)
            buf.seal()
            ok = True
        finally:
            if not ok:
                buf.abort()

    def _deserialize_entry(self, oid: ObjectID, entry_value: tuple) -> Any:
        kind = entry_value[0]
        if kind == "inline":
            if obs_tracing.active():
                obs_events.record_event(
                    "object_get", size=len(entry_value[1]),
                    job_id=self.job_id.hex(), inline=True)
            val = deserialize(entry_value[1])
        else:  # plasma
            node_id = entry_value[1]
            if node_id != self.node_id and not self.plasma.contains(oid):
                self._pull_remote_object(oid, node_id)
            elif node_id == self.node_id and not self.plasma.contains(oid):
                # maybe spilled to local disk — restore with backpressure:
                # a "full" store (pinned live values) may free up as the
                # user's arrays are collected
                deadline = time.monotonic() + 60.0
                while True:
                    try:
                        st = self.raylet.call(
                            "RestoreObject", object_id_bin=oid.binary(), timeout=120
                        ).get("status")
                    except Exception:  # noqa: BLE001
                        st = "absent"
                    if st != "full" or time.monotonic() > deadline:
                        break
                    time.sleep(config.object_store_full_delay_ms / 1000.0)
            [view] = self.plasma.get([oid], timeout_ms=int(config.rpc_call_timeout_s * 1000))
            if view is None:
                raise ObjectLostError(f"object {oid.hex()} not in local store")
            if obs_tracing.active():
                obs_events.record_event(
                    "object_get", size=len(view),
                    job_id=self.job_id.hex(), inline=False)
            # the get-pin lives exactly as long as the deserialized value:
            # released when the last zero-copy array viewing the region is
            # collected (so long-lived refs don't wedge the store full)
            val = deserialize(
                view, release_cb=functools.partial(self._safe_plasma_release, oid)
            )
        if isinstance(val, RayTaskError):
            raise val.as_instanceof_cause()
        if isinstance(val, BaseException):
            raise val
        return val

    def _get_one(self, ref: ObjectRef, deadline: Optional[float]) -> Any:
        oid = ref.id()
        while True:
            e = self.memory_store.get_if_exists(oid)
            if e is not None:
                try:
                    return self._deserialize_entry(oid, e.value)
                except ObjectLostError:
                    # owned object whose plasma primary is gone: reconstruct
                    # from lineage (object_recovery_manager.h:41)
                    if self._try_recover_object(oid):
                        continue
                    raise
            # do we own it (pending task) or borrow it?
            owned = self._ref_counter().is_owned(oid)
            if owned:
                timeout = None if deadline is None else max(0.0, deadline - time.monotonic())
                f = self.memory_store.as_future(oid)
                try:
                    f.result(timeout=timeout)
                except concurrent.futures.TimeoutError:
                    # 3.10: futures.TimeoutError is NOT the builtin — a
                    # bare `except TimeoutError` let the raw futures
                    # timeout escape get() instead of GetTimeoutError
                    raise GetTimeoutError(f"Get timed out for {oid.hex()}")
                except TimeoutError:
                    raise GetTimeoutError(f"Get timed out for {oid.hex()}")
                continue
            # borrowed: check local plasma first (e.g. same-node producer)
            if self.plasma.contains(oid):
                return self._deserialize_entry(oid, ("plasma", self.node_id))
            owner = ref.owner_address
            if owner is None:
                # last resort: blocking plasma wait
                [view] = self.plasma.get([oid], timeout_ms=1000)
                if view is not None:
                    self.plasma.release(oid)
                    return self._deserialize_entry(oid, ("plasma", self.node_id))
                if deadline is not None and time.monotonic() > deadline:
                    raise GetTimeoutError(f"Get timed out for {oid.hex()} (no owner known)")
                continue
            client = get_client(tuple(owner))
            wait_s = 10.0 if deadline is None else min(10.0, max(0.1, deadline - time.monotonic()))
            try:
                reply = client.call("WaitObject", object_id_bin=oid.binary(), timeout_s=wait_s)
            except (RpcConnectionError, ConnectionError, OSError) as e2:
                raise ObjectLostError(
                    f"owner of {oid.hex()} at {owner} is unreachable: {e2}"
                ) from None
            if reply["status"] == "inline":
                val = deserialize(reply["data"])
                if isinstance(val, RayTaskError):
                    raise val.as_instanceof_cause()
                if isinstance(val, BaseException):
                    raise val
                return val
            if reply["status"] == "plasma":
                try:
                    return self._deserialize_entry(oid, ("plasma", reply["node_id"]))
                except ObjectLostError:
                    # borrowed object lost: ask the OWNER to reconstruct it
                    # (owners hold the lineage; this chains through nested
                    # dependencies because each recovery re-runs the task)
                    try:
                        rep2 = client.call(
                            "RecoverObject", object_id_bin=oid.binary(),
                            timeout_s=60.0, timeout=75,
                        )
                    except (RpcConnectionError, ConnectionError, OSError, TimeoutError) as e3:
                        raise ObjectLostError(
                            f"object {oid.hex()} lost and its owner at {owner} "
                            f"could not recover it: {e3}"
                        ) from None
                    st = rep2.get("status")
                    if st == "inline":
                        val = deserialize(rep2["data"])
                        if isinstance(val, RayTaskError):
                            raise val.as_instanceof_cause() from None
                        if isinstance(val, BaseException):
                            raise val
                        return val
                    if st == "plasma" and self._object_reachable(oid, rep2["node_id"]):
                        return self._deserialize_entry(oid, ("plasma", rep2["node_id"]))
                    raise
            if reply["status"] == "freed":
                raise ObjectLostError(
                    f"object {oid.hex()} was already freed by its owner "
                    "(all references released before this read)"
                )
            if deadline is not None and time.monotonic() > deadline:
                raise GetTimeoutError(f"Get timed out for {oid.hex()}")

    def _maybe_notify_blocked(self, refs: Sequence[ObjectRef]) -> bool:
        """Executor workers blocked in get() hand their CPU back to the
        raylet so dependent tasks can run (reference: NotifyDirectCallTask
        Blocked/Unblocked — avoids nested-task deadlock)."""
        if self.is_driver:
            return False
        w = worker_mod.global_worker
        lease_id = getattr(w, "current_lease_id", None)
        if lease_id is None:
            return False
        if all(
            self.memory_store.contains(r.id()) or self.plasma.contains(r.id()) for r in refs
        ):
            return False
        with self._blocked_lock:
            self._blocked_depth += 1
            first = self._blocked_depth == 1
        if first:
            try:
                self.raylet.call("NotifyWorkerBlocked", lease_id=lease_id, timeout=5)
            except Exception:
                pass
        return True

    def _notify_unblocked(self) -> None:
        w = worker_mod.global_worker
        lease_id = getattr(w, "current_lease_id", None)
        with self._blocked_lock:
            self._blocked_depth -= 1
            last = self._blocked_depth == 0
        if last and lease_id:
            try:
                self.raylet.call("NotifyWorkerUnblocked", lease_id=lease_id, timeout=5)
            except Exception:
                pass

    def get(self, refs: Sequence[ObjectRef], timeout: Optional[float] = None) -> List[Any]:
        deadline = None if timeout is None else time.monotonic() + timeout
        notified = self._maybe_notify_blocked(refs)
        try:
            return [self._get_one(r, deadline) for r in refs]
        finally:
            if notified:
                self._notify_unblocked()

    def wait(self, refs, num_returns, timeout, fetch_local=True):
        deadline = None if timeout is None else time.monotonic() + timeout
        pending = list(refs)
        ready: List[ObjectRef] = []
        while True:
            still: List[ObjectRef] = []
            by_owner: Dict[Tuple[str, int], List[ObjectRef]] = {}
            for r in pending:
                if self.memory_store.contains(r.id()) or self.plasma.contains(r.id()):
                    ready.append(r)
                elif not self._ref_counter().is_owned(r.id()) and r.owner_address:
                    by_owner.setdefault(tuple(r.owner_address), []).append(r)
                else:
                    still.append(r)
            # one batched status RPC per owner per round (not per ref)
            for owner, owner_refs in by_owner.items():
                try:
                    replies = get_client(owner).call(
                        "GetObjectsStatus",
                        object_id_bins=[r.id().binary() for r in owner_refs],
                        timeout=5,
                    )
                    for r, reply in zip(owner_refs, replies):
                        (ready if reply["status"] != "pending" else still).append(r)
                except Exception:  # noqa: BLE001
                    still.extend(owner_refs)
            pending = still
            if len(ready) >= num_returns or not pending:
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
            time.sleep(0.01)
        ready = ready[:num_returns]
        ready_ids = {r.id() for r in ready}
        not_ready = [r for r in refs if r.id() not in ready_ids]
        return ready, not_ready

    def as_future(self, ref: ObjectRef) -> Future:
        out: Future = Future()

        def _bg():
            try:
                out.set_result(self._get_one(ref, None))
            except BaseException as e:  # noqa: BLE001
                out.set_exception(e)

        threading.Thread(target=_bg, daemon=True).start()
        return out

    def free_object(self, oid: ObjectID) -> None:
        # Always on the release thread (_defer_release): a refcount can
        # hit zero from a coroutine on the io loop (e.g. _fail_actor_task
        # in a dispatcher), where the release path may block (plasma
        # socket, GCS node lookup on a cold cache), and in ObjectRef.__del__
        # under a garbage collection inside a locked section.
        self._defer_release(self._free_object_sync, oid)

    def _free_object_sync(self, oid: ObjectID) -> None:
        if self._shutdown:  # queued before shutdown: the store is closed
            return
        with self._borrow_lock:
            inner = self._put_contained.pop(oid, None)
        if inner:
            self._release_contained_refs(inner)
        self._release_unclaimed_handoffs(oid)
        self._evict_lineage(oid)
        e = self.memory_store.get_if_exists(oid)
        self.memory_store.delete(oid)
        if e is not None and e.value[0] == "plasma":
            # get-pins belong to live deserialized values, not the ref; the
            # store defers the delete until outstanding pins drop
            self._delete_plasma_copy(oid, e.value[1])

    def _safe_plasma_release(self, oid: ObjectID) -> None:
        """Release a store get-pin; called from GC when the last value
        viewing the object's memory dies (may run on any thread, possibly
        during interpreter shutdown, possibly inside the store client's
        own locked section): queued for the release thread."""
        if not self._shutdown:
            self._defer_release(self._plasma_release_now, oid)

    def _plasma_release_now(self, oid: ObjectID) -> None:
        if self._shutdown:
            return
        try:
            self.plasma.release(oid)
        except Exception:  # noqa: BLE001
            pass

    def _delete_plasma_copy(self, oid: ObjectID, home_node: str) -> None:
        """Best-effort delete of a plasma object: local replica + the
        primary copy on its home node."""
        try:
            self.plasma.delete(oid)
        except Exception:
            pass
        if home_node != self.node_id:
            addr = self._node_raylet_addr(home_node)
            if addr is not None:
                try:
                    get_client(addr).call_oneway(
                        "DeleteObject", object_id_bin=oid.binary()
                    )
                except Exception:
                    pass

    # ==================================================================
    # Task submission (reference: normal_task_submitter.cc SubmitTask /
    # OnWorkerIdle / RequestNewWorkerIfNeeded)
    # ==================================================================
    def _serialize_args(
        self, args: tuple, kwargs: dict
    ) -> Tuple[List[TaskArg], Dict[str, TaskArg], List[ObjectID]]:
        """Returns (args, kwargs, contained_oids). Both direct ref args and
        refs NESTED inside pickled values are pinned (submitted-task refs,
        reference_counter.h:44) until the task completes; contained_oids
        lists the nested ones so completion can unpin them."""
        out_args: List[TaskArg] = []
        contained: List[ObjectID] = []

        def conv(v) -> TaskArg:
            if isinstance(v, ObjectRef):
                self._ref_counter().add_submitted_task_ref(v.id())
                owner = v.owner_address or self.address
                return TaskArg(is_ref=True, object_id=v.id(), owner_addr=tuple(owner))
            from ray_tpu_torch._private.serialization import (
                collect_object_refs,
                serialize_prepare,
            )

            with collect_object_refs() as col:
                sv = serialize_prepare(v)
            try:
                for r in col.refs:
                    self._ref_counter().add_submitted_task_ref(r.id())
                    contained.append(r.id())
                if sv.total > config.object_store_inline_max_bytes:
                    # promote big arg to an owned shared-memory object,
                    # written in place (zero-copy)
                    w = worker_mod.global_worker
                    oid = ObjectID.from_index(
                        w.current_task_id, w.next_put_index())
                    self.put_prepared(oid, sv)
                    self._ref_counter().add_owned_object(oid)
                    self._ref_counter().add_submitted_task_ref(oid)
                    return TaskArg(
                        is_ref=True, object_id=oid, owner_addr=self.address)
                return TaskArg(
                    is_ref=False, value=sv.to_bytes(copy_path="inline"))
            finally:
                sv.release()

        for a in args:
            out_args.append(conv(a))
        kw = {k: conv(v) for k, v in kwargs.items()}
        return out_args, kw, contained

    def _release_contained_refs(self, oids: List[ObjectID]) -> None:
        rc = self._ref_counter()
        for oid in oids:
            rc.remove_submitted_task_ref(oid)

    def _release_task_refs(self, spec: TaskSpec) -> None:
        """Release every pin a normal-task submission took (direct ref
        args + nested refs). Idempotent — completion and the several
        failure paths may both reach it."""
        if getattr(spec, "_refs_released", False):
            return
        spec._refs_released = True  # type: ignore[attr-defined]
        for a in spec.args + list(getattr(spec, "kwargs_map", {}).values()):
            if a.is_ref and a.object_id is not None:
                self._ref_counter().remove_submitted_task_ref(a.object_id)
        self._release_contained_refs(getattr(spec, "contained_refs", []))

    def submit_task(self, remote_function, args, kwargs, opts: TaskOptions):
        _check_card_quantity(opts.resources)
        w = worker_mod.global_worker
        task_id = TaskID.for_normal_task(self.job_id)
        streaming = opts.num_returns == "streaming"
        ser_args, ser_kwargs, contained = self._serialize_args(args, kwargs)
        from ray_tpu_torch._private.serialization import dumps_function

        # pickle the function ONCE per RemoteFunction (reference exports
        # once to the GCS function table); per-submit cloudpickle was the
        # dominant driver-side cost for small tasks. The key is the
        # content hash of the BYTES (not the source): closures from one
        # factory share source but not cell values.
        fn_bytes = getattr(remote_function, "_pickled_function", None)
        if fn_bytes is None:
            import hashlib

            fn_bytes = dumps_function(remote_function._function)
            remote_function._pickled_function = fn_bytes
            remote_function._pickled_fn_key = hashlib.sha1(
                fn_bytes).hexdigest()

        spec = TaskSpec(
            task_id=task_id,
            job_id=self.job_id,
            task_type=TaskType.NORMAL_TASK,
            function_descriptor=remote_function._descriptor,
            args=ser_args,
            num_returns=0 if streaming else opts.num_returns,
            resources=opts.resources,
            scheduling_strategy=opts.scheduling_strategy,
            # a partially-consumed stream cannot be transparently replayed
            max_retries=0 if streaming else opts.max_retries,
            retry_exceptions=opts.retry_exceptions,
            caller_addr=self.address,
            serialized_function=fn_bytes,
            function_key=remote_function._pickled_fn_key,
            # prepared HERE on the user thread: packaging uploads block on
            # GCS RPCs, which must never run on the io loop (_pack_spec
            # executes there during the push)
            runtime_env=self._prepared_runtime_env(opts.runtime_env),
        )
        spec.is_streaming_generator = streaming
        spec.kwargs_map = ser_kwargs  # type: ignore[attr-defined]
        spec.contained_refs = contained  # type: ignore[attr-defined]
        # trace propagation: the caller's active sampled span (or None —
        # one thread-local read when tracing is idle) rides the spec so
        # the executor's span parents here across the process boundary
        spec.trace_ctx = obs_tracing.for_outbound()  # type: ignore[attr-defined]
        spec.submit_ts = time.time()  # type: ignore[attr-defined]
        return_ids = spec.return_ids()
        for oid in return_ids:
            self._ref_counter().add_owned_object(oid, pending_creation=True)
        self._pending_tasks[task_id] = {"spec": spec, "retries_left": spec.max_retries}
        self._record_task_event(task_id, spec.function_descriptor.repr_name, "SUBMITTED")
        obs_timeline.mark_task(task_id.hex(), "submit",
                               job_id=self.job_id.hex())
        gen = self._register_stream(task_id) if streaming else None
        self.loop_thread.call_soon(self._submit_spec_threadsafe, spec)
        if streaming:
            return gen
        return [ObjectRef(oid, owner_addr=self.address) for oid in return_ids]

    def _submit_spec_threadsafe(self, spec: TaskSpec) -> None:
        import asyncio

        asyncio.ensure_future(self._submit_spec(spec))

    async def _submit_spec(self, spec: TaskSpec) -> None:
        """Runs on the io loop: acquire a lease (cached or new) and push."""
        sc = spec.scheduling_class
        with self._lock:
            lease = None
            for entry in self._leases.get(sc, []):
                if not entry.busy:
                    entry.busy = True
                    lease = entry
                    break
        if lease is None:
            from collections import deque

            self._task_queue.setdefault(sc, deque()).append(spec)
            await self._maybe_request_lease(sc, spec)
            return
        await self._push_tasks([spec], lease)

    # -- scheduling strategies (reference: scheduling policies under
    # src/ray/raylet/scheduling/policy/ — node-affinity, spread, labels;
    # hybrid top-k lives in the raylet's spillback picker) -------------
    async def _node_view(self, force: bool = False) -> List[dict]:
        """Alive nodes from the GCS, cached briefly (lease requests are
        off the task hot path, but SPREAD shouldn't hammer the GCS).
        Raises _TransientSchedulingError when the GCS is unreachable and
        no cache exists — a control-plane blip must not read as 'node
        dead' to a hard affinity/label constraint."""
        now = time.monotonic()
        cached = self._node_view_cache
        if not force and cached and now - cached[0] < 2.0:
            return cached[1]
        try:
            infos = await self.gcs.acall("GetAllNodeInfo", timeout=10)
        except Exception as e:  # noqa: BLE001
            if cached:
                return cached[1]
            raise _TransientSchedulingError(str(e)) from None
        # DRAINING nodes are alive but must not receive new placements —
        # schedulers route around them the moment the drain is published
        alive = [n for n in infos
                 if n.get("Alive") and not n.get("Draining")]
        self._node_view_cache = (now, alive)
        return alive

    async def _lease_target(
        self, strategy, resources: Dict[str, float],
    ) -> Tuple[Tuple[str, int], bool, str]:
        """(raylet addr to lease from, allow_spillback, hard_kind) per
        strategy. hard_kind is "" (no hard constraint), "pinned" (hard
        NodeAffinity — infeasible at that node means infeasible, full
        stop) or "labeled" (hard NodeLabel — another matching or future
        autoscaled node may still fit, so the raylet queues rather than
        fails when autoscaling is on)."""
        import random as _random

        kind = strategy.kind
        if kind == "NODE_AFFINITY":
            for force in (False, True):
                for n in await self._node_view(force=force):
                    if n["NodeID"] == strategy.node_id:
                        return ((n["NodeManagerAddress"],
                                 n["NodeManagerPort"]), bool(strategy.soft),
                                "" if strategy.soft else "pinned")
                # the cache can be up to 2s stale — a just-registered
                # node must not read as dead for a HARD constraint, so
                # re-check against a fresh view before failing
            if strategy.soft:
                return self.raylet_addr, True, ""
            raise _InfeasibleStrategyError(
                f"node {strategy.node_id!r} is not alive "
                f"(NodeAffinity soft=False)")
        if kind == "SPREAD":
            try:
                nodes = await self._node_view()
            except _TransientSchedulingError:
                return self.raylet_addr, True, ""  # preference, not constraint
            if nodes:
                self._spread_rr += 1
                n = nodes[self._spread_rr % len(nodes)]
                return ((n["NodeManagerAddress"],
                         n["NodeManagerPort"]), True, "")
        if kind == "NODE_LABEL":
            hard = strategy.node_labels or {}

            def _matching(view):
                return [n for n in view
                        if all(n.get("Labels", {}).get(k) == v
                               for k, v in hard.items())]

            def _fitting(nodes):
                # among matching nodes, only those whose TOTALS fit the
                # request can ever serve it — picking an undersized match
                # would read as infeasible at that node even though a
                # bigger match exists
                return [m for m in nodes
                        if all(m.get("Resources", {}).get(k, 0.0) >= v
                               for k, v in resources.items())]

            matches = _matching(await self._node_view())
            if not matches or not _fitting(matches):
                # stale-cache re-check before committing to failure or an
                # undersized match: a just-registered fitting node must
                # not be missed for a HARD constraint
                matches = _matching(await self._node_view(force=True))
            if matches:
                pool = _fitting(matches) or matches
                # prefer nodes with spare CPU, pick randomly among them
                # (a deterministic 'best' pick herds every concurrent
                # submitter onto one matching node for the cache window)
                free = [m for m in pool if m.get(
                    "AvailableResources", {}).get("CPU", 0.0) > 0]
                n = _random.choice(free or pool)
                # soft label preference: matching node first, but any
                # node is legal — spillback allowed, no hard constraint
                return ((n["NodeManagerAddress"],
                         n["NodeManagerPort"]),
                        bool(strategy.soft),
                        "" if strategy.soft else "labeled")
            if strategy.soft:
                return self.raylet_addr, True, ""
            raise _InfeasibleStrategyError(
                f"no alive node matches labels {hard!r} "
                f"(NodeLabel soft=False)")
        return self.raylet_addr, True, ""

    async def _maybe_request_lease(self, sc, spec: TaskSpec) -> None:
        with self._lock:
            inflight = self._lease_requests_inflight.get(sc, 0)
            queued = len(self._task_queue.get(sc, []))
            if inflight >= min(queued, config.max_pending_lease_requests_per_class):
                return
            self._lease_requests_inflight[sc] = inflight + 1
        try:
            strategy = spec.scheduling_strategy
            kwargs = dict(
                resources=spec.resources,
                scheduling_class=sc,
                job_id=self.job_id.hex(),
                pg_id=strategy.placement_group_id,
                bundle_index=strategy.placement_group_bundle_index,
                lease_timeout=config.worker_lease_timeout_ms / 1000.0,
                timeout=config.worker_lease_timeout_ms / 1000.0 + 10.0,
                runtime_env_hash=spec.runtime_env_hash(),
            )
            try:
                target_addr, allow_spill, hard_kind = \
                    await self._lease_target(strategy, spec.resources)
            except _InfeasibleStrategyError as e:
                err = RayTaskError(
                    spec.function_descriptor.repr_name, str(e))
                self._fail_queued_tasks(sc, err)
                return
            except _TransientSchedulingError as e:
                # GCS blip with a cold node-view cache: the not-granted
                # path below re-kicks the request — the constraint might
                # be perfectly satisfiable
                raise RuntimeError(f"node view unavailable: {e}") from None
            kwargs["allow_spillback"] = allow_spill
            # "pinned"/"labeled" tells the raylet it must run the lease
            # locally or fail/queue precisely, never redirect it to a
            # node that may violate the constraint
            kwargs["hard_node_constraint"] = hard_kind
            client = self.raylet if tuple(target_addr) == tuple(
                self.raylet_addr) else get_client(tuple(target_addr))
            granted_by: Tuple[str, int] = tuple(target_addr)
            reply = await client.acall("RequestWorkerLease", **kwargs)
            if reply.get("spillback"):
                # local raylet redirected us to a node with capacity
                # (reference: normal_task_submitter.cc:413 re-request at the
                # spillback node); a spilled request cannot spill again
                granted_by = tuple(reply["spillback"])
                reply = await get_client(granted_by).acall(
                    "RequestWorkerLease",
                    **dict(kwargs, allow_spillback=False),
                )
        except Exception as e:  # noqa: BLE001
            if not self._shutdown:
                logger.warning("lease request failed: %s", e)
            reply = {"granted": False, "error": str(e)}
        finally:
            with self._lock:
                self._lease_requests_inflight[sc] = self._lease_requests_inflight.get(sc, 1) - 1
        if not reply.get("granted"):
            if reply.get("infeasible"):
                err = RayTaskError(
                    spec.function_descriptor.repr_name,
                    f"Infeasible resource request: {reply.get('error')}",
                )
                self._fail_queued_tasks(sc, err)
            else:
                # re-kick if tasks remain
                with self._lock:
                    remaining = bool(self._task_queue.get(sc)) and not self._shutdown
                if remaining:
                    import asyncio

                    await asyncio.sleep(0.1)
                    # fresh task, not a nested await: a long outage would
                    # otherwise grow an unbounded coroutine await chain
                    asyncio.ensure_future(
                        self._maybe_request_lease(sc, spec))
            return
        entry = _LeaseEntry(reply["lease_id"], tuple(reply["worker_addr"]), granted_by)
        obs_timeline.mark_task(spec.task_id.hex(), "lease",
                               job_id=self.job_id.hex())
        logger.debug("lease %s granted (worker %s)", entry.lease_id[:8], entry.worker_addr)
        with self._lock:
            self._leases.setdefault(sc, []).append(entry)
        await self._on_lease_idle(sc, entry)

    def _fail_queued_tasks(self, sc, err: Exception) -> None:
        with self._lock:
            specs = self._task_queue.pop(sc, [])
        data = serialize(err if isinstance(err, RayTaskError) else RayTaskError("task", str(err)))
        for s in specs:
            if s.is_streaming_generator:
                self._fail_stream(s.task_id, err)
            for oid in s.return_ids():
                self.memory_store.put(oid, ("inline", data))
            self._release_task_refs(s)
            with self._lock:  # vs _claim_push_completion (executor)
                self._pending_tasks.pop(s.task_id, None)

    @staticmethod
    def _batchable(spec: TaskSpec) -> bool:
        """A spec may share a PushTaskBatch only if it carries NO
        ObjectRef arguments. Batch replies arrive all-at-once, so a task
        whose arg references a sibling earlier in the SAME batch would
        block in the worker fetching a value whose reply is still
        waiting behind the batch — a deadlock until timeout. Ref-arg
        tasks go solo; queue FIFO then guarantees their dependencies
        were pushed in an earlier roundtrip."""
        if spec.is_streaming_generator:
            return False  # delivers out-of-band; keep the RPC solo
        if getattr(spec, "contained_refs", None):
            return False  # refs nested inside arg structures
        for a in spec.args:
            if a.is_ref:
                return False
        for a in getattr(spec, "kwargs_map", {}).values():
            if a.is_ref:
                return False
        return True

    async def _on_lease_idle(self, sc, entry: _LeaseEntry) -> None:
        """Reuse the leased worker for queued tasks, or return it. Pops
        a batch of batchable specs for one PushTaskBatch roundtrip —
        with a deep queue the per-task RPC roundtrip (not execution)
        dominates small-task throughput. The batch size adapts to the
        class's parallelism: popping 32 tasks onto one worker while 7
        other leases sit idle would serialize work the old path ran in
        parallel, so a shallow queue splits across the known workers."""
        specs: List[TaskSpec] = []
        with self._lock:
            queue = self._task_queue.get(sc)
            if queue:
                n_workers = (len(self._leases.get(sc, []))
                             + self._lease_requests_inflight.get(sc, 0))
                cap = min(max(1, config.task_push_batch_size),
                          max(1, len(queue) // max(1, n_workers)))
                while queue and len(specs) < cap:
                    if specs and not self._batchable(queue[0]):
                        break  # non-batchable spec starts its own push
                    s = queue.popleft()
                    specs.append(s)
                    if not self._batchable(s):
                        break
                entry.busy = True
        if not specs:
            # Keep the granted lease WARM instead of returning it: the
            # next same-class submit then pushes straight to the leased
            # worker — one worker RPC, no raylet/GCS touch (reference:
            # normal_task_submitter.cc keeps leased workers for reuse;
            # ours previously paid RequestWorkerLease + SetLeaseContext
            # + ReturnWorkerLease around EVERY sync small task). The
            # sweeper returns it after worker_lease_keepalive_s idle so
            # held CPU cannot starve other classes for long.
            if config.worker_lease_keepalive_s <= 0:
                await self._return_lease(sc, entry)
                return
            entry.busy = False
            entry.last_used = time.monotonic()
            self._ensure_lease_sweeper()
            return
        await self._push_tasks(specs, entry)

    def _ensure_lease_sweeper(self) -> None:
        """io-loop only."""
        if self._lease_sweeper is None or self._lease_sweeper.done():
            self._lease_sweeper = asyncio.ensure_future(
                self._lease_sweeper_loop())

    async def _lease_sweeper_loop(self) -> None:
        """Return idle kept-alive leases to their raylets. Lives while any
        lease exists; re-armed by the next idle lease after it exits."""
        while not self._shutdown:
            keep = max(0.05, config.worker_lease_keepalive_s)
            await asyncio.sleep(keep / 2)
            now = time.monotonic()
            expired: List[Tuple[Any, _LeaseEntry]] = []
            with self._lock:
                for sc, entries in list(self._leases.items()):
                    if self._task_queue.get(sc):
                        continue  # queued work will claim these
                    for e in list(entries):
                        if not e.busy and now - e.last_used > keep:
                            entries.remove(e)
                            expired.append((sc, e))
                    if not entries:
                        self._leases.pop(sc, None)
                alive = any(self._leases.values())
            for _sc, e in expired:
                try:
                    await self._lease_raylet(e).acall(
                        "ReturnWorkerLease", lease_id=e.lease_id)
                except Exception as exc:  # noqa: BLE001
                    if not self._shutdown:
                        logger.debug("keepalive lease return %s failed: %s",
                                     e.lease_id[:8], exc)
            if not alive:
                # re-check under the lock: a lease that went idle while
                # the returns above were in flight would otherwise never
                # be swept (_ensure_lease_sweeper saw us still running),
                # pinning its worker for the driver's lifetime
                with self._lock:
                    alive = any(self._leases.values())
                if not alive:
                    return

    async def _return_lease(self, sc, entry: _LeaseEntry) -> None:
        with self._lock:
            entries = self._leases.get(sc, [])
            if entry in entries:
                entries.remove(entry)
        try:
            await self._lease_raylet(entry).acall("ReturnWorkerLease", lease_id=entry.lease_id)
        except Exception as e:  # noqa: BLE001
            if not self._shutdown:
                logger.warning("ReturnWorkerLease %s failed: %s", entry.lease_id[:8], e)

    def _lease_raylet(self, entry: _LeaseEntry) -> RpcClient:
        if entry.raylet_addr is None or tuple(entry.raylet_addr) == tuple(self.raylet_addr):
            return self.raylet
        return get_client(tuple(entry.raylet_addr))

    async def _push_tasks(self, specs: List[TaskSpec],
                          entry: _LeaseEntry,
                          drain_final: bool = False) -> None:
        sc = specs[0].scheduling_class
        live: List[TaskSpec] = []
        for spec in specs:
            st = self._pending_tasks.get(spec.task_id)
            if st is not None:
                st["entry"] = entry  # cancel() needs the executing worker
                # Check AFTER assigning entry: a cancel() that ran earlier
                # (or concurrently — it sets cancelled before reading
                # entry) is seen here, so either we skip dispatch or
                # cancel() sends the CancelTask RPC; the race has no lost
                # interleaving.
                if st.get("cancelled"):
                    # don't dispatch; returns already poisoned
                    self._release_task_refs(spec)
                    with self._lock:  # vs _claim_push_completion
                        self._pending_tasks.pop(spec.task_id, None)
                    continue
            live.append(spec)
        if not live:
            entry.busy = False
            await self._on_lease_idle(sc, entry)
            return
        client = get_client(entry.worker_addr)
        shipped = self._fns_shipped.setdefault(tuple(entry.worker_addr),
                                               set())
        payloads = []
        in_batch: set = set()
        for spec in live:
            p = self._pack_spec(spec)
            if drain_final:
                # override: the draining worker must accept this push —
                # no other node can host the task (see
                # _handle_lease_recalled)
                p["drain_final"] = True
            if spec.function_key and (spec.function_key in shipped
                                      or spec.function_key in in_batch):
                # bytes already live in that worker's key cache — or an
                # earlier member of THIS batch carries them (the worker
                # executes in order and caches before reaching us) —
                # ship the hash only (the worker answers need_function
                # on a cache miss and we resend with bytes below)
                p["serialized_function"] = None
            elif spec.function_key:
                in_batch.add(spec.function_key)
            payloads.append(p)
        try:
            if len(payloads) == 1:
                replies = [await client.acall(
                    "PushTask", spec_payload=payloads[0],
                    timeout=-1,  # tasks can run arbitrarily long
                )]
            else:
                batch_reply = await client.acall(
                    "PushTaskBatch", spec_payloads=payloads, timeout=-1)
                if batch_reply.get("node_draining"):
                    await self._handle_lease_recalled(live, entry)
                    return
                replies = batch_reply["replies"]
        except RemoteError as e:
            # worker is alive but the push itself failed (e.g. payload
            # could not be decoded) — a task error, NOT a worker death
            err_by_name = {}
            for spec in live:
                st = self._pending_tasks.get(spec.task_id)
                if st is None or st.get("completed_attempt") == spec.attempt_number:
                    continue  # completed via NormalTaskDone before the raise
                name = spec.function_descriptor.repr_name
                if name not in err_by_name:
                    err_by_name[name] = serialize(
                        RayTaskError(name, str(e)))
                data = err_by_name[name]
                for oid in spec.return_ids():
                    self.memory_store.put(oid, ("inline", data))
                self._release_task_refs(spec)
                with self._lock:  # vs _claim_push_completion
                    self._pending_tasks.pop(spec.task_id, None)
            entry.busy = False
            await self._on_lease_idle(sc, entry)
            return
        except Exception as e:  # noqa: BLE001
            logger.warning("push of %d task(s) failed: %s", len(live), e)
            await self._handle_worker_failure(
                live, entry, e,
                lease_was_warm=entry.warm and isinstance(
                    e, (RpcConnectionError, ConnectionError, OSError)))
            return
        batched = len(payloads) > 1
        recalled = [spec for spec, reply in zip(live, replies)
                    if reply.get("node_draining")]
        if recalled:
            # the worker refused mid-stream: its node started draining.
            # Complete what did run, then re-lease the rest elsewhere.
            done_pairs = [(s, r) for s, r in zip(live, replies)
                          if not r.get("node_draining")]
            for spec, reply in done_pairs:
                if reply.get("need_function"):
                    recalled.append(spec)  # resubmit ships the bytes
                    continue
                if spec.function_key:
                    shipped.add(spec.function_key)
                if not batched or self._claim_push_completion(
                        spec.task_id, spec.attempt_number):
                    self._complete_task(spec, reply)
            await self._handle_lease_recalled(recalled, entry)
            return
        retry_with_bytes: List[TaskSpec] = []
        for spec, reply in zip(live, replies):
            if reply.get("need_function"):
                shipped.discard(spec.function_key)
                retry_with_bytes.append(spec)
                continue
            if spec.function_key:
                shipped.add(spec.function_key)
            if batched:
                # batch members were (probably) already completed by the
                # worker's out-of-band NormalTaskDone push — this reply
                # is the fallback for a lost push; claim exactly once
                if self._claim_push_completion(spec.task_id,
                                               spec.attempt_number):
                    self._complete_task(spec, reply)
            else:
                self._complete_task(spec, reply)
        for pos, spec in enumerate(retry_with_bytes):
            # worker evicted the function from its key cache: one more
            # roundtrip with the bytes attached
            try:
                retry_payload = self._pack_spec(spec)
                if drain_final:
                    retry_payload["drain_final"] = True
                reply = await client.acall(
                    "PushTask", spec_payload=retry_payload,
                    timeout=-1)
            except Exception as e:  # noqa: BLE001
                # EVERY not-yet-pushed retry spec fails/retries with
                # this one — dropping them would leave their returns
                # unresolved forever
                await self._handle_worker_failure(
                    retry_with_bytes[pos:], entry, e)
                return
            if spec.function_key:
                shipped.add(spec.function_key)
            self._complete_task(spec, reply)
        entry.busy = False
        entry.last_used = time.monotonic()
        entry.warm = True  # survived a full push: see _LeaseEntry.warm
        if drain_final:
            # the node is draining: the finished batch was its last work
            # from this lease — retire it rather than pool it for reuse
            with self._lock:
                entries = self._leases.get(sc, [])
                if entry in entries:
                    entries.remove(entry)
            try:
                await self._lease_raylet(entry).acall(
                    "ReturnWorkerLease", lease_id=entry.lease_id)
            except Exception:  # noqa: BLE001 — raylet may already be gone
                pass
            return
        await self._on_lease_idle(sc, entry)

    def _driver_py_paths(self) -> List[str]:
        """sys.path entries to replicate on workers so cloudpickle
        by-reference functions resolve (reference: runtime_env py_modules /
        working_dir shipping, _private/runtime_env/working_dir.py)."""
        import os
        import sys

        cached = getattr(self, "_py_paths_cache", None)
        if cached is None:
            cached = [p for p in sys.path if p and os.path.isdir(p)]
            self._py_paths_cache = cached
        return cached

    def _prepared_runtime_env(self, task_env) -> dict:
        """Merge job-level + per-task runtime envs and package local dirs
        into the GCS KV (reference: runtime_env plugins upload through
        the agent; _private/runtime_env/working_dir.py)."""
        from ray_tpu_torch._private import runtime_env as rt

        job_env = getattr(self, "job_runtime_env", None)
        if not job_env and not task_env:
            return {}
        merged = rt.merge_runtime_envs(job_env, task_env)
        return rt.prepare_runtime_env(merged, self.gcs)

    def _pack_spec(self, spec: TaskSpec) -> dict:
        return {
            "py_paths": self._driver_py_paths(),
            "runtime_env": spec.runtime_env,  # prepared at submit time
            "streaming": spec.is_streaming_generator,
            "task_id": spec.task_id.binary(),
            "job_id": spec.job_id.binary(),
            "task_type": spec.task_type.value,
            "function_name": spec.function_descriptor.repr_name,
            "serialized_function": spec.serialized_function,
            "function_key": spec.function_key,
            "args": [
                {
                    "is_ref": a.is_ref,
                    "value": a.value,
                    "object_id": a.object_id.binary() if a.object_id else None,
                    "owner_addr": a.owner_addr,
                }
                for a in spec.args
            ],
            "kwargs": {
                k: {
                    "is_ref": a.is_ref,
                    "value": a.value,
                    "object_id": a.object_id.binary() if a.object_id else None,
                    "owner_addr": a.owner_addr,
                }
                for k, a in getattr(spec, "kwargs_map", {}).items()
            },
            "num_returns": spec.num_returns,
            "caller_addr": spec.caller_addr,
            "retry_exceptions": spec.retry_exceptions,
            "attempt_number": spec.attempt_number,
            "trace_ctx": getattr(spec, "trace_ctx", None),
            "submit_ts": getattr(spec, "submit_ts", 0.0),
        }

    def _claim_push_completion(self, task_id: TaskID,
                               attempt_number: int) -> bool:
        """Exactly-once gate between a batch task's out-of-band
        NormalTaskDone push and the fallback reply in the PushTaskBatch
        return: whichever arrives first completes the task, the other
        is dropped. Keyed by attempt so a stale push from a pre-retry
        attempt cannot complete the retried one."""
        with self._lock:
            st = self._pending_tasks.get(task_id)
            if st is None:
                return False  # completed-and-popped, or cancelled+reaped
            if st["spec"].attempt_number != attempt_number:
                return False
            if st.get("completed_attempt") == attempt_number:
                return False
            st["completed_attempt"] = attempt_number
            return True

    def _handle_normal_task_done(self, task_id_bin: bytes,
                                 attempt_number: int, reply: dict) -> dict:
        """A leased worker finished one member of a PushTaskBatch —
        deliver its result now, not when the whole batch returns (a
        fast task must be visible to ray.wait while a slow batch
        sibling still runs)."""
        task_id = TaskID(bytes(task_id_bin))
        with self._lock:
            st = self._pending_tasks.get(task_id)
            spec = st["spec"] if st is not None else None
        if spec is None:
            return {"ok": False}
        if not self._claim_push_completion(task_id, attempt_number):
            return {"ok": False}
        self._complete_task(spec, reply)
        return {"ok": True}

    # a recalled batch gets this many drain-final pushes back to its
    # (still alive, draining) worker before we give up and take the
    # re-lease path anyway — a backstop against a worker that keeps
    # refusing even the override
    _DRAIN_FINAL_MAX_PUSHES = 3

    async def _drain_alternative_exists(self, spec: TaskSpec) -> bool:
        """Can any alive, non-draining node host `spec` at all? Checked
        against node TOTALS on a forced-fresh view: re-leasing a
        recalled task is only correct if somewhere else can ever run
        it."""
        resources = spec.resources or {}
        if not resources:
            return True  # any node hosts a plain task
        try:
            nodes = await self._node_view(force=True)
        except _TransientSchedulingError:
            return False  # blind: keep the work on the live lease
        return any(
            all(n.get("Resources", {}).get(k, 0.0) >= v
                for k, v in resources.items())
            for n in nodes)

    async def _handle_lease_recalled(self, specs: List[TaskSpec],
                                     entry: _LeaseEntry) -> None:
        """The leased worker's node is draining and refused the push
        (nothing executed): return the lease to its raylet and re-lease
        the tasks elsewhere — a recall is the lease layer's problem, so
        it never charges the tasks' max_retries.

        Re-leasing is only correct when some other node can actually
        host the task. A task pinned to the draining node by a custom
        resource would re-lease into an infeasible request and FAIL —
        even though the drain deadline exists precisely so in-flight
        work can finish. These tasks were leased before the drain
        started, so they ARE in-flight: push them back to the original
        worker with a `drain_final` override (which the draining worker
        honors) and retire the lease when the batch completes."""
        sc = specs[0].scheduling_class
        if not await self._drain_alternative_exists(specs[0]):
            pushes = entry.drain_final_pushes + 1
            if pushes <= self._DRAIN_FINAL_MAX_PUSHES:
                entry.drain_final_pushes = pushes
                logger.info(
                    "lease %s recalled (node draining) but no other "
                    "node fits the resource spec; finishing %d task(s) "
                    "on the draining node", entry.lease_id[:8], len(specs))
                await self._push_tasks(specs, entry, drain_final=True)
                return
        with self._lock:
            entries = self._leases.get(sc, [])
            if entry in entries:
                entries.remove(entry)
        try:
            await self._lease_raylet(entry).acall(
                "ReturnWorkerLease", lease_id=entry.lease_id)
        except Exception:  # noqa: BLE001 — the raylet may already be gone
            pass
        logger.info("lease %s recalled (node draining); re-leasing %d "
                    "task(s)", entry.lease_id[:8], len(specs))
        for spec in specs:
            st = self._pending_tasks.get(spec.task_id)
            if st is None or st.get("cancelled"):
                continue
            spec.attempt_number += 1
            await self._submit_spec(spec)

    # a task gets this many FREE re-leases after warm-lease connection
    # failures before the failure starts charging max_retries — bounds a
    # pathological churn loop without ever failing a task merely because
    # the keepalive cache handed it a dead worker. Known tradeoff: the
    # caller cannot tell "worker died between pushes" (pure cache fault)
    # from "worker died mid-push" — a max_retries=0 task whose worker is
    # killed WHILE executing gets re-run once here. The reference makes
    # the same call at its lease layer; tasks needing strict
    # at-most-once must be idempotent or use actors.
    _WARM_FREE_RETRIES = 3

    async def _handle_worker_failure(self, specs: List[TaskSpec],
                                     entry: _LeaseEntry,
                                     error: Exception,
                                     lease_was_warm: bool = False) -> None:
        sc = specs[0].scheduling_class
        with self._lock:
            entries = self._leases.get(sc, [])
            if entry in entries:
                entries.remove(entry)
        try:
            await self._lease_raylet(entry).acall(
                "ReturnWorkerLease", lease_id=entry.lease_id, worker_dead=True
            )
        except Exception:
            pass
        # the worker is gone: its function cache went with it
        self._fns_shipped.pop(tuple(entry.worker_addr), None)
        for spec in specs:
            st = self._pending_tasks.get(spec.task_id)
            if st is None or st.get("completed_attempt") == spec.attempt_number:
                # this batch member already completed through its
                # out-of-band NormalTaskDone push before the worker (or
                # the connection) died — failing it now would overwrite
                # a delivered result with WorkerCrashedError
                continue
            free = False
            if lease_was_warm and st is not None and not st.get("cancelled"):
                # a warm (keepalive-cached) lease whose worker vanished
                # (SIGKILL between calls, node drained): the failure is
                # the CACHE's, not the task's — re-lease elsewhere
                # without touching retries_left, even at max_retries=0
                warm_used = getattr(spec, "_warm_free_retries", 0)
                if warm_used < self._WARM_FREE_RETRIES:
                    spec._warm_free_retries = warm_used + 1  # type: ignore[attr-defined]
                    free = True
            if st is not None and not st.get("cancelled") and \
                    (free or st["retries_left"] > 0):
                if not free:
                    st["retries_left"] -= 1
                spec.attempt_number += 1
                logger.info("retrying task %s (%s)", spec.task_id.hex()[:12],
                            "free: warm lease lost its worker" if free
                            else f"{st['retries_left']} left")
                await self._submit_spec(spec)
            else:
                err = RayTaskError(
                    spec.function_descriptor.repr_name,
                    f"Worker died while running the task: {error}",
                    WorkerCrashedError(str(error)),
                )
                if spec.is_streaming_generator:
                    self._fail_stream(spec.task_id, err.as_instanceof_cause())
                data = serialize(err)
                for oid in spec.return_ids():
                    self.memory_store.put(oid, ("inline", data))
                self._release_task_refs(spec)
                with self._lock:  # vs _claim_push_completion
                    st0 = self._pending_tasks.pop(spec.task_id, None)
                if not (st0 or {}).get("cancelled"):
                    self._record_task_event(
                        spec.task_id, spec.function_descriptor.repr_name, "FAILED")

    def _complete_task(self, spec: TaskSpec, reply: dict) -> None:
        if spec.is_streaming_generator:
            # yields were delivered out-of-band; finalize idempotently in
            # case the worker's StreamingDone push was lost
            self._handle_streaming_done(
                spec.task_id.binary(),
                count=reply.get("streaming_done", 0),
                error=reply.get("stream_error"),
            )
            self._release_task_refs(spec)
            with self._lock:  # vs _claim_push_completion (executor)
                st0 = self._pending_tasks.pop(spec.task_id, None)
            if not (st0 or {}).get("cancelled"):  # cancel() already logged
                self._record_task_event(
                    spec.task_id, spec.function_descriptor.repr_name,
                    "FAILED" if reply.get("stream_error") else "FINISHED")
            return
        returns = reply.get("returns", [])
        retriable_error = reply.get("retriable_error")
        st_pre = self._pending_tasks.get(spec.task_id)
        if st_pre is not None and st_pre.get("cancelled"):
            # the CancelTask raced with completion and lost: keep the
            # TaskCancelledError poison in the return objects, discard the
            # late reply (and its plasma copies, or they leak)
            self._absorb_dropped_handoffs({"returns": returns})
            if reply.get("dropped_borrows"):
                self._absorb_dropped_handoffs(
                    {"dropped_borrows": reply["dropped_borrows"]})
            for i, ret in enumerate(returns):
                if ret.get("kind") != "inline":
                    oid = ObjectID.from_index(spec.task_id, i + 1)
                    self._delete_plasma_copy(
                        oid, ret.get("node_id", self.node_id))
            self._release_task_refs(spec)
            with self._lock:  # vs _claim_push_completion (executor)
                self._pending_tasks.pop(spec.task_id, None)
            return
        if reply.get("dropped_borrows"):
            # borrows registered for values that failed to package — the
            # error reply supersedes them (advisor/review finding, round 2)
            self._absorb_dropped_handoffs({"dropped_borrows": reply["dropped_borrows"]})
        if retriable_error and spec.retry_exceptions:
            st = self._pending_tasks.get(spec.task_id)
            if st is not None and st["retries_left"] > 0 and not st.get("cancelled"):
                st["retries_left"] -= 1
                spec.attempt_number += 1
                self._absorb_dropped_handoffs({"returns": returns})
                self.loop_thread.call_soon(self._submit_spec_threadsafe, spec)
                return
        plasma_returns: List[ObjectID] = []
        for i, ret in enumerate(returns):
            oid = ObjectID.from_index(spec.task_id, i + 1)
            self._record_handoff_borrows(oid, ret)
            node = ret.get("node_id", self.node_id)
            if not self._ref_counter().has_reference(oid):
                # already freed (user dropped the ref mid-flight, or a
                # recovery re-ran a task with some returns out of scope):
                # don't resurrect the entry — and drop the plasma copy the
                # executor just wrote, or it leaks forever
                if ret["kind"] != "inline":
                    self._delete_plasma_copy(oid, node)
                continue
            if ret["kind"] == "inline":
                self.memory_store.put(oid, ("inline", ret["data"]))
            else:
                self.memory_store.put(oid, ("plasma", node))
                plasma_returns.append(oid)
        if plasma_returns:
            # pin lineage: keep the spec (and thereby its arg-ref pins) so
            # these shared-memory returns can be reconstructed if their
            # node dies (task_manager.h:195); released when the last return
            # goes out of scope (free_object)
            with self._lineage_lock:
                ent = self._lineage_tasks.get(spec.task_id)
                if ent is None:
                    self._lineage_tasks[spec.task_id] = {
                        "spec": spec,
                        "live": set(plasma_returns),
                    }
                    for oid in plasma_returns:
                        self._lineage_by_oid[oid] = spec.task_id
            # close the has_reference/registration race: a ref dropped in
            # the window would have found no lineage to evict — re-check now
            # that the entry is visible
            for oid in plasma_returns:
                if not self._ref_counter().has_reference(oid):
                    self._evict_lineage(oid)
        else:
            self._release_task_refs(spec)
        with self._lock:  # vs _claim_push_completion (executor)
            st0 = self._pending_tasks.pop(spec.task_id, None)
        if not (st0 or {}).get("cancelled"):  # cancel() already logged
            # the worker sets retriable_error on ANY application exception;
            # if it survives to here the retries are exhausted -> FAILED
            self._record_task_event(
                spec.task_id, spec.function_descriptor.repr_name,
                "FAILED" if retriable_error else "FINISHED")
            obs_timeline.mark_task(spec.task_id.hex(), "result",
                                   job_id=self.job_id.hex())
            submit_ts = getattr(spec, "submit_ts", 0.0)
            if submit_ts:
                _task_latency_histogram().observe(
                    max(0.0, time.time() - submit_ts),
                    tags={"kind": "task"})

    # ==================================================================
    # Object recovery (reference: object_recovery_manager.h:41 — the owner
    # resubmits the creating task when a plasma primary is lost)
    # ==================================================================
    def _evict_lineage(self, oid: ObjectID) -> None:
        """Return object went out of scope: drop it from its task's lineage;
        release the task's arg pins when no returns remain in scope."""
        with self._lineage_lock:
            tid = self._lineage_by_oid.pop(oid, None)
            if tid is None:
                return
            ent = self._lineage_tasks.get(tid)
            if ent is None:
                return
            ent["live"].discard(oid)
            spec = ent["spec"] if not ent["live"] else None
            if spec is not None:
                del self._lineage_tasks[tid]
        if spec is not None:
            self._release_task_refs(spec)

    def _try_recover_object(self, oid: ObjectID, wait_s: float = 0.5) -> bool:
        """Resubmit the task that created a lost object. Returns True if a
        recovery was started (or was already in flight) — the caller should
        re-wait on the memory store."""
        with self._lineage_lock:
            tid = self._lineage_by_oid.get(oid)
            ent = self._lineage_tasks.get(tid) if tid is not None else None
            if ent is None:
                return False
            ev = self._recovery_inflight.get(tid)
            if ev is not None:
                leader = False
            else:
                leader = True
                ev = self._recovery_inflight[tid] = threading.Event()
                spec = ent["spec"]
                live = set(ent["live"])
        if not leader:
            ev.wait(timeout=30)
            time.sleep(wait_s)  # let the resubmission register
            return True
        try:
            attempts = getattr(spec, "_recovery_attempts", 0)
            if attempts >= 3:
                logger.error(
                    "object %s unrecoverable: task %s already reconstructed %d times",
                    oid.hex()[:12], spec.task_id.hex()[:12], attempts,
                )
                return False
            spec._recovery_attempts = attempts + 1  # type: ignore[attr-defined]
            logger.warning(
                "reconstructing object %s by resubmitting task %s (attempt %d)",
                oid.hex()[:12], spec.task_id.hex()[:12], attempts + 1,
            )
            # clear the stale locations so getters park on the re-creation
            for roid in spec.return_ids():
                if roid in live:
                    self.memory_store.delete(roid)
            spec.attempt_number += 1
            self._pending_tasks[spec.task_id] = {
                "spec": spec,
                "retries_left": spec.max_retries,
            }
            self.loop_thread.call_soon(self._submit_spec_threadsafe, spec)
            return True
        finally:
            ev.set()
            with self._lineage_lock:
                self._recovery_inflight.pop(tid, None)

    def _handle_recover_object(self, object_id_bin: bytes, timeout_s: float = 60.0) -> dict:
        """Borrower-triggered recovery: a worker holding a ref to OUR lost
        object asks us (the owner) to reconstruct it; replies with the new
        location once the resubmitted task lands. This is what makes chained
        reconstruction work — each lost dependency walks back to its owner."""
        oid = ObjectID(object_id_bin)
        state = self._handle_get_object(object_id_bin)
        if state["status"] == "plasma":
            if self._object_reachable(oid, state["node_id"]):
                return state  # healthy — the borrower's failure was transient
            if not self._try_recover_object(oid):
                return state
        elif state["status"] != "pending":
            return state
        f = self.memory_store.as_future(oid)
        try:
            f.result(timeout=timeout_s)
        except Exception:  # noqa: BLE001
            pass
        return self._handle_get_object(object_id_bin)

    def _object_reachable(self, oid: ObjectID, node_id: str) -> bool:
        if node_id == self.node_id:
            return self.plasma.contains(oid)
        addr = self._node_raylet_addr(node_id)
        if addr is None:
            return False
        try:
            rep = get_client(addr).call(
                "ContainsObject", object_id_bin=oid.binary(), timeout=10
            )
            return bool(rep.get("contains"))
        except Exception:  # noqa: BLE001
            return False

    # ==================================================================
    # Actors (reference: actor_task_submitter.cc; GCS-mediated creation
    # gcs_actor_manager.cc:314/:433)
    # ==================================================================
    def create_actor(self, actor_class, args, kwargs, opts: ActorOptions) -> ActorID:
        _check_card_quantity(opts.resources)
        actor_id = ActorID.of(self.job_id)
        obs_timeline.mark_actor(actor_id.hex(), "submit",
                                job_id=self.job_id.hex())
        # contained/direct arg refs stay pinned for the actor's lifetime:
        # restarts replay __init__ from the same spec (gcs_actor_manager.cc:1721)
        ser_args, ser_kwargs, _ = self._serialize_args(args, kwargs)
        from ray_tpu_torch._private.serialization import dumps_function

        spec_payload = {
            "py_paths": self._driver_py_paths(),
            "runtime_env": self._prepared_runtime_env(opts.runtime_env),
            "serialized_class": dumps_function(actor_class._cls),
            "class_name": actor_class._name,
            "args": [
                {
                    "is_ref": a.is_ref,
                    "value": a.value,
                    "object_id": a.object_id.binary() if a.object_id else None,
                    "owner_addr": a.owner_addr,
                }
                for a in ser_args
            ],
            "kwargs": {
                k: {
                    "is_ref": a.is_ref,
                    "value": a.value,
                    "object_id": a.object_id.binary() if a.object_id else None,
                    "owner_addr": a.owner_addr,
                }
                for k, a in ser_kwargs.items()
            },
            "max_concurrency": opts.max_concurrency,
            "max_restarts": opts.max_restarts,
        }
        import pickle

        from ray_tpu_torch._private.runtime_env import env_hash

        actor_env_hash = env_hash(spec_payload["runtime_env"]) \
            if spec_payload["runtime_env"] else ""
        strategy = opts.scheduling_strategy
        reply = self.gcs.call_retrying(
            "RegisterActor",
            actor_id=actor_id.hex(),
            job_id=self.job_id.hex(),
            serialized_spec=pickle.dumps(spec_payload, protocol=5),
            name=opts.name,
            namespace=opts.namespace or "default",
            max_restarts=opts.max_restarts,
            resources=opts.resources,
            owner_addr=self.address,
            detached=(opts.lifetime == "detached"),
            get_if_exists=opts.get_if_exists,
            pg_id=strategy.placement_group_id,
            bundle_index=strategy.placement_group_bundle_index,
            cpu_scheduling_only=opts.cpu_scheduling_only,
            runtime_env_hash=actor_env_hash,
            scheduling_kind=strategy.kind,
            affinity_node_id=strategy.node_id,
            strategy_soft=strategy.soft,
            node_labels=strategy.node_labels,
        )
        if "error" in reply:
            raise ValueError(reply["error"])
        return ActorID.from_hex(reply["actor_id"])

    async def _resolve_actor_async(
        self, actor_id_hex: str, wait_alive_s: Optional[float] = None,
    ) -> Tuple[str, int]:
        """Resolve an actor's worker address via the GCS long-poll,
        awaited on the io loop (blocking gcs.call there would deadlock
        the loop against its own replies). 180s default: actor __init__
        may legitimately cold-import jax and build a model inside a
        fresh worker process; raise ``actor_wait_alive_timeout_s`` for
        thousand-actor bursts where the tail actor's creation backlog
        exceeds it."""
        if wait_alive_s is None:
            wait_alive_s = config.actor_wait_alive_timeout_s
        deadline = time.monotonic() + wait_alive_s
        cached = self._actor_addr_cache.get(actor_id_hex)
        if cached is not None:
            return cached[0]
        # change-driven, not polled: the shared hub wakes this waiter on
        # the actor's state transitions — a 2,000-actor creation burst
        # costs one Subscribe stream + one GetActorInfo per transition,
        # not 2,000 outstanding WaitActorUpdate polls
        ev = self._actor_hub.watch(actor_id_hex)
        try:
            while time.monotonic() < deadline:
                # warm path: the hub's freshest pushed event already
                # carries state + address — resolve from it with NO
                # GetActorInfo round-trip (the 2,000-actor burst then
                # costs one GCS query per actor, not one per wake)
                info = self._actor_hub.last_event.get(actor_id_hex)
                if not (info and (
                        (info.get("state") == "ALIVE"
                         and info.get("worker_addr"))
                        or info.get("state") == "DEAD")):
                    try:
                        info = await self.gcs.acall(
                            "GetActorInfo", actor_id=actor_id_hex,
                            timeout=15)
                    except (RpcConnectionError, ConnectionError, OSError,
                            TimeoutError):
                        await asyncio.sleep(0.5)
                        continue
                if info is None:
                    raise ActorDiedError(
                        f"Actor {actor_id_hex[:12]} does not exist")
                if info["state"] == "ALIVE" and info["worker_addr"]:
                    addr = tuple(info["worker_addr"])
                    self._actor_addr_cache[actor_id_hex] = (
                        addr, info["version"])
                    return addr
                if info["state"] == "DEAD":
                    raise ActorDiedError(
                        f"Actor {actor_id_hex[:12]} is dead: "
                        f"{info.get('death_cause', '')}")
                try:
                    await asyncio.wait_for(
                        ev.wait(),
                        timeout=min(10.0, max(
                            0.01, deadline - time.monotonic())))
                except asyncio.TimeoutError:
                    pass  # re-check against the deadline regardless
                ev.clear()
        finally:
            self._actor_hub.unwatch(actor_id_hex, ev)
        raise ActorUnavailableError(
            f"Actor {actor_id_hex[:12]} not schedulable in time")

    def submit_actor_task(self, handle, method_name, args, kwargs, opts: TaskOptions):
        actor_id: ActorID = handle._actor_id
        aid = actor_id.hex()
        task_id = TaskID.for_actor_task(actor_id)
        streaming = opts.num_returns == "streaming"
        n_returns = 0 if streaming else opts.num_returns
        return_ids = [ObjectID.from_index(task_id, i + 1) for i in range(n_returns)]
        for oid in return_ids:
            self._ref_counter().add_owned_object(oid, pending_creation=True)
        ser_args, ser_kwargs, contained = self._serialize_args(args, kwargs)
        # every pin taken for this task (direct ref args + promoted big
        # args + nested refs) — released exactly once on done/fail
        pinned = list(contained)
        for a in list(ser_args) + list(ser_kwargs.values()):
            if a.is_ref and a.object_id is not None:
                pinned.append(a.object_id)
        if pinned:
            with self._actor_pending_lock:
                self._actor_task_contained[task_id] = pinned
        payload = {
            "actor_id": aid,
            "task_id": task_id.binary(),
            "method_name": method_name,
            "caller_id": self.worker_id_hex,
            "num_returns": n_returns,
            "streaming": streaming,
            "args": [
                {
                    "is_ref": a.is_ref,
                    "value": a.value,
                    "object_id": a.object_id.binary() if a.object_id else None,
                    "owner_addr": a.owner_addr,
                }
                for a in ser_args
            ],
            "kwargs": {
                k: {
                    "is_ref": a.is_ref,
                    "value": a.value,
                    "object_id": a.object_id.binary() if a.object_id else None,
                    "owner_addr": a.owner_addr,
                }
                for k, a in ser_kwargs.items()
            },
            "caller_addr": self.address,
            "trace_ctx": obs_tracing.for_outbound(),
            "submit_ts": time.time(),
        }
        gen = self._register_stream(task_id) if streaming else None
        self._record_task_event(task_id, method_name, "SUBMITTED", kind="actor_task")
        self._get_dispatcher(aid).submit(payload, return_ids)
        if streaming:
            return gen
        return [ObjectRef(oid, owner_addr=self.address) for oid in return_ids]

    def _get_dispatcher(self, aid: str) -> _ActorDispatcher:
        with self._actor_disp_lock:
            disp = self._actor_dispatchers.get(aid)
            if disp is None or not disp.alive:
                disp = _ActorDispatcher(self, aid)
                self._actor_dispatchers[aid] = disp
            return disp

    def _handle_actor_tasks_done(self, results: List[dict]) -> dict:
        """Batched execution results pushed back by the actor's worker
        (one RPC per delivery batch instead of one per task)."""
        return {"ok": [self._handle_actor_task_done(**r).get("ok")
                       for r in results]}

    def _handle_actor_task_done(
        self, task_id_bin: bytes, returns: List[dict], dropped_borrows: list = None,
        streaming_done: Optional[int] = None, stream_error: Optional[bytes] = None,
        failed: bool = False,
    ) -> dict:
        """Execution result pushed back by the actor's worker."""
        tid = TaskID(task_id_bin)
        if dropped_borrows:
            self._absorb_dropped_handoffs({"dropped_borrows": dropped_borrows})
        if streaming_done is not None:
            # reliable finalizer for actor streaming methods (the direct
            # StreamingDone push may have been lost); idempotent
            self._handle_streaming_done(task_id_bin, streaming_done, stream_error)
        with self._actor_pending_lock:
            info = self._pending_actor_tasks.pop(tid, None)
            contained = self._actor_task_contained.pop(tid, [])
        self._release_contained_refs(contained)
        if info is None:
            # already failed (restart) — drop the late result, but the
            # executing worker still registered us as borrower of any refs
            # nested in it; deregister them or the owners pin forever
            self._absorb_dropped_handoffs({"returns": returns})
            return {"ok": False}
        for i, ret in enumerate(returns):
            oid = info["return_oids"][i]
            self._record_handoff_borrows(oid, ret)
            if ret["kind"] == "inline":
                self.memory_store.put(oid, ("inline", ret["data"]))
            else:
                self.memory_store.put(oid, ("plasma", ret.get("node_id", self.node_id)))
        self._record_task_event(
            tid, info.get("method", "actor_task"),
            "FAILED" if failed else "FINISHED", kind="actor_task")
        aid = info.get("aid")
        if aid and aid not in self._actor_first_ping_seen \
                and obs_timeline.enabled():
            self._actor_first_ping_seen.add(aid)
            obs_timeline.mark_actor(aid, "first_ping",
                                    job_id=self.job_id.hex())
        if info.get("submit_ts"):
            _task_latency_histogram().observe(
                max(0.0, time.time() - info["submit_ts"]),
                tags={"kind": "actor_task"})
        return {"ok": True}

    # ==================================================================
    # Streaming generators — caller side (reference: task_manager.cc:778)
    # ==================================================================
    def _register_stream(self, task_id: TaskID):
        from ray_tpu_torch._private.streaming import ObjectRefGenerator, _StreamState

        st = _StreamState()
        self._streams[task_id] = st
        return ObjectRefGenerator(self, task_id, st)

    def _handle_streaming_yield(
        self, task_id_bin: bytes, index: int, kind: str,
        data: Optional[bytes] = None, node_id: Optional[str] = None,
    ) -> dict:
        tid = TaskID(task_id_bin)
        st = self._streams.get(tid)
        if st is None:
            return {"ok": False}  # stream abandoned — drop
        oid = ObjectID.from_index(tid, index + 1)
        rc = self._ref_counter()
        if not rc.has_reference(oid):
            rc.add_owned_object(oid)
        if kind == "inline":
            self.memory_store.put(oid, ("inline", data))
        else:
            self.memory_store.put(oid, ("plasma", node_id))
        with st.cv:
            st.arrived[index] = oid
            st.notify_locked()
            pending = len(st.arrived)
        return {"ok": True, "pending": pending}

    def _handle_streaming_credit(self, task_id_bin: bytes) -> dict:
        """Producer-side backpressure poll: how many yields sit undelivered
        in this consumer's buffer."""
        st = self._streams.get(TaskID(task_id_bin))
        if st is None:
            return {"ok": False, "pending": 0}
        with st.cv:
            return {"ok": True, "pending": len(st.arrived)}

    def _handle_streaming_done(
        self, task_id_bin: bytes, count: int, error: Optional[bytes] = None
    ) -> dict:
        tid = TaskID(task_id_bin)
        st = self._streams.get(tid)
        if st is None:
            return {"ok": False}
        with st.cv:
            if error is not None:
                err = deserialize(error)
                st.error = err.as_instanceof_cause() if isinstance(err, RayTaskError) else err
            st.total = count
            st.notify_locked()
        return {"ok": True}

    def _abandon_stream(self, task_id: TaskID) -> None:
        """Consumer dropped its ObjectRefGenerator: free undelivered yields
        and refuse further pushes (the producer stops on the first refusal)."""
        st = self._streams.pop(task_id, None)
        if st is None:
            return
        with st.cv:
            oids = list(st.arrived.values())
            st.arrived.clear()
            if st.total is None:
                st.total = st.next_index
            st.notify_locked()
        for oid in oids:
            try:
                self.free_object(oid)
            except Exception:  # noqa: BLE001
                pass

    def _fail_stream(self, task_id: TaskID, err: Exception) -> None:
        st = self._streams.get(task_id)
        if st is None:
            return
        with st.cv:
            if st.error is None and st.total is None:
                st.error = err
            st.notify_locked()

    def _fail_actor_task(self, tid: TaskID, return_oids: List[ObjectID], err: Exception) -> None:
        with self._actor_pending_lock:
            info = self._pending_actor_tasks.pop(tid, None)
            contained = self._actor_task_contained.pop(tid, [])
        self._release_contained_refs(contained)
        self._fail_stream(tid, err)
        self._record_task_event(
            tid, (info or {}).get("method", "actor_task"), "FAILED",
            kind="actor_task")
        data = serialize(err)
        for oid in return_oids:
            if not self.memory_store.contains(oid):
                self.memory_store.put(oid, ("inline", data))

    def _report_actor_fault(self, aid: str, addr: Tuple[str, int], error: str) -> None:
        self._invalidate_actor_addr(aid, addr)
        try:
            self.gcs.call_retrying(
                "ReportActorFault", actor_id=aid, worker_addr=addr, error=error
            )
        except Exception:
            pass

    async def _report_actor_fault_async(
        self, aid: str, addr: Tuple[str, int], error: str,
    ) -> None:
        self._invalidate_actor_addr(aid, addr)
        try:
            await self.gcs.acall(
                "ReportActorFault", actor_id=aid, worker_addr=addr,
                error=error, timeout=15)
        except Exception:  # noqa: BLE001 — advisory
            pass

    def _invalidate_actor_addr(self, aid: str, addr: Tuple[str, int]) -> None:
        cached = self._actor_addr_cache.get(aid)
        if cached is not None and cached[0] == addr:
            self._actor_addr_cache.pop(aid, None)

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True) -> None:
        self._actor_addr_cache.pop(actor_id.hex(), None)
        self.gcs.call_retrying("KillActor", actor_id=actor_id.hex(), no_restart=no_restart)

    def get_actor(self, name: str, namespace: Optional[str] = None):
        aid = self.gcs.call_retrying("GetActorByName", name=name, namespace=namespace or "default")
        if aid is None:
            raise ValueError(f"Failed to look up actor with name '{name}'")
        return ActorID.from_hex(aid)

    def cancel(self, ref: ObjectRef, force: bool = False, recursive: bool = True) -> None:
        """Cancel the task that creates ``ref`` (reference: CancelTask,
        core_worker.cc). Queued tasks are dropped before dispatch; RUNNING
        tasks get TaskCancelledError raised in their executing thread
        (force=True kills the worker process instead)."""
        tid = ref.id().task_id()
        st = self._pending_tasks.get(tid)
        if st is None:
            return
        st["cancelled"] = True  # blocks dispatch-from-queue and retries
        err = serialize(TaskCancelledError(f"Task {tid.hex()[:12]} cancelled"))
        for oid in st["spec"].return_ids():
            if not self.memory_store.contains(oid):
                self.memory_store.put(oid, ("inline", err))
        entry = st.get("entry")
        if entry is not None:  # already pushed to a worker
            try:
                get_client(entry.worker_addr).call(
                    "CancelTask", task_id_bin=tid.binary(), force=force, timeout=10
                )
            except Exception:  # noqa: BLE001
                pass
        self._record_task_event(
            tid, st["spec"].function_descriptor.repr_name, "FAILED")

    # ==================================================================
    # Placement groups
    # ==================================================================
    def create_placement_group(self, bundles, strategy, name=""):
        from ray_tpu_torch._private.ids import PlacementGroupID

        pg_id = PlacementGroupID.from_random()
        self.gcs.call_retrying(
            "CreatePlacementGroup",
            pg_id=pg_id.hex(),
            name=name,
            bundles=bundles,
            strategy=strategy,
            creator_job=self.job_id.hex(),
        )
        return pg_id

    def remove_placement_group(self, pg_id) -> None:
        self.gcs.call_retrying("RemovePlacementGroup", pg_id=pg_id.hex())

    def placement_group_ready(self, pg_id, timeout=None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            info = self.gcs.call_retrying("GetPlacementGroup", pg_id=pg_id.hex())
            if info and info["state"] == "CREATED":
                return True
            if info and info["state"] in ("REMOVED", "INFEASIBLE"):
                return False
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(0.05)

    def get_placement_group_info(self, pg_id) -> Optional[dict]:
        return self.gcs.call_retrying("GetPlacementGroup", pg_id=pg_id.hex())

    # ==================================================================
    # Cluster info
    # ==================================================================
    def cluster_resources(self) -> Dict[str, float]:
        return self.gcs.call_retrying("GetClusterResources")["total"]

    def available_resources(self) -> Dict[str, float]:
        return self.gcs.call_retrying("GetClusterResources")["available"]

    def nodes(self) -> List[Dict[str, Any]]:
        return self.gcs.call_retrying("GetAllNodeInfo")

    def shutdown(self) -> None:
        if self._shutdown:
            return
        self._shutdown = True
        self._release_queue.put(None)  # ends _release_loop
        with self._actor_disp_lock:
            for d in self._actor_dispatchers.values():
                d.stop()
        self.server.stop()
        try:
            self.plasma.close()
        except Exception:
            logger.debug("plasma close failed at shutdown", exc_info=True)
        # close every RPC client this process opened: each one owns a
        # read-loop task that must be cancelled AND awaited, or asyncio
        # logs "Task was destroyed but it is pending!" at exit
        from ray_tpu_torch._private.rpc import clear_client_cache

        for c in (self.gcs, self.raylet):
            try:
                c.close()
            except Exception:  # noqa: BLE001
                pass
        try:
            clear_client_cache()
        except Exception:  # noqa: BLE001
            pass
