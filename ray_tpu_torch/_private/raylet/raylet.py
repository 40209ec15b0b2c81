"""Raylet — the per-node daemon: worker pool + local scheduler + leases
(copy of ray_tpu/_private/raylet/raylet.py, leasing cards where JAX's
leases TPU chips).

Reference: src/ray/raylet/ — NodeManager (node_manager.h:144, lease RPCs
node_manager.cc:1834/2136), WorkerPool (worker_pool.h:280 PopWorker/
PrestartWorkers), scheduling (cluster_lease_manager.cc:45 queue, :194
schedule-and-grant), PlacementGroupResourceManager (2PC bundle reserve).

Cards as instances: the resource set tracks individual card ids ("GPU"),
as JAX's tracks TPU chips; a lease that asks for ``GPU: n`` is granted
concrete ids and its worker gets ``CUDA_VISIBLE_DEVICES`` set before user
code runs (the reference's set_visible_accelerator_ids, worker.py:876). A
worker keeps the card set of its first lease (none included): CUDA reads
``CUDA_VISIBLE_DEVICES`` once, at its first call, so a worker is only
leased again with the same set (``_get_idle_worker``), as a worker that
applied one runtime env is never leased for another. "TPU" is a plain
countable resource here. Nothing in this process makes a CUDA call: the
zygote and the workers it forks must start with CUDA uninitialized.

The raylet also supervises the node's object-store daemon and its worker
processes (it is their parent, like the reference's raylet forking language
workers via WorkerPool::StartWorkerProcess).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

from ray_tpu_torch._private import debug_locks
from ray_tpu_torch._private.config import config
from ray_tpu_torch._private.ids import NodeID
from ray_tpu_torch._private.rpc import LoopHandle, RpcClient, RpcServer
from ray_tpu_torch.observability import dump as obs_dump
from ray_tpu_torch.observability import events as obs_events

logger = logging.getLogger("ray_tpu_torch.raylet")


# ---------------------------------------------------------------------------
# Resource accounting (reference: src/ray/common/scheduling/
# cluster_resource_data.h ResourceSet/ResourceInstanceSet — cards are
# tracked as instances so leases get concrete card ids)
# ---------------------------------------------------------------------------
class ResourceSet:
    def __init__(self, total: Dict[str, float], gpu_ids: Optional[List[int]] = None):
        """``gpu_ids``: the host card ids this node owns (a multi-node
        cluster on one host gives each node its own); by default the
        node's "GPU" count numbered from 0."""
        self.total = dict(total)
        self.available = dict(total)
        n_gpu = int(total.get("GPU", 0))
        if gpu_ids is not None and len(gpu_ids) != n_gpu:
            raise ValueError(f"{n_gpu} GPUs but card ids {list(gpu_ids)}")
        self.free_gpu_ids: List[int] = sorted(gpu_ids) if gpu_ids is not None \
            else list(range(n_gpu))

    def can_fit(self, req: Dict[str, float]) -> bool:
        return all(self.available.get(k, 0.0) + 1e-9 >= v for k, v in req.items())

    def feasible(self, req: Dict[str, float]) -> bool:
        return all(self.total.get(k, 0.0) + 1e-9 >= v for k, v in req.items())

    def allocate(self, req: Dict[str, float]) -> Optional[Dict[str, Any]]:
        if not self.can_fit(req):
            return None
        for k, v in req.items():
            self.available[k] = self.available.get(k, 0.0) - v
        ids: List[int] = []
        n = int(req.get("GPU", 0))
        if n > 0:
            ids = self.free_gpu_ids[:n]
            self.free_gpu_ids = self.free_gpu_ids[n:]
        return {"resources": dict(req), "gpu_ids": ids}

    def release(self, alloc: Dict[str, Any]) -> None:
        for k, v in alloc.get("resources", {}).items():
            self.available[k] = min(self.total.get(k, 0.0), self.available.get(k, 0.0) + v)
        ids = alloc.get("gpu_ids", [])
        if ids:
            self.free_gpu_ids.extend(ids)
            self.free_gpu_ids.sort()


# the least time a restored object is kept from spilling while its reader
# comes to pin it (see _spill_until)
RESTORE_GRACE_MIN_S = 0.5


def _proc_start_time(pid: int) -> int:
    """The process's start time in clock ticks since boot (field 22 of
    /proc/<pid>/stat), psutil's create_time without psutil: a recycled
    pid has another."""
    with open(f"/proc/{pid}/stat") as f:
        stat = f.read()
    # the command name (field 2) may hold spaces: split after its ')'
    return int(stat[stat.rindex(")") + 2:].split()[19])


class ZygoteProc:
    """Popen-shaped view of a worker forked by the zygote (the zygote,
    not this raylet, is its parent — liveness comes from a pidfd, which
    signals readable once the process exits, zombie included).
    Readiness is checked with select.poll(), NOT select.select(): with
    thousands of workers each holding a pidfd plus sockets, fds exceed
    1023 and select() raises. The no-pidfd fallback pins the process's
    create time so a recycled pid (the zygote reaps promptly) cannot
    impersonate a live worker."""

    def __init__(self, pid: int):
        self.pid = pid
        self.returncode: Optional[int] = None
        self._create_time: Optional[float] = None
        try:
            self._pidfd = os.pidfd_open(pid)
        except (OSError, AttributeError) as e:
            self._pidfd = None
            logger.warning("pidfd_open(%d) failed (%s); falling back to "
                           "create-time liveness probing", pid, e)
            try:
                self._create_time = _proc_start_time(pid)
            except Exception:  # noqa: BLE001 — already gone
                self.returncode = 0

    def poll(self) -> Optional[int]:
        if self.returncode is not None:
            return self.returncode
        if self._pidfd is not None:
            import select as _select

            p = _select.poll()
            p.register(self._pidfd, _select.POLLIN)
            if not p.poll(0):
                return None
        else:
            try:
                if _proc_start_time(self.pid) == self._create_time:
                    return None
            except Exception:  # noqa: BLE001 — gone or recycled
                pass
        self.returncode = 0  # exit code unknowable for a non-child
        if self._pidfd is not None:
            try:
                os.close(self._pidfd)
            except OSError:
                pass
            self._pidfd = None
        return self.returncode

    def terminate(self) -> None:
        try:
            os.kill(self.pid, signal.SIGTERM)
        except ProcessLookupError:
            pass

    def kill(self) -> None:
        try:
            os.kill(self.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass

    def wait(self, timeout: Optional[float] = None) -> Optional[int]:
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.poll() is None:
            if deadline is not None and time.monotonic() > deadline:
                raise subprocess.TimeoutExpired("zygote-worker", timeout)
            time.sleep(0.02)
        return self.returncode


class Zygote:
    """Client for the prefork worker factory (workers/zygote.py): one
    warmed child process; each spawn request forks it in ~ms instead of
    paying a cold interpreter + import chain per worker."""

    def __init__(self, env: Dict[str, str], session_dir: str):
        self._lock = debug_locks.maybe_wrap(
            threading.Lock(), "raylet.Zygote._lock")
        self._log = open(os.path.join(session_dir, "zygote.log"), "ab")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch._private.workers.zygote"],
            env=env,
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=self._log,
        )

    def alive(self) -> bool:
        return self.proc.poll() is None

    def spawn(self, env: Dict[str, str], log_path: str) -> int:
        msg = json.dumps({"env": env, "log_path": log_path}) + "\n"
        with self._lock:
            self.proc.stdin.write(msg.encode())
            self.proc.stdin.flush()
            line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError("zygote exited")
        reply = json.loads(line)
        if "pid" not in reply:
            raise RuntimeError(f"zygote spawn failed: {reply.get('error')}")
        return reply["pid"]

    def stop(self) -> None:
        try:
            self.proc.terminate()
        except Exception:  # noqa: BLE001
            pass
        try:
            self._log.close()
        except Exception:  # noqa: BLE001
            pass


@dataclass
class WorkerHandle:
    worker_id: str
    proc: Any  # subprocess.Popen | ZygoteProc
    addr: Optional[Tuple[str, int]] = None
    registered: asyncio.Event = field(default_factory=asyncio.Event)
    busy_lease: Optional[str] = None
    idle_since: float = field(default_factory=time.monotonic)
    dead: bool = False
    # runtime env this worker is tainted with ("" = clean). A worker
    # that applied env A is never leased for env B (reference: the
    # worker pool dedicates workers per runtime env, worker_pool.h:280)
    env_hash: str = ""
    # the card ids of its first lease (None = never leased; () = no
    # card, CUDA_VISIBLE_DEVICES=""): CUDA fixes the visible cards at
    # its first call, so the worker is never leased another set
    gpu_ids: Optional[Tuple[int, ...]] = None


@dataclass
class Lease:
    lease_id: str
    worker: WorkerHandle
    alloc: Dict[str, Any]
    scheduling_class: Any
    job_id: str
    for_actor: Optional[str] = None
    blocked: bool = False  # worker is blocked in get(); CPU released
    cpu_released: bool = False  # actor lease: CPU returned after grant
    granted_at: float = field(default_factory=time.monotonic)


@dataclass
class PendingLease:
    request: dict
    future: asyncio.Future


class Raylet:
    def __init__(
        self,
        node_id: str,
        gcs_addr: Tuple[str, int],
        resources: Dict[str, float],
        store_socket: str,
        store_capacity: int,
        port: int = 0,
        is_head: bool = False,
        labels: Optional[Dict[str, str]] = None,
        session_dir: str = "",
        gpu_ids: Optional[List[int]] = None,
    ):
        self.node_id = node_id
        self.gcs_addr = gcs_addr
        self.resources = ResourceSet(resources, gpu_ids)
        self.store_socket = store_socket
        self.store_capacity = store_capacity
        self.is_head = is_head
        self.labels = labels or {}
        self.session_dir = session_dir or tempfile.mkdtemp(prefix="ray_tpu_")
        self.server = RpcServer(port=port, name="raylet")
        self.server.register_instance(self)
        self.gcs: Optional[RpcClient] = None
        self.store_proc: Optional[subprocess.Popen] = None
        self.workers: Dict[str, WorkerHandle] = {}
        self.idle_workers: List[WorkerHandle] = []
        self.leases: Dict[str, Lease] = {}
        self.pending: List[PendingLease] = []
        self.autoscaling_enabled = False
        self._pending_death_notices: List[dict] = []
        self._death_flush_running = False
        # placement group bundles: (pg_id, bundle_index) -> alloc
        self.prepared_bundles: Dict[Tuple[str, int], Dict[str, Any]] = {}
        self.committed_bundles: Dict[Tuple[str, int], "ResourceSet"] = {}
        self._starting_workers = 0
        # ids whose spawn is in flight on an executor thread (_spawn_worker)
        self._spawning: Set[str] = set()
        # worker-pool replenishment: peak concurrent leases over the
        # recent window; after churn (actor kills, OOM reaps) the reap
        # loop respawns idle workers back toward this level so the next
        # burst's leases find warm registered workers instead of paying
        # zygote spawns inside the lease path (reference: WorkerPool
        # prestart-on-demand). Decays to 0 after 30s without a grant.
        self._recent_lease_peak = 0
        self._recent_lease_ts = 0.0
        self._zygote: Optional[Zygote] = None
        self._zygote_lock = threading.Lock()
        self.num_oom_kills = 0
        # single-consumer drain: _drain_pending rebuilds self.pending and
        # must never run reentrantly (two interleaved drains clobber each
        # other's rebuild); callers kick the event instead of calling it
        self._drain_wakeup: Optional[asyncio.Event] = None
        # cluster resource view, refreshed from GCS heartbeat replies
        # (reference: ray_syncer.h:91); drives lease spillback
        self.cluster_view: Dict[str, dict] = {}
        # client to this node's own store daemon, for serving object pulls
        # (reference: object_manager.cc:587 HandlePush / :221 Pull)
        self.store = None
        # in-flight outbound transfers: oid -> {view, last_used, readers};
        # guarded by _pull_pins_lock (touched from executor threads + loop)
        self._pull_pins: Dict[Any, dict] = {}
        self._pull_pins_lock = threading.Lock()
        # Spilling (reference: local_object_manager.h:145 SpillObjects /
        # :157 restore): the store runs no-evict; on pressure this raylet
        # moves LRU sealed+unpinned objects to disk and restores on read.
        # oid_bin -> (path, size); guarded by _spill_lock.
        self.spill_dir = config.object_spilling_dir or os.path.join(
            self.session_dir, "spill"
        )
        self.spilled: Dict[bytes, Tuple[str, int]] = {}
        # _spill_lock guards the `spilled` dict ONLY (held briefly — async
        # handlers touch it on the event loop); _spill_work_lock serializes
        # whole spill/restore batches on executor threads (held across disk
        # IO; reentrant because restore-on-full spills recursively)
        self._spill_lock = threading.Lock()
        self._spill_work_lock = threading.RLock()
        self._spilled_bytes_total = 0
        self._restored_bytes_total = 0
        # freshly restored objects get a short no-respill grace so the
        # reader that asked for the restore can pin them before the next
        # spill round picks them (they are sealed+unpinned+LRU-old)
        self._restore_grace: Dict[bytes, float] = {}
        # graceful drain (reference: NodeManager::HandleDrainRaylet):
        # once draining, no lease is ever granted again; in-flight task
        # leases run out (bounded by the deadline), primary object
        # copies are pushed to a survivor, then this daemon deregisters
        # and exits
        self.draining = False
        self.drain_reason = ""
        self.drain_deadline = 0.0
        self._drain_task: Optional[asyncio.Task] = None
        # inbound drain-pushed objects mid-transfer: oid_bin -> buffer
        self._incoming_objects: Dict[bytes, Any] = {}

    # ------------------------------------------------------------------
    # Worker pool (reference: worker_pool.h:280)
    # ------------------------------------------------------------------
    def _worker_env(self, worker_id: str = "") -> Dict[str, str]:
        env = dict(os.environ)
        if worker_id:
            env["RAY_TPU_WORKER_ID"] = worker_id
        env["RAY_TPU_RAYLET_ADDR"] = f"{self.server.host}:{self.server.port}"
        env["RAY_TPU_GCS_ADDR"] = f"{self.gcs_addr[0]}:{self.gcs_addr[1]}"
        env["RAY_TPU_STORE_SOCKET"] = self.store_socket
        env["RAY_TPU_NODE_ID"] = self.node_id
        env["RAY_TPU_CONFIG_JSON"] = config.to_json()
        # cards are assigned per lease via CUDA_VISIBLE_DEVICES
        # (SetLeaseContext); the worker maps lease ids through the
        # visible list it inherits here
        return env

    def _get_zygote(self) -> Optional[Zygote]:
        if not config.worker_zygote_enabled:
            return None
        # _spawn_worker runs on executor threads — without the lock a
        # spawn burst would race two Zygote() constructions and orphan
        # one warmed process
        with self._zygote_lock:
            z = self._zygote
            if z is not None and z.alive():
                return z
            if z is not None:
                z.stop()
            try:
                # lazily (re)started: the server port is only known after
                # start, and a crashed zygote must not take the pool down
                self._zygote = Zygote(self._worker_env(), self.session_dir)
            except Exception:  # noqa: BLE001
                logger.exception("zygote start failed; using cold spawns")
                self._zygote = None
            return self._zygote

    def _spawn_worker(self) -> WorkerHandle:
        worker_id = uuid.uuid4().hex
        # a worker forked from a warm zygote can register before this
        # thread files its handle: RegisterWorker waits while the id is here
        self._spawning.add(worker_id)
        try:
            return self._spawn_worker_as(worker_id)
        finally:
            self._spawning.discard(worker_id)

    def _spawn_worker_as(self, worker_id: str) -> WorkerHandle:
        log_path = os.path.join(self.session_dir, f"worker-{worker_id[:8]}.log")
        proc: Any = None
        zygote = self._get_zygote()
        # spawn instant, on this host's monotonic clock: the worker
        # attaches its age-at-CreateActor to the worker_started mark so
        # timelines can tell a cold fork+boot from a pooled/prestarted
        # worker without trusting a backdated stamp
        spawn_env = {"RAY_TPU_WORKER_ID": worker_id,
                     "RAY_TPU_WORKER_SPAWNED_MONO": repr(time.monotonic())}
        if zygote is not None:
            try:
                pid = zygote.spawn(spawn_env, log_path)
                proc = ZygoteProc(pid)
            except Exception:  # noqa: BLE001
                logger.exception("zygote spawn failed; cold spawn instead")
        if proc is None:
            env = self._worker_env(worker_id)
            env.update(spawn_env)
            with open(log_path, "ab") as logf:
                proc = subprocess.Popen(
                    [sys.executable, "-m",
                     "ray_tpu_torch._private.workers.default_worker"],
                    env=env,
                    stdout=logf,
                    stderr=subprocess.STDOUT,
                )
        handle = WorkerHandle(worker_id=worker_id, proc=proc)
        self.workers[worker_id] = handle
        return handle

    async def PrestartWorkers(self, count: int = 1) -> dict:
        """Ensure up to ``count`` spare workers are idle or starting
        (reference: WorkerPool::PrestartWorkers). The GCS fires this
        when a burst of PENDING actors queues at its creation gates, and
        the reap loop fires it to replenish after churn — zygote spawns
        then overlap the gated lease+CreateActor pipelines instead of
        running inside them; each spawned worker parks in the idle pool
        on registration and the next lease request grants instantly."""
        if self.draining:
            return {"started": 0}
        supply = len(self.idle_workers) + self._starting_workers
        room = (config.max_workers_per_node - len(self.workers)
                - self._starting_workers)
        spawn = min(max(0, int(count)) - supply, room)
        started = 0
        loop = asyncio.get_event_loop()
        for _ in range(max(0, spawn)):
            self._starting_workers += 1
            started += 1

            async def _boot():
                try:
                    handle = await loop.run_in_executor(
                        None, self._spawn_worker)
                    try:
                        await asyncio.wait_for(
                            handle.registered.wait(),
                            timeout=config.worker_startup_timeout_s)
                    except asyncio.TimeoutError:
                        handle.dead = True
                        handle.proc.kill()
                        self.workers.pop(handle.worker_id, None)
                        return
                    handle.idle_since = time.monotonic()
                    self.idle_workers.append(handle)
                    self._kick_drain()
                except Exception:  # noqa: BLE001 — prestart is advisory
                    logger.exception("prestart spawn failed")
                finally:
                    self._starting_workers -= 1

            asyncio.ensure_future(_boot())
        return {"started": started}

    async def RegisterWorker(self, worker_id: str, addr: Tuple[str, int]) -> dict:
        # the id is in _spawning until its handle is in workers, so a
        # worker that raced its spawner is held, never turned away
        while worker_id not in self.workers and worker_id in self._spawning:
            await asyncio.sleep(0.005)
        handle = self.workers.get(worker_id)
        if handle is None:
            return {"ok": False}
        handle.addr = tuple(addr)
        handle.registered.set()
        logger.info("worker %s registered at %s", worker_id[:8], addr)
        return {"ok": True, "node_id": self.node_id}

    async def _get_idle_worker(self, env_hash: str = "",
                               gpu_ids: Tuple[int, ...] = ()) -> Optional[WorkerHandle]:
        # prefer a worker already tainted with THIS env, then a clean
        # one (which the env will taint); never cross-match envs. A
        # worker serves only the card set of its first lease.
        match = None
        for w in reversed(self.idle_workers):
            if w.dead or w.proc.poll() is not None:
                continue
            if w.gpu_ids is not None and w.gpu_ids != gpu_ids:
                continue
            if w.env_hash == env_hash:
                match = w
                break
            if match is None and not w.env_hash:
                match = w
        if match is not None:
            self.idle_workers.remove(match)
            match.env_hash = env_hash or match.env_hash
            match.gpu_ids = gpu_ids
            # drop any dead entries we skipped over
            self.idle_workers = [
                w for w in self.idle_workers
                if not w.dead and w.proc.poll() is None
            ]
            return match
        self.idle_workers = [
            w for w in self.idle_workers
            if not w.dead and w.proc.poll() is None
        ]
        if len(self.workers) + self._starting_workers >= config.max_workers_per_node:
            if not self.idle_workers:
                return None
            # at the cap with only env-mismatched idle workers: evict one
            # to make room (reference: the worker pool kills idle workers
            # of other envs rather than starving the request)
            victim = self.idle_workers.pop(0)
            victim.dead = True
            self.workers.pop(victim.worker_id, None)
            try:
                victim.proc.terminate()
            except Exception:  # noqa: BLE001
                pass
            logger.info(
                "evicted idle worker %s (env %s) to serve a different env",
                victim.worker_id[:8], victim.env_hash[:8] or "<clean>")
        self._starting_workers += 1
        try:
            # executor thread: a zygote boot (first spawn) or a cold
            # Popen must not stall the raylet's event loop
            handle = await asyncio.get_event_loop().run_in_executor(
                None, self._spawn_worker)
            logger.debug("spawning worker %s (pid %s)", handle.worker_id[:8], handle.proc.pid)
            try:
                await asyncio.wait_for(
                    handle.registered.wait(), timeout=config.worker_startup_timeout_s
                )
            except asyncio.TimeoutError:
                logger.error(
                    "worker %s failed to register in time (proc poll=%s)",
                    handle.worker_id[:8],
                    handle.proc.poll(),
                )
                handle.dead = True
                handle.proc.kill()
                self.workers.pop(handle.worker_id, None)
                return None
            handle.env_hash = env_hash
            handle.gpu_ids = gpu_ids
            return handle
        finally:
            self._starting_workers -= 1

    # ------------------------------------------------------------------
    # Lease protocol (reference: node_manager.cc:1834 HandleRequestWorkerLease,
    # cluster_lease_manager.cc queue/grant)
    # ------------------------------------------------------------------
    async def RequestWorkerLease(
        self,
        resources: Dict[str, float],
        scheduling_class: Any,
        job_id: str,
        for_actor: Optional[str] = None,
        pg_id: Optional[str] = None,
        bundle_index: int = -1,
        lease_timeout: float = 25.0,
        release_cpu_after_grant: bool = False,
        allow_spillback: bool = True,
        hard_node_constraint: str = "",
        runtime_env_hash: str = "",
    ) -> dict:
        if self.draining:
            # a draining node grants nothing new; the redirect (when a
            # survivor exists) lets the caller re-lease in one hop, and
            # the caller's drain-aware retry never burns max_retries on it
            return self._draining_reply(resources, pg_id=pg_id,
                                        hard_node_constraint=hard_node_constraint)
        req = {
            "resources": dict(resources),
            "scheduling_class": scheduling_class,
            "job_id": job_id,
            "for_actor": for_actor,
            "pg_id": pg_id,
            "bundle_index": bundle_index,
            "release_cpu_after_grant": release_cpu_after_grant,
            "runtime_env_hash": runtime_env_hash,
            # "pinned" (hard NodeAffinity) / "labeled" (hard NodeLabel):
            # the lease must run HERE — distinct from allow_spillback=False
            # alone, which also marks already-spilled requests (loop
            # prevention) that may still be redirected. A pinned lease that
            # can't fit is infeasible outright; a labeled one may be served
            # by another matching or autoscaled node after caller retry.
            "hard_node_constraint": hard_node_constraint,
            "allow_spillback": allow_spillback,
        }
        logger.debug(
            "lease request %s avail=%s idle=%d workers=%d",
            resources,
            self.resources.available,
            len(self.idle_workers),
            len(self.workers),
        )
        grant = await self._try_grant(req)
        if grant is not None:
            return grant
        rs, _ = self._resource_set_for(req)
        # Spillback (reference: cluster_lease_manager.cc:420): the local node
        # can't serve the request right now — redirect the caller to a node
        # that can. Never for PG leases (bundles are node-pinned), and a
        # spilled request can't spill again (loop prevention).
        if allow_spillback and not pg_id:
            if not rs.feasible(req["resources"]):
                # can NEVER run here: any node whose totals fit will do
                target = self._pick_spillback(req["resources"], require_available=False)
            elif not rs.can_fit(req["resources"]):
                # feasible but saturated: spill only to a node with capacity now
                target = self._pick_spillback(req["resources"], require_available=True)
            else:
                target = None  # local can serve (worker may still be spawning)
            if target is not None:
                return {"granted": False, "spillback": target}
        if not rs.feasible(self._cpu_only(req["resources"], pg_id)):
            if hard_node_constraint == "pinned":
                # pinned to THIS node and can never fit here: no spillback,
                # and no autoscaled node can ever serve it — fail now
                return self._infeasible_reply(req["resources"], rs)
            if hard_node_constraint == "labeled" and \
                    not self.autoscaling_enabled:
                # the caller already picked the best label match; with no
                # autoscaler a bigger matching node will never appear
                return self._infeasible_reply(req["resources"], rs)
            if allow_spillback and not pg_id:
                # The cluster view may be a couple of heartbeats behind (a
                # just-joined node propagates via its heartbeat to GCS, then
                # ours). Wait ~2 periods with a populated view, longer when
                # the raylet just started and has no view at all.
                hb = config.raylet_heartbeat_period_ms / 1000.0
                grace = max(1.0, 2 * hb) if self.cluster_view else max(1.0, 4 * hb)
                target = await self._await_spillback(req["resources"], grace)
                if target is not None:
                    return {"granted": False, "spillback": target}
            if not self.autoscaling_enabled:
                return self._infeasible_reply(resources, rs)
            # An attached autoscaler may add a node that fits: queue the
            # request so its shape shows up as demand in heartbeats
            # (reference: infeasible tasks wait for the autoscaler); the
            # caller's retry-after-timeout picks up the new node via
            # spillback.
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        pl = PendingLease(req, fut)
        self.pending.append(pl)
        try:
            return await asyncio.wait_for(fut, timeout=lease_timeout)
        except asyncio.TimeoutError:
            try:
                self.pending.remove(pl)
            except ValueError:
                pass
            return {"granted": False, "infeasible": False, "error": "lease wait timed out"}

    def _cpu_only(self, resources: Dict[str, float], pg_id: Optional[str]) -> Dict[str, float]:
        return dict(resources)

    @staticmethod
    def _infeasible_reply(resources: Dict[str, float], rs) -> dict:
        return {
            "granted": False,
            "infeasible": True,
            "error": f"resources {resources} can never be satisfied on "
            f"this node (total: {rs.total})",
        }

    async def _await_spillback(
        self, resources: Dict[str, float], timeout_s: float
    ) -> Optional[Tuple[str, int]]:
        """Poll the heartbeat-synced cluster view for a node whose totals fit
        a locally-infeasible request (covers view staleness at startup and
        nodes that just joined)."""
        deadline = time.monotonic() + timeout_s
        while True:
            target = self._pick_spillback(resources, require_available=False)
            if target is not None:
                return target
            if time.monotonic() >= deadline:
                return None
            await asyncio.sleep(0.1)

    def _pick_spillback(
        self, resources: Dict[str, float], require_available: bool
    ) -> Optional[Tuple[str, int]]:
        """Pick another node's raylet for lease spillback: rank candidates
        by availability, then choose RANDOMLY among the top-k (reference:
        hybrid_scheduling_policy.h:29-46 — the top-k jitter stops every
        node in the cluster from herding onto one 'best' target)."""
        import random as _random

        candidates = []
        for nid, info in self.cluster_view.items():
            if nid == self.node_id or not info.get("alive") \
                    or info.get("draining"):
                continue
            total = info.get("total", {})
            avail = info.get("available", {})
            if not all(total.get(k, 0.0) + 1e-9 >= v for k, v in resources.items()):
                continue
            has_now = all(avail.get(k, 0.0) + 1e-9 >= v for k, v in resources.items())
            if require_available and not has_now:
                continue
            score = (1 if has_now else 0, avail.get("CPU", 0.0))
            candidates.append((score, tuple(info["addr"])))
        if not candidates:
            return None
        candidates.sort(key=lambda c: c[0], reverse=True)
        k = max(config.scheduler_top_k_absolute,
                int(len(candidates) * config.scheduler_top_k_fraction))
        return _random.choice(candidates[:max(1, k)])[1]

    def _resource_set_for(self, req: dict) -> Tuple[ResourceSet, Optional[Tuple[str, int]]]:
        """Returns (resource_set, committed_bundle_key). The key is the
        RESOLVED bundle (never index -1) so release finds the same set."""
        pg_id = req.get("pg_id")
        if pg_id:
            key = (pg_id, req.get("bundle_index", -1))
            if key in self.committed_bundles:
                return self.committed_bundles[key], key
            # bundle_index -1: any committed bundle of that pg with room
            for (p, idx), rs in self.committed_bundles.items():
                if p == pg_id and rs.can_fit(req["resources"]):
                    return rs, (p, idx)
            for (p, idx), rs in self.committed_bundles.items():
                if p == pg_id:
                    return rs, (p, idx)
        return self.resources, None

    async def _try_grant(self, req: dict) -> Optional[dict]:
        rs, pg_key = self._resource_set_for(req)
        # allocate BEFORE any await: resource accounting is what bounds
        # concurrent lease grants (and worker spawns) on this node
        alloc = rs.allocate(req["resources"])
        if alloc is None:
            return None
        worker = await self._get_idle_worker(req.get("runtime_env_hash") or "",
                                             tuple(alloc["gpu_ids"]))
        if worker is None:
            rs.release(alloc)
            return None
        alloc["from_pg"] = pg_key
        lease_id = uuid.uuid4().hex
        lease = Lease(
            lease_id=lease_id,
            worker=worker,
            alloc=alloc,
            scheduling_class=req["scheduling_class"],
            job_id=req["job_id"],
            for_actor=req.get("for_actor"),
        )
        worker.busy_lease = lease_id
        self.leases[lease_id] = lease
        now = time.monotonic()
        if len(self.leases) >= self._recent_lease_peak:
            self._recent_lease_peak = len(self.leases)
        self._recent_lease_ts = now
        logger.debug("granting lease %s to worker %s (avail now %s)", lease_id[:8], worker.worker_id[:8], rs.available)
        # configure the leased worker's visible cards. The client
        # binds to THIS loop (LoopHandle): the SetLeaseContext roundtrip
        # runs in-line on the raylet's own event loop instead of hopping
        # threads to the global client loop and back.
        wclient = RpcClient(worker.addr[0], worker.addr[1],
                            self._loop_handle())
        try:
            await wclient.acall(
                "SetLeaseContext",
                lease_id=lease_id,
                gpu_ids=alloc["gpu_ids"],
                resources=alloc["resources"],
                timeout=10,
            )
        except Exception as e:  # noqa: BLE001
            logger.warning("failed to set lease context on worker: %s", e)
            self._release_lease(lease, worker_dead=True)
            return None
        finally:
            # close on the failure path too — one leaked RpcClient per
            # failed SetLeaseContext pins a socket and read-loop task
            # (RC006)
            wclient.close()
        if req.get("release_cpu_after_grant"):
            # actor with defaulted num_cpus: CPU was only a scheduling
            # requirement — hand it back so long-lived actors don't starve
            # task leases (reference: actors hold 0 CPU while alive)
            cpu = alloc["resources"].get("CPU", 0.0)
            if cpu:
                lease.cpu_released = True
                rs.available["CPU"] = rs.available.get("CPU", 0.0) + cpu
                self._kick_drain()
        return {
            "granted": True,
            "lease_id": lease_id,
            "worker_addr": worker.addr,
            "worker_id": worker.worker_id,
            "gpu_ids": alloc["gpu_ids"],
        }

    def _release_lease(self, lease: Lease, worker_dead: bool) -> None:
        rs = self._rs_for_lease(lease)
        alloc = lease.alloc
        if lease.blocked or lease.cpu_released:
            # the CPU share was already released (worker blocked in get(),
            # or an actor lease that only used CPU for scheduling)
            res = dict(alloc["resources"])
            res.pop("CPU", None)
            alloc = dict(alloc, resources=res)
        rs.release(alloc)
        self.leases.pop(lease.lease_id, None)
        w = lease.worker
        w.busy_lease = None
        if worker_dead or w.proc.poll() is not None:
            w.dead = True
            self.workers.pop(w.worker_id, None)
            try:
                w.proc.kill()
            except Exception:
                pass
        else:
            w.idle_since = time.monotonic()
            self.idle_workers.append(w)

    async def NotifyWorkerBlocked(self, lease_id: str) -> dict:
        """Worker is blocked in get() waiting on objects: temporarily release
        its CPU so dependents can run (reference: NodeManager::
        HandleNotifyDirectCallTaskBlocked, src/ray/raylet/node_manager.cc —
        prevents nested-task deadlock). Cards stay assigned."""
        lease = self.leases.get(lease_id)
        if lease is not None and not lease.blocked:
            lease.blocked = True
            cpu = lease.alloc["resources"].get("CPU", 0.0)
            if cpu and not lease.cpu_released:
                rs = self._rs_for_lease(lease)
                rs.available["CPU"] = rs.available.get("CPU", 0.0) + cpu
            self._kick_drain()
        return {"ok": True}

    async def NotifyWorkerUnblocked(self, lease_id: str) -> dict:
        lease = self.leases.get(lease_id)
        if lease is not None and lease.blocked:
            lease.blocked = False
            cpu = lease.alloc["resources"].get("CPU", 0.0)
            if cpu and not lease.cpu_released:
                # may go negative: transient oversubscription, like the
                # reference's cpu-borrowing on unblock
                rs = self._rs_for_lease(lease)
                rs.available["CPU"] = rs.available.get("CPU", 0.0) - cpu
        return {"ok": True}

    def _rs_for_lease(self, lease: Lease) -> ResourceSet:
        if lease.alloc.get("from_pg"):
            return self.committed_bundles.get(tuple(lease.alloc["from_pg"]), self.resources)
        return self.resources

    async def ReturnWorkerLease(self, lease_id: str, worker_dead: bool = False) -> dict:
        lease = self.leases.get(lease_id)
        logger.debug("return lease %s (found=%s, dead=%s)", lease_id[:8], lease is not None, worker_dead)
        if lease is None:
            return {"ok": False}
        self._release_lease(lease, worker_dead)
        self._kick_drain()
        return {"ok": True}

    def _undo_grant(self, grant: dict) -> None:
        """Roll back a grant whose requester vanished (timed-out future)."""
        lease = self.leases.get(grant["lease_id"])
        if lease is not None:
            self._release_lease(lease, worker_dead=False)

    def _kick_drain(self) -> None:
        if self._drain_wakeup is not None:
            self._drain_wakeup.set()

    async def _drain_loop(self) -> None:
        """Sole consumer of self.pending — see _drain_wakeup comment."""
        self._drain_wakeup = asyncio.Event()
        while True:
            try:
                await asyncio.wait_for(self._drain_wakeup.wait(), timeout=0.5)
            except asyncio.TimeoutError:
                pass
            self._drain_wakeup.clear()
            try:
                await self._drain_pending()
            except Exception:  # noqa: BLE001
                logger.exception("pending-lease drain failed")

    async def _drain_pending(self) -> None:
        still: List[PendingLease] = []
        for p in self.pending:
            if p.future.done():
                continue
            grant = await self._try_grant(p.request)
            if grant is None:
                # a queued request this node can NEVER serve (it sits here
                # as autoscaler demand) redirects the moment a fitting node
                # appears in the cluster view — without this, the caller
                # only reaches a fresh node after its full lease timeout,
                # and the autoscaler sees the new node as idle and kills
                # it (scale-up/terminate flapping)
                rs, _ = self._resource_set_for(p.request)
                if not p.request.get("pg_id") and \
                        not rs.feasible(p.request["resources"]):
                    # a hard node constraint must never be redirected
                    # elsewhere (spilled requests — allow_spillback=False
                    # without the constraint — may still be re-redirected):
                    # pinned fails precisely; labeled stays queued as
                    # autoscaler demand until the caller's timeout retry
                    # re-picks among (possibly new) matching nodes
                    hard = p.request.get("hard_node_constraint")
                    if hard == "pinned":
                        if not p.future.done():
                            try:
                                p.future.set_result(self._infeasible_reply(
                                    p.request["resources"], rs))
                            except asyncio.InvalidStateError:
                                pass
                        continue
                    if hard == "labeled":
                        still.append(p)
                        continue
                    target = self._pick_spillback(
                        p.request["resources"], require_available=False)
                    if target is not None and not p.future.done():
                        try:
                            p.future.set_result(
                                {"granted": False, "spillback": target})
                        except asyncio.InvalidStateError:
                            pass
                        continue
                elif p.request.get("allow_spillback") and not p.request.get("pg_id") \
                        and not p.request.get("hard_node_constraint"):
                    # feasible here but saturated: another node that has
                    # room NOW takes it (a card freed there after this
                    # request queued). The JAX package re-checks only
                    # infeasible requests, so this one waited out its
                    # whole lease timeout (50 s for an actor's).
                    target = self._pick_spillback(
                        p.request["resources"], require_available=True)
                    if target is not None and not p.future.done():
                        try:
                            p.future.set_result(
                                {"granted": False, "spillback": target})
                        except asyncio.InvalidStateError:
                            pass
                        continue
                still.append(p)
                continue
            # the future may have been cancelled (requester timeout) while
            # _try_grant awaited worker startup — undo, don't leak the lease
            if p.future.done():
                self._undo_grant(grant)
                continue
            try:
                p.future.set_result(grant)
            except asyncio.InvalidStateError:
                self._undo_grant(grant)
        self.pending = [p for p in still if not p.future.done()]

    # ------------------------------------------------------------------
    # Placement group bundles (reference: placement_group_resource_manager.h
    # 2PC prepare/commit/cancel/release)
    # ------------------------------------------------------------------
    async def PrepareBundle(self, pg_id: str, bundle_index: int, resources: Dict[str, float]) -> dict:
        alloc = self.resources.allocate(resources)
        if alloc is None:
            return {"ok": False, "error": "insufficient resources"}
        self.prepared_bundles[(pg_id, bundle_index)] = alloc
        return {"ok": True}

    async def CommitBundle(self, pg_id: str, bundle_index: int) -> dict:
        alloc = self.prepared_bundles.pop((pg_id, bundle_index), None)
        if alloc is None:
            return {"ok": False}
        total = dict(alloc["resources"])
        rs = ResourceSet(total)
        # bundle inherits concrete card ids reserved from the node
        rs.free_gpu_ids = list(alloc.get("gpu_ids", []))
        self.committed_bundles[(pg_id, bundle_index)] = rs
        return {"ok": True}

    async def CancelBundle(self, pg_id: str, bundle_index: int) -> dict:
        alloc = self.prepared_bundles.pop((pg_id, bundle_index), None)
        if alloc is not None:
            self.resources.release(alloc)
        return {"ok": True}

    async def ReleaseBundle(self, pg_id: str, bundle_index: int) -> dict:
        rs = self.committed_bundles.pop((pg_id, bundle_index), None)
        if rs is not None:
            # only what no lease holds goes back now: a lease still alive
            # in the bundle returns its share (its cards too) to the node
            # when it ends (_rs_for_lease falls back to the node's set).
            # Giving back the bundle's whole reservation here would hand a
            # leased card out twice (the JAX package's raylet does).
            self.resources.release({
                "resources": {k: v for k, v in rs.available.items() if v > 0},
                "gpu_ids": list(rs.free_gpu_ids)})
        self._kick_drain()
        return {"ok": True}

    # ------------------------------------------------------------------
    # Graceful drain (reference: NodeManager::HandleDrainRaylet +
    # local_object_manager eviction-before-death; _private/drain.py has
    # the cluster-wide lifecycle)
    # ------------------------------------------------------------------
    async def Drain(self, reason: str = "",
                    deadline_s: Optional[float] = None) -> dict:
        if self.draining:
            return {"ok": True, "already": True}
        if deadline_s is None:
            deadline_s = config.drain_deadline_default_s
        self.draining = True
        self.drain_reason = reason
        self.drain_deadline = time.monotonic() + max(0.0, deadline_s)
        logger.info("draining (%s, deadline %.1fs): %d lease(s) in "
                    "flight, %d pending", reason, deadline_s,
                    len(self.leases), len(self.pending))
        # queued lease requests will never be granted here: answer them
        # NOW with a redirect so their callers re-lease elsewhere instead
        # of burning their full wait timeout against a dying node
        pending, self.pending = self.pending, []
        for p in pending:
            if p.future.done():
                continue
            try:
                p.future.set_result(self._draining_reply(
                    p.request.get("resources") or {},
                    pg_id=p.request.get("pg_id"),
                    hard_node_constraint=p.request.get(
                        "hard_node_constraint", "")))
            except asyncio.InvalidStateError:
                pass
        self._drain_task = asyncio.ensure_future(
            self._drain_task_run())
        return {"ok": True}

    def _draining_reply(self, resources: Dict[str, float],
                        pg_id: Optional[str] = None,
                        hard_node_constraint: str = "") -> dict:
        """Lease rejection for a draining node: carries a spillback
        target when one exists so the caller's existing redirect path
        re-leases elsewhere in one hop. PG-bundle and hard-constrained
        requests (pinned NodeAffinity AND hard NodeLabel) are NEVER
        redirected — the spillback picker filters on resources only, so
        a redirect could land them on a node violating the constraint;
        the normal path never spills them either. Their callers
        retry/fail through the placement machinery instead."""
        reply = {"granted": False, "draining": True,
                 "error": "node is draining"}
        if not pg_id and not hard_node_constraint:
            target = self._pick_spillback(resources,
                                          require_available=False)
            if target is not None:
                reply["spillback"] = target
        return reply

    async def _drain_task_run(self) -> None:
        from ray_tpu_torch._private import drain as drain_mod

        # 0) recall warm leases: tell every worker to refuse further
        # task pushes (node_draining reply) — the callers holding
        # keepalive-cached leases return them and re-lease elsewhere,
        # so a sustained task stream doesn't pin its lease here for the
        # whole deadline (and then die mid-task at the kill)
        async def _notify(w: WorkerHandle) -> None:
            if w.addr is None or w.dead:
                return
            c = RpcClient(w.addr[0], w.addr[1], self._loop_handle())
            try:
                await c.acall("NotifyNodeDraining", timeout=5)
            except Exception:  # noqa: BLE001 — worker already gone
                pass
            finally:
                c.close()

        await asyncio.gather(
            *(_notify(w) for w in list(self.workers.values())),
            return_exceptions=True)
        # 1) let in-flight TASK leases run out (actor leases are
        # migrated by the GCS in parallel — their workers are torn down
        # at exit below). Idle warm leases held by callers come back via
        # their keepalive sweepers within worker_lease_keepalive_s.
        while time.monotonic() < self.drain_deadline:
            task_leases = [l for l in self.leases.values()
                           if not l.for_actor]
            if not task_leases:
                break
            await asyncio.sleep(0.05)
        # 2) push primary object copies to a surviving node so borrowed
        # refs outlive this node (skipped on whole-cluster shutdown —
        # there is nobody left to read them)
        moved: Dict[bytes, str] = {}
        if self.drain_reason != drain_mod.REASON_CLUSTER_SHUTDOWN:
            target = self._pick_drain_target()
            if target is not None:
                loop = asyncio.get_event_loop()
                try:
                    moved = await loop.run_in_executor(
                        None, self._push_objects_sync, target)
                except Exception:  # noqa: BLE001
                    logger.exception("drain object push failed")
        # 3) confirm to the GCS (it finishes actor migration before
        # replying, so worker teardown below cannot race a DrainActor),
        # then deregister by exiting cleanly
        deadline = time.monotonic() + 45.0
        while time.monotonic() < deadline:
            try:
                await self.gcs.acall(
                    "NodeDrainComplete", node_id=self.node_id,
                    moved_objects=moved, timeout=40)
                break
            except Exception as e:  # noqa: BLE001 — GCS restarting;
                # its heartbeat-relearned DRAINING state + watchdog
                # cover a confirmation that never lands
                logger.warning("NodeDrainComplete failed: %s", e)
                await asyncio.sleep(1.0)
        logger.info("drain complete; raylet exiting")
        self.shutdown_procs()
        # give the log line and any in-flight response frames a beat
        asyncio.get_event_loop().call_later(0.2, os._exit, 0)

    def _pick_drain_target(self) -> Optional[Tuple[str, int]]:
        """A surviving (alive, not draining) node's raylet address."""
        best = None
        for nid, info in self.cluster_view.items():
            if nid == self.node_id or not info.get("alive") \
                    or info.get("draining"):
                continue
            mem = info.get("available", {}).get("memory", 0.0)
            if best is None or mem > best[0]:
                best = (mem, tuple(info["addr"]), nid)
        if best is None:
            return None
        self._drain_target_node_id = best[2]
        return best[1]

    def _push_objects_sync(self, target: Tuple[str, int]) -> Dict[bytes, str]:
        """Push every sealed primary copy (in-memory and spilled) to the
        target raylet's store, chunked. Runs on an executor thread;
        returns oid_bin -> destination node id for the GCS directory."""
        from ray_tpu_torch._private.ids import ObjectID
        from ray_tpu_torch._private.rpc import get_client

        client = get_client(target)
        target_nid = getattr(self, "_drain_target_node_id", "")
        chunk = config.object_pull_chunk_bytes
        moved: Dict[bytes, str] = {}

        def _send(oid_bin: bytes, total: int, read) -> bool:
            off = 0
            while off < total or off == 0:
                data = read(off, min(chunk, total - off))
                if data is None:
                    return False
                rep = client.call(
                    "ReceiveObjectChunk", object_id_bin=oid_bin,
                    offset=off, total=total, data=data, timeout=60)
                if rep.get("status") == "exists":
                    return True  # already there (e.g. a reader pulled it)
                if rep.get("status") != "ok":
                    return False
                off += max(1, len(data))
                if total == 0:
                    break
            return True

        try:
            candidates = self.store.list_objects()
        except Exception:  # noqa: BLE001
            candidates = []
        for oid_bin, size, sealed, _pinned in candidates:
            if not sealed:
                continue
            oid = ObjectID(oid_bin)
            [view] = self.store.get([oid], timeout_ms=0)
            if view is None:
                continue
            try:
                if _send(bytes(oid_bin), len(view),
                         lambda o, n, v=view: bytes(v[o:o + n])):
                    moved[bytes(oid_bin)] = target_nid
            except Exception:  # noqa: BLE001 — best effort per object
                pass
            finally:
                try:
                    self.store.release(oid)
                except Exception:  # noqa: BLE001
                    pass
        with self._spill_lock:
            spilled = dict(self.spilled)
        for oid_bin, (path, size) in spilled.items():
            def _read_file(off, n, path=path):
                try:
                    with open(path, "rb") as f:
                        f.seek(off)
                        return f.read(n)
                except OSError:
                    return None
            try:
                if _send(bytes(oid_bin), size, _read_file):
                    moved[bytes(oid_bin)] = target_nid
            except Exception:  # noqa: BLE001
                pass
        if moved:
            logger.info("drain pushed %d primary object(s) to %s",
                        len(moved), target_nid[:12])
        return moved

    async def ReceiveObjectChunk(self, object_id_bin: bytes, offset: int,
                                 total: int, data: bytes) -> dict:
        """Destination side of the drain push: write the chunk into this
        node's store (Create at offset 0, Seal on the last chunk)."""
        from ray_tpu_torch._private.ids import ObjectID

        oid_bin = bytes(object_id_bin)
        oid = ObjectID(oid_bin)
        loop = asyncio.get_event_loop()

        def _write() -> str:
            ent = self._incoming_objects.get(oid_bin)
            if ent is None:
                if offset != 0:
                    return "bad_offset"
                try:
                    if self.store.contains(oid):
                        return "exists"
                    buf = self.store.create(oid, total)
                except FileExistsError:
                    return "exists"
                except Exception:  # noqa: BLE001 — store full
                    self._spill_until(total)
                    try:
                        buf = self.store.create(oid, total)
                    except Exception:  # noqa: BLE001
                        return "full"
                ent = self._incoming_objects[oid_bin] = {
                    "buf": buf, "last_used": time.monotonic()}
            buf = ent["buf"]
            ent["last_used"] = time.monotonic()
            if data:
                buf.data[offset:offset + len(data)] = data
            if offset + len(data) >= total:
                buf.seal()
                del self._incoming_objects[oid_bin]
            return "ok"

        status = await loop.run_in_executor(None, _write)
        return {"status": status}

    # ------------------------------------------------------------------
    # Object manager: serve chunked pulls from this node's store to other
    # nodes (reference: src/ray/object_manager/object_manager.cc:221 Pull,
    # :587 HandlePush — ours is pull-based: the reader drives the transfer)
    # ------------------------------------------------------------------
    async def PullObjectChunk(
        self, object_id_bin: bytes, offset: int = 0, length: int = 0
    ) -> dict:
        from ray_tpu_torch._private.ids import ObjectID

        if self.store is None:
            return {"status": "not_found"}
        oid = ObjectID(object_id_bin)
        loop = asyncio.get_event_loop()

        def _read():
            # pin across the whole multi-chunk transfer: a get-pin is taken
            # when the first reader starts and held in _pull_pins until the
            # LAST concurrent reader finishes (or the idle sweeper fires) —
            # otherwise the store could LRU-evict the object mid-transfer
            with self._pull_pins_lock:
                pinned = self._pull_pins.get(oid)
                if pinned is not None:
                    if offset == 0:
                        pinned["readers"] += 1
                    pinned["last_used"] = time.monotonic()
            if pinned is None:
                [view] = self.store.get([oid], timeout_ms=100)
                if view is None:
                    return None
                extra_pin = False
                with self._pull_pins_lock:
                    existing = self._pull_pins.get(oid)
                    if existing is None:
                        pinned = self._pull_pins[oid] = {
                            "view": view, "last_used": time.monotonic(), "readers": 1,
                        }
                    else:  # lost the creation race: drop our extra store pin
                        pinned = existing
                        if offset == 0:
                            pinned["readers"] += 1
                        extra_pin = True
                if extra_pin:
                    try:
                        self.store.release(oid)
                    except Exception:  # noqa: BLE001
                        pass
            view = pinned["view"]
            total = len(view)
            end = min(total, offset + (length or total))
            data = bytes(view[offset:end])
            if end >= total:
                done = False
                with self._pull_pins_lock:
                    pinned["readers"] -= 1
                    if pinned["readers"] <= 0 and self._pull_pins.get(oid) is pinned:
                        del self._pull_pins[oid]
                        done = True
                if done:
                    try:
                        self.store.release(oid)
                    except Exception:  # noqa: BLE001
                        pass
            return total, data

        res = await loop.run_in_executor(None, _read)
        if res is None:
            # spilled objects are served straight from their file — no
            # need to re-pressure shared memory for an outbound transfer
            res = await loop.run_in_executor(
                None, self._read_spilled_chunk, bytes(object_id_bin), offset, length
            )
        if res is None:
            return {"status": "not_found"}
        total, data = res
        return {"status": "ok", "total": total, "data": data}

    async def ContainsObject(self, object_id_bin: bytes) -> dict:
        """Cheap liveness probe for an object in this node's store (used by
        owners verifying a loss report before reconstructing). Spilled
        objects count: they are on this node, just on disk."""
        from ray_tpu_torch._private.ids import ObjectID

        if self.store is None:
            return {"contains": False}
        with self._spill_lock:
            if object_id_bin in self.spilled:
                return {"contains": True}
        oid = ObjectID(object_id_bin)
        loop = asyncio.get_event_loop()
        found = await loop.run_in_executor(None, lambda: self.store.contains(oid))
        return {"contains": bool(found)}

    # ------------------------------------------------------------------
    # Spilling (reference: src/ray/raylet/local_object_manager.h:145
    # SpillObjectsOfSize / :157 AsyncRestoreSpilledObject)
    # ------------------------------------------------------------------
    def _spill_path(self, oid_bin: bytes) -> str:
        return os.path.join(self.spill_dir, oid_bin.hex())

    def _spill_until(self, needed_bytes: int) -> int:
        """Move LRU sealed+unpinned objects to disk until ~needed_bytes are
        freed. Runs on an executor thread; batches serialize on
        _spill_work_lock (never held on the event loop)."""
        from ray_tpu_torch._private.ids import ObjectID
        from ray_tpu_torch._private.object_store.client import ST_OK

        freed = 0
        with self._spill_work_lock:
            try:
                candidates = self.store.list_objects()
            except Exception:  # noqa: BLE001
                return 0
            with self._pull_pins_lock:
                transferring = set(self._pull_pins)
            now = time.monotonic()
            self._restore_grace = {
                k: t for k, t in self._restore_grace.items() if now - t < 10.0
            }
            # a restored object is left alone while its reader comes to pin
            # it; when that leaves too little room, those restored more than
            # RESTORE_GRACE_MIN_S ago go too (their reader has pinned and
            # released them, or restores again: the JAX package waits out
            # the whole 10 s, which stalls a reader of many spilled objects)
            young = {k for k, t in self._restore_grace.items()
                     if now - t < RESTORE_GRACE_MIN_S}
            unpinned = [c for c in candidates if c[2] and not c[3]]
            ordered = ([c for c in unpinned if c[0] not in self._restore_grace]
                       + [c for c in unpinned
                          if c[0] in self._restore_grace and c[0] not in young])
            for oid_bin, size, sealed, pinned in ordered:
                if freed >= needed_bytes:
                    break
                oid = ObjectID(oid_bin)
                if oid in transferring:
                    continue
                [view] = self.store.get([oid], timeout_ms=0)
                if view is None:
                    continue
                path = self._spill_path(oid_bin)
                try:
                    with open(path, "wb") as f:
                        f.write(view)
                finally:
                    self.store.release(oid)
                status = self.store.delete(oid)
                with self._spill_lock:
                    self.spilled[oid_bin] = (path, size)
                self._spilled_bytes_total += size
                if status == ST_OK:
                    # a pinned-between-list-and-delete object has
                    # pending_delete set and frees memory on last release;
                    # don't count bytes that aren't actually free yet
                    freed += size
            if freed:
                logger.info("spilled %d bytes to %s", freed, self.spill_dir)
        return freed

    async def SpillObjects(self, needed_bytes: int) -> dict:
        """Create backpressure: a client whose create got FULL asks us to
        make room (reference: plasma/create_request_queue.h — ours is
        client-driven retry over raylet-driven spill)."""
        loop = asyncio.get_event_loop()
        freed = await loop.run_in_executor(None, self._spill_until, int(needed_bytes))
        return {"freed": freed}

    def _restore_sync(self, oid_bin: bytes) -> str:
        """Bring a spilled object back into shared memory. Returns
        "ok" | "absent" | "full"."""
        from ray_tpu_torch._private.ids import ObjectID

        oid = ObjectID(oid_bin)
        with self._spill_work_lock:
            with self._spill_lock:
                ent = self.spilled.get(oid_bin)
            if ent is None:
                return "absent"
            path, size = ent
            for attempt in range(2):
                try:
                    with open(path, "rb") as f:
                        data = f.read()
                except FileNotFoundError:
                    return "absent"
                try:
                    buf = self.store.create(oid, len(data))
                except FileExistsError:
                    break  # concurrent restore won
                except Exception:  # noqa: BLE001 — FULL: spill others, retry
                    if attempt == 0:
                        self._spill_until(len(data))
                        continue
                    return "full"
                buf.data[:] = data
                buf.seal()
                break
            with self._spill_lock:
                still = self.spilled.pop(oid_bin, None)
            if still is None:
                # the owner freed the object mid-restore: don't resurrect
                # an orphan in a store that never evicts
                self.store.delete(oid)
                return "absent"
            self._restored_bytes_total += size
            self._restore_grace[oid_bin] = time.monotonic()
            try:
                os.unlink(path)
            except OSError:
                pass
            return "ok"

    async def RestoreObject(self, object_id_bin: bytes) -> dict:
        loop = asyncio.get_event_loop()
        status = await loop.run_in_executor(None, self._restore_sync, bytes(object_id_bin))
        return {"status": status}

    def _read_spilled_chunk(self, oid_bin: bytes, offset: int, length: int):
        with self._spill_lock:
            ent = self.spilled.get(oid_bin)
        if ent is None:
            return None
        path, size = ent
        try:
            with open(path, "rb") as f:
                f.seek(offset)
                data = f.read(length or size)
        except OSError:
            return None
        return size, data

    async def _pull_pin_sweeper_loop(self) -> None:
        """Release transfer pins whose readers died mid-pull, and abort
        inbound drain-pushed buffers whose sender died mid-transfer (a
        hard-killed draining node must not leak an unsealed allocation
        on the survivor forever)."""
        while True:
            await asyncio.sleep(10)
            cutoff = time.monotonic() - 60
            stale = []
            with self._pull_pins_lock:
                for oid, pinned in list(self._pull_pins.items()):
                    if pinned["last_used"] < cutoff:
                        del self._pull_pins[oid]
                        stale.append(oid)
            for oid in stale:
                try:
                    self.store.release(oid)
                except Exception:  # noqa: BLE001
                    pass
            for oid_bin, ent in list(self._incoming_objects.items()):
                if ent["last_used"] < cutoff:
                    self._incoming_objects.pop(oid_bin, None)
                    try:
                        ent["buf"].abort()
                    except Exception:  # noqa: BLE001
                        pass

    async def DeleteObject(self, object_id_bin: bytes) -> dict:
        from ray_tpu_torch._private.ids import ObjectID

        if self.store is not None:
            try:
                self.store.delete(ObjectID(object_id_bin))
            except Exception:  # noqa: BLE001
                pass
        with self._spill_lock:
            ent = self.spilled.pop(bytes(object_id_bin), None)
        if ent is not None:
            try:
                os.unlink(ent[0])
            except OSError:
                pass
        return {"ok": True}

    # ------------------------------------------------------------------
    async def GetState(self) -> dict:
        with self._spill_lock:
            n_spilled = len(self.spilled)
        return {
            "node_id": self.node_id,
            "total": self.resources.total,
            "available": self.resources.available,
            "num_workers": len(self.workers),
            "num_idle": len(self.idle_workers),
            "num_leases": len(self.leases),
            "pending_leases": len(self.pending),
            "bundles": list(self.committed_bundles.keys()),
            "spilled_objects": n_spilled,
            "spilled_bytes_total": self._spilled_bytes_total,
            "restored_bytes_total": self._restored_bytes_total,
            "num_oom_kills": self.num_oom_kills,
            "draining": self.draining,
            "drain_reason": self.drain_reason,
        }

    async def Ping(self) -> str:
        return "pong"

    # ------------------------------------------------------------------
    async def _heartbeat_loop(self) -> None:
        period = config.raylet_heartbeat_period_ms / 1000.0
        while True:
            try:
                # pending lease shapes feed the autoscaler's bin-packing
                # (reference: GcsAutoscalerStateManager demand aggregation)
                shapes = [dict(p.request.get("resources") or {})
                          for p in self.pending[:100]]
                reply = await self.gcs.acall(
                    "Heartbeat",
                    node_id=self.node_id,
                    available_resources=self.resources.available,
                    pending_shapes=shapes,
                    num_leases=len(self.leases),
                    draining=self.draining,
                    drain_remaining_s=max(
                        0.0, self.drain_deadline - time.monotonic())
                    if self.draining else 0.0,
                    drain_reason=self.drain_reason,
                    timeout=10,
                )
                if reply.get("reregister"):
                    await self._register()
                view = reply.get("cluster")
                if view:
                    self.cluster_view = view
                if "autoscaling" in reply:
                    # absent on reregister replies — don't flip to False
                    self.autoscaling_enabled = bool(reply["autoscaling"])
                drain = reply.get("drain")
                if drain is not None and not self.draining:
                    # the GCS-side Drain RPC never reached us (lost, or
                    # we restarted): the heartbeat reply re-issues it
                    await self.Drain(reason=drain.get("reason", ""),
                                     deadline_s=drain.get("deadline_s"))
            except Exception as e:  # noqa: BLE001
                logger.warning("heartbeat failed: %s", e)
            await asyncio.sleep(period)

    async def _reap_loop(self) -> None:
        """Detect dead worker processes; free leases; tell GCS (for actor
        fail-over) — reference: raylet owns worker procs and reports deaths.

        The sweep is O(workers) of pidfd polls held on the loop; its
        period scales with the pool so a 2,000-worker node spends the
        same loop share on reaping as a 10-worker one (death-notice
        latency degrades gracefully instead of the event loop)."""
        while True:
            await asyncio.sleep(min(4.0, 0.5 + 0.002 * len(self.workers)))
            for w in list(self.workers.values()):
                if w.proc.poll() is not None and not w.dead:
                    logger.warning("worker %s exited with %s", w.worker_id[:8], w.proc.returncode)
                    lease = self.leases.get(w.busy_lease) if w.busy_lease else None
                    addr = w.addr
                    if lease is not None:
                        self._release_lease(lease, worker_dead=True)
                    else:
                        w.dead = True
                        self.workers.pop(w.worker_id, None)
                        try:
                            self.idle_workers.remove(w)
                        except ValueError:
                            pass
                    if addr is not None:
                        # queued, not fire-and-forget: a death during GCS
                        # downtime must still be delivered after the GCS
                        # restarts, or replayed ALIVE actors point at dead
                        # workers forever
                        self._pending_death_notices.append({
                            "node_id": self.node_id,
                            "worker_id": w.worker_id,
                            "worker_addr": addr,
                        })
            if self._pending_death_notices and not self._death_flush_running:
                # background task with a short timeout: a hung GCS must
                # not stall the reap loop's death detection
                asyncio.ensure_future(self._flush_death_notices())
            await self._replenish_workers()
            self._kick_drain()

    async def _replenish_workers(self) -> None:
        """Respawn idle workers toward the recent lease-demand peak after
        churn. Bounded by the creation-gate budget, and the peak decays
        30s after the last grant, so a finished burst's spares idle out
        through the normal reaper instead of flapping."""
        now = time.monotonic()
        if self.draining:
            return
        if now - self._recent_lease_ts > 30.0:
            self._recent_lease_peak = 0
            return
        target = (min(self._recent_lease_peak,
                      config.actor_creation_concurrency)
                  - len(self.leases))
        if target > 0:
            await self.PrestartWorkers(count=target)

    async def _flush_death_notices(self) -> None:
        self._death_flush_running = True
        try:
            while self._pending_death_notices:
                notice = self._pending_death_notices[0]
                try:
                    await self.gcs.acall(
                        "NotifyWorkerDeath", timeout=3, **notice)
                except Exception:  # noqa: BLE001
                    return  # GCS unreachable — retried next reap tick
                self._pending_death_notices.pop(0)
        finally:
            self._death_flush_running = False

    async def _log_tail_loop(self) -> None:
        """Tail this node's worker log files and push appended lines to the
        GCS log buffer (reference: _private/log_monitor.py), where the
        driver's log-to-driver thread picks them up."""
        offsets: Dict[str, int] = {}
        loop = asyncio.get_event_loop()
        while True:
            await asyncio.sleep(1.0)

            def _collect():
                batches = []
                try:
                    names = os.listdir(self.session_dir)
                except OSError:
                    return batches
                for fname in names:
                    if not (fname.startswith("worker-") and fname.endswith(".log")):
                        continue
                    path = os.path.join(self.session_dir, fname)
                    try:
                        size = os.path.getsize(path)
                        off = offsets.get(fname, 0)
                        if size <= off:
                            continue
                        with open(path, "rb") as f:
                            f.seek(off)
                            data = f.read(64 * 1024)
                        # only consume complete lines: a partial trailing
                        # line (mid-write, or chunk-cap split) stays for
                        # the next cycle — but a single line LONGER than
                        # the chunk must be consumed anyway or the tailer
                        # wedges on it forever
                        cut = data.rfind(b"\n")
                        if cut < 0:
                            if len(data) < 64 * 1024:
                                continue  # partial line, retry next cycle
                        else:
                            data = data[: cut + 1]
                        offsets[fname] = off + len(data)
                        lines = data.decode(errors="replace").splitlines()
                        if lines:
                            batches.append((fname[len("worker-"):-len(".log")], lines))
                    except OSError:
                        continue
                return batches

            batches = await loop.run_in_executor(None, _collect)
            for worker_id, lines in batches:
                try:
                    await self.gcs.acall(
                        "PublishLogs", node_id=self.node_id,
                        worker_id=worker_id, lines=lines, timeout=10,
                    )
                except Exception:  # noqa: BLE001
                    pass

    # -- OOM worker killing (reference: raylet memory monitor +
    # worker_killing_policy_group_by_owner.h: under host-memory
    # pressure, kill a worker from the owner-group with the MOST
    # workers — the fan-out most likely responsible — youngest first,
    # so the least progress is lost and its retriable task resubmits) --
    def _memory_pct(self) -> float:
        path = config.testing_memory_pct_file
        if path:
            try:
                with open(path) as f:
                    return float(f.read().strip())
            except (OSError, ValueError):
                return 0.0
        return _memory_used_pct()

    def _pick_oom_victim(self) -> Optional["Lease"]:
        groups: Dict[Tuple, List[Lease]] = {}
        for lease in self.leases.values():
            if lease.worker.dead:
                continue
            # group by owner: the job, with each actor its own group
            # (reference groups by the task owner's id)
            key = (lease.job_id, lease.for_actor or "")
            groups.setdefault(key, []).append(lease)
        if not groups:
            return None
        biggest = max(groups.values(), key=len)
        return max(biggest, key=lambda le: le.granted_at)  # youngest

    async def _memory_monitor_loop(self) -> None:
        while True:
            await asyncio.sleep(config.memory_monitor_period_s)
            if config.memory_usage_threshold >= 1.0:
                continue  # disabled
            pct = self._memory_pct()
            if pct < config.memory_usage_threshold * 100.0:
                continue
            victim = self._pick_oom_victim()
            if victim is None:
                continue
            logger.warning(
                "memory pressure %.0f%% >= %.0f%%: killing worker %s "
                "(job %s, group-by-owner policy)", pct,
                config.memory_usage_threshold * 100.0,
                victim.worker.worker_id[:8], victim.job_id[:8])
            victim.worker.dead = True
            try:
                victim.worker.proc.kill()
            except Exception:  # noqa: BLE001
                pass
            self.num_oom_kills += 1
            # the reap loop + caller-side worker-failure handling do the
            # rest: lease released, task retried elsewhere

    async def _idle_reaper_loop(self) -> None:
        while True:
            await asyncio.sleep(5)
            cutoff = time.monotonic() - config.worker_idle_timeout_s
            keep: List[WorkerHandle] = []
            for w in self.idle_workers:
                if w.idle_since < cutoff and len(self.workers) > 1:
                    w.dead = True
                    self.workers.pop(w.worker_id, None)
                    try:
                        w.proc.terminate()
                    except Exception:
                        pass
                else:
                    keep.append(w)
            self.idle_workers = keep

    async def DebugDump(self, reason: str = "requested",
                        info: Optional[dict] = None) -> dict:
        """Flight-recorder shard on request (GCS fan-out / operators)."""
        path = obs_dump.dump_now(reason, extra=info)
        return {"ok": path is not None, "path": path}

    async def _register(self) -> None:
        await self.gcs.acall(
            "RegisterNode",
            node_id=self.node_id,
            address=(self.server.host, self.server.port),
            store_socket=self.store_socket,
            total_resources=self.resources.total,
            is_head=self.is_head,
            labels=self.labels,
            agent_port=getattr(self, "agent_port", 0),
            timeout=30,
        )

    def _loop_handle(self) -> LoopHandle:
        h = getattr(self, "_loop_handle_cached", None)
        if h is None:
            h = self._loop_handle_cached = LoopHandle(
                asyncio.get_event_loop())
        return h

    async def run(self) -> None:
        # start the native object store daemon for this node (no-evict:
        # the spill path below preserves data instead of LRU-dropping it)
        from ray_tpu_torch._private.object_store.client import StoreClient, start_store_process

        os.makedirs(self.spill_dir, exist_ok=True)
        self.store_proc = start_store_process(
            self.store_socket, self.store_capacity, no_evict=True
        )
        self.store = StoreClient(self.store_socket)
        # gcs client rides this raylet's OWN event loop (LoopHandle): no
        # cross-thread handoff per heartbeat/lease-path RPC
        self.gcs = RpcClient(self.gcs_addr[0], self.gcs_addr[1],
                             self._loop_handle())
        # daemon-process observability wiring: no global_worker here, so
        # the event flusher and dump path get their identity/transport
        # explicitly
        obs_events.set_process_ident(f"raylet-{self.node_id[:8]}")
        obs_events.set_gcs_client(self.gcs)
        obs_dump.set_run_tag(f"{self.gcs_addr[0]}:{self.gcs_addr[1]}")
        obs_dump.install("raylet")

        server_task = asyncio.ensure_future(self.server.serve_forever())
        # wait until the port is bound
        while self.server.port == 0:
            await asyncio.sleep(0.01)
        # per-node observability agent, colocated on this event loop
        # (reference: dashboard/agent.py:35 — one agent per node)
        try:
            from ray_tpu_torch.dashboard.agent import NodeAgent

            self.agent = NodeAgent(self, host=self.server.host)
            _, self.agent_port = await self.agent.start()
        except Exception:  # noqa: BLE001 — observability must not block boot
            logger.exception("node agent failed to start")
            self.agent_port = 0
        await self._register()
        asyncio.ensure_future(self._heartbeat_loop())
        asyncio.ensure_future(self._reap_loop())
        asyncio.ensure_future(self._idle_reaper_loop())
        asyncio.ensure_future(self._memory_monitor_loop())
        asyncio.ensure_future(self._drain_loop())
        asyncio.ensure_future(self._pull_pin_sweeper_loop())
        if config.log_to_driver:
            asyncio.ensure_future(self._log_tail_loop())
        if config.worker_pool_prestart_workers:
            for _ in range(int(self.resources.total.get("CPU", 1))):
                self._spawn_worker()
        try:
            await server_task
        finally:
            self.shutdown_procs()

    def shutdown_procs(self) -> None:
        for w in self.workers.values():
            try:
                w.proc.terminate()
            except Exception:
                pass
        if self._zygote is not None:
            self._zygote.stop()
        if self.store_proc is not None:
            try:
                self.store_proc.terminate()
            except Exception:
                pass


def _memory_used_pct() -> float:
    """psutil's virtual_memory().percent from /proc/meminfo: the share
    of MemTotal that is not MemAvailable."""
    info = {}
    with open("/proc/meminfo") as f:
        for line in f:
            k, v = line.split(":", 1)
            info[k] = int(v.split()[0])
    return 100.0 * (info["MemTotal"] - info["MemAvailable"]) / info["MemTotal"]


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--node-id", required=True)
    parser.add_argument("--gcs-addr", required=True)  # host:port
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--resources-json", required=True)
    parser.add_argument("--store-socket", required=True)
    parser.add_argument("--store-capacity", type=int, required=True)
    parser.add_argument("--is-head", action="store_true")
    parser.add_argument("--session-dir", default="")
    parser.add_argument("--port-file", default="")
    parser.add_argument("--log-level", default="INFO")
    parser.add_argument("--labels-json", default="")
    parser.add_argument("--gpu-ids-json", default="")
    args = parser.parse_args()
    logging.basicConfig(level=args.log_level, format="[raylet] %(levelname)s %(message)s")

    # -- diagnostics: record how this process exits ---------------------
    import faulthandler
    import signal as _signal

    faulthandler.enable()

    def _sig_logger(signum, frame):
        logger.info("raylet received signal %s; exiting", signum)
        try:
            raylet.shutdown_procs()
        except NameError:
            pass
        os._exit(128 + signum)

    _signal.signal(_signal.SIGTERM, _sig_logger)

    import json

    host, port_s = args.gcs_addr.rsplit(":", 1)
    raylet = Raylet(
        node_id=args.node_id,
        gcs_addr=(host, int(port_s)),
        resources=json.loads(args.resources_json),
        store_socket=args.store_socket,
        store_capacity=args.store_capacity,
        port=args.port,
        is_head=args.is_head,
        session_dir=args.session_dir,
        labels=json.loads(args.labels_json) if args.labels_json else None,
        gpu_ids=json.loads(args.gpu_ids_json) if args.gpu_ids_json else None,
    )

    async def _run():
        task = asyncio.ensure_future(raylet.run())
        while raylet.server.port == 0:
            await asyncio.sleep(0.01)
        if args.port_file:
            tmp = args.port_file + ".tmp"
            with open(tmp, "w") as f:
                f.write(str(raylet.server.port))
            os.replace(tmp, args.port_file)
        await task

    try:
        asyncio.run(_run())
    except KeyboardInterrupt:
        pass
    finally:
        raylet.shutdown_procs()


if __name__ == "__main__":
    main()
