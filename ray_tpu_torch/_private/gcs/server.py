"""GCS — the head-node control plane process (copy of
ray_tpu/_private/gcs/server.py).

Reference: src/ray/gcs/gcs_server.h:99 (GcsServer composes node/actor/job/
PG/KV managers), gcs_node_manager.cc:102 (register), gcs_actor_manager.cc:314
(register actor) / :433 (create) / :1721 (SchedulePendingActors),
gcs_health_check_manager.h:46 (liveness), gcs_kv_manager.h (KV).

One asyncio process: tables in memory, optional file persistence for the KV
table, periodic health checks that mark silent raylets dead, actor
scheduling via raylet lease RPCs, and placement-group 2PC (PREPARE/COMMIT
like node_manager.proto:514-519).
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import pickle
import struct
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private.config import config
from ray_tpu_torch._private.rpc import RpcClient, RpcServer
from ray_tpu_torch.observability import timeline as obs_timeline

logger = logging.getLogger("ray_tpu_torch.gcs")


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------
@dataclass
class NodeInfo:
    node_id: str
    address: Tuple[str, int]  # raylet RPC addr
    store_socket: str
    total_resources: Dict[str, float]
    available_resources: Dict[str, float]
    alive: bool = True
    last_heartbeat: float = field(default_factory=time.monotonic)
    is_head: bool = False
    # graceful drain (reference: DrainNode + autoscaler.proto reasons):
    # a DRAINING node is still alive — in-flight work finishes — but
    # takes no new leases/placements and is published so schedulers
    # route around it before it dies
    draining: bool = False
    drain_reason: str = ""
    drain_deadline: float = 0.0  # monotonic; 0 = not draining
    drain_started_at: float = 0.0
    labels: Dict[str, str] = field(default_factory=dict)
    agent_port: int = 0  # per-node dashboard agent (dashboard/agent.py)
    # autoscaler signal (reference: GcsAutoscalerStateManager)
    pending_shapes: List[Dict[str, float]] = field(default_factory=list)
    num_leases: int = 0
    idle_since: Optional[float] = None


@dataclass
class ActorInfo:
    actor_id: str
    job_id: str
    name: Optional[str]
    namespace: str
    state: str  # PENDING, ALIVE, RESTARTING, DEAD
    serialized_spec: bytes  # creation task spec (class + args + opts)
    owner_addr: Optional[Tuple[str, int]]
    worker_addr: Optional[Tuple[str, int]] = None
    node_id: Optional[str] = None
    worker_id: Optional[str] = None
    max_restarts: int = 0
    num_restarts: int = 0
    resources: Dict[str, float] = field(default_factory=dict)
    detached: bool = False
    death_cause: str = ""
    version: int = 0  # bumped on every state change
    pg_id: Optional[str] = None
    bundle_index: int = -1
    # num_cpus defaulted: CPU counts for scheduling creation only, not held
    # while alive (reference actor resource semantics)
    cpu_scheduling_only: bool = False
    # a lease request for this actor is queued at some raylet — its shape
    # already shows in that node's pending_shapes (autoscaler dedupe)
    lease_in_flight: bool = False
    # its lease was granted and CreateActor (the actor's __init__) runs: it
    # holds its node's resources already, so it is no demand either
    creating: bool = False
    # workers tainted by a runtime env are dedicated to it
    runtime_env_hash: str = ""
    # scheduling strategy (reference: node-affinity / node-label policies)
    scheduling_kind: str = "DEFAULT"
    affinity_node_id: Optional[str] = None
    strategy_soft: bool = False
    node_labels: Optional[Dict[str, str]] = None



@dataclass
class PlacementGroupInfo:
    pg_id: str
    name: str
    strategy: str  # PACK, SPREAD, STRICT_PACK, STRICT_SPREAD
    bundles: List[Dict[str, float]]
    state: str  # PENDING, CREATED, REMOVED
    # bundle index -> (node_id, lease)
    bundle_nodes: Dict[int, str] = field(default_factory=dict)
    creator_job: str = ""


class GcsServer:
    def __init__(self, port: int, storage_path: str = ""):
        self.server = RpcServer(port=port, name="gcs")
        self.storage_path = storage_path
        self.nodes: Dict[str, NodeInfo] = {}
        self.actors: Dict[str, ActorInfo] = {}
        self.named_actors: Dict[Tuple[str, str], str] = {}
        self.placement_groups: Dict[str, PlacementGroupInfo] = {}
        self.kv: Dict[str, Dict[str, bytes]] = {}  # namespace -> key -> value
        self.jobs: Dict[str, Dict[str, Any]] = {}
        self._job_counter = 0
        self._raylet_clients: Dict[str, RpcClient] = {}
        self._actor_events: Dict[str, asyncio.Event] = {}
        self._node_version = 0
        # observability (bounded): pushed metrics, task events, log lines
        from collections import deque

        self.metrics_by_producer: Dict[str, Tuple[List[dict], float]] = {}
        self.task_events: Any = deque(maxlen=20000)
        self.log_buffer: Any = deque(maxlen=50000)
        self._log_seq = 0
        self.metrics_http_port = 0
        # pubsub (reference: src/ray/pubsub/publisher.h:357 — long-poll
        # publisher with per-channel cursors): channel -> deque of
        # (seq, key, payload); subscribers long-poll past their cursor
        self.pubsub: Dict[str, Any] = {}
        self._pubsub_seq = 0
        self._pubsub_waiters: Any = None  # asyncio.Condition, lazy
        # channel -> seq of the NEWEST event the bounded ring evicted; a
        # subscriber whose cursor is below this floor has a gap it can
        # never replay and must resync (Subscribe returns the floor)
        self.pubsub_dropped: Dict[str, int] = {}
        # event bus + trace aggregation (reference: GcsTaskManager-style
        # bounded history, see observability/aggregator.py)
        from ray_tpu_torch.observability.aggregator import EventAggregator

        self.cluster_events = EventAggregator()
        # the GCS's own bus events (lifecycle marks, drain/restart
        # events) ingest through a local sink — no RPC to itself — and
        # its shard/debug-dir identity is its own address
        from ray_tpu_torch.observability import dump as obs_dump
        from ray_tpu_torch.observability import events as obs_events

        obs_events.set_process_ident("gcs")
        obs_events.set_local_sink(self.cluster_events.add)
        obs_dump.set_run_tag(f"127.0.0.1-{port}")
        obs_dump.install("gcs")
        self._last_fanout_dump = 0.0
        # graceful drain bookkeeping: per-node orchestration tasks,
        # completion events, and the bounded directory of primary
        # copies pushed off drained nodes (oid_bin -> node_id)
        from collections import OrderedDict

        self._drain_migrations: Dict[str, Any] = {}
        self._drain_done_events: Dict[str, asyncio.Event] = {}
        self.moved_objects: Any = OrderedDict()
        # lease, not a latch: the autoscaler re-asserts every reconcile
        # round; if it dies, the flag expires and raylets fall back to
        # fail-fast infeasible errors instead of queueing forever
        self.autoscaler_enabled_until = 0.0
        self._dirty = False
        self._needs_replay_reschedule = False
        # per-NODE creation gates (asyncio.Semaphore, loop-affine): the
        # admission bound on in-flight lease+spawn+CreateActor pipelines
        # scales with the cluster instead of throttling a multi-node
        # burst to one node's budget
        self._actor_create_gates: Dict[str, Any] = {}
        self._last_prestart = 0.0
        self._wal = None  # lazily-opened append handle
        self._wal_records = 0
        self._wal_degraded = False  # an append failed since last compact
        self._wal_seq = 0  # records appended this process lifetime
        self._wal_synced = 0  # highest seq durable (group fsync/snapshot)
        self._wal_sync_lock: Optional[asyncio.Lock] = None  # loop-affine
        self._load_persisted()
        replayed, had_wal = self._replay_wal()
        if replayed:
            logger.info("replayed %d WAL records", self._wal_records)
            for a in self.actors.values():
                a.lease_in_flight = a.creating = False
            # a restart restored state (possibly WAL-only, before any
            # snapshot existed): pending work needs rescheduling
            self._needs_replay_reschedule = True
        if had_wal:
            # fold into a fresh snapshot + truncate — ALSO when zero
            # records replayed: a torn first record must not linger as
            # garbage that later appends would land after
            self._dirty = True
            self._compact()
        self.server.register_instance(self)
        # pubsub long-poll parks for its whole timeout by design — exempt
        # it from the transport's slow-async-handler warning
        self.server.register("Subscribe", self.Subscribe, long_poll=True)
        self.server.pre_response = self._wal_barrier

    # ------------------------------------------------------------------
    # persistence (file-backed snapshot of the durable tables: KV,
    # actors, placement groups, jobs — a restarted GCS replays them and
    # resumes; reference: gcs_init_data.h replaying from Redis,
    # gcs_table_storage.h:200). Nodes are NOT persisted: raylets get
    # "reregister" on their next heartbeat and repopulate the table.
    # ------------------------------------------------------------------
    def _load_persisted(self) -> None:
        if not (self.storage_path and os.path.exists(self.storage_path)):
            return
        try:
            with open(self.storage_path, "rb") as f:
                snap = pickle.load(f)
        except Exception:
            logger.exception("failed to load persisted state")
            return
        if isinstance(snap, dict) and "kv" in snap and "actors" in snap:
            self.kv = snap["kv"]
            self._load_blobs()
            self.actors = snap.get("actors", {})
            self.named_actors = snap.get("named_actors", {})
            self.placement_groups = snap.get("placement_groups", {})
            self.jobs = snap.get("jobs", {})
            self._job_counter = snap.get("job_counter", 0)
            # in-flight markers are meaningless across a restart
            for a in self.actors.values():
                a.lease_in_flight = a.creating = False
            n_live = sum(1 for a in self.actors.values()
                         if a.state != "DEAD")
            logger.info(
                "replayed persisted state: %d actors (%d live), %d PGs, "
                "%d jobs", len(self.actors), n_live,
                len(self.placement_groups), len(self.jobs))
            # no loop is running during __init__ — run() kicks this off
            self._needs_replay_reschedule = True
        else:  # pre-snapshot format: bare KV dict
            self.kv = snap

    async def _reschedule_replayed(self) -> None:
        """PENDING/RESTARTING actors from before the restart need a new
        scheduling attempt — wait for raylets to re-register first."""
        deadline = time.monotonic() + 60
        while not self.nodes and time.monotonic() < deadline:
            await asyncio.sleep(0.2)
        for actor in self.actors.values():
            if actor.state in ("PENDING", "RESTARTING"):
                logger.info("rescheduling replayed actor %s",
                            actor.actor_id[:12])
                asyncio.ensure_future(self._schedule_actor(actor))
        for pg in self.placement_groups.values():
            if pg.state == "PENDING":
                logger.info("rescheduling replayed placement group %s",
                            pg.pg_id[:12])
                asyncio.ensure_future(self._schedule_pg(pg))
        # ALIVE actors whose node died WHILE the GCS was down: the dead
        # node never re-registers, so the health checker (which only
        # scans registered nodes) would never fail them over — give
        # every live node a grace window to come back, then treat the
        # missing ones as dead.
        grace = max(5.0, 3 * config.raylet_heartbeat_period_ms / 1000.0)
        await asyncio.sleep(grace)
        for actor in list(self.actors.values()):
            if actor.state == "ALIVE" and actor.node_id and (
                    actor.node_id not in self.nodes
                    or not self.nodes[actor.node_id].alive):
                logger.warning(
                    "replayed actor %s was on node %s which did not "
                    "re-register; failing over", actor.actor_id[:12],
                    actor.node_id[:12])
                await self._handle_actor_failure(
                    actor, "node lost during GCS downtime")

    # KV namespaces holding large immutable blobs (runtime-env packages)
    # are persisted as write-once files beside the snapshot, keeping the
    # snapshot itself small enough to write synchronously at critical
    # mutations (a 100MB working_dir must not re-serialize per flush).
    _BLOB_NAMESPACES = ("runtime_env_packages",)

    # -- write-ahead log (reference: redis_store_client.h semantics —
    # every durable table mutation is written through BEFORE the state
    # is acknowledged; here an fsync'd append log + periodic snapshot
    # compaction replaces Redis) --------------------------------------
    _WAL_COMPACT_RECORDS = 2000

    def _wal_path(self) -> str:
        return self.storage_path + ".wal"

    def _wal_file(self):
        if self._wal is None:
            self._wal = open(self._wal_path(), "ab")
        return self._wal

    def _log(self, kind: str, *payload: Any) -> None:
        """Append one durable mutation to the WAL. The append is flushed
        to the OS but NOT fsync'd here: the RPC layer awaits
        ``_wal_barrier`` before sending any response, so one group
        fsync covers every record the current batch of handlers
        appended — a crash at ANY point after an ack still replays the
        mutation on restart, without a disk sync per mutation."""
        if not self.storage_path:
            return
        try:
            rec = pickle.dumps((kind, payload))
            f = self._wal_file()
            f.write(struct.pack("<I", len(rec)))
            f.write(rec)
            f.flush()
        except Exception:
            logger.exception("WAL append failed")
            # the mutation is acknowledged but not on disk: mark for the
            # compaction safety net so a later snapshot captures it, and
            # degrade to FULL actor records (slim actor_state deltas
            # need their base record to replay) until compaction
            self._dirty = True
            self._wal_degraded = True
            return
        self._wal_seq += 1
        self._wal_records += 1
        if self._wal_records >= self._WAL_COMPACT_RECORDS:
            self._compact()

    async def _wal_barrier(self) -> None:
        """Group-commit fsync (the RpcServer ``pre_response`` hook):
        make every WAL record appended so far durable before any
        handler's ack leaves the process. Concurrent barriers coalesce
        behind one lock — the first fsync covers the whole batch and
        the rest return without touching the disk."""
        if not self.storage_path or self._wal_synced >= self._wal_seq:
            return
        if self._wal_sync_lock is None:
            self._wal_sync_lock = asyncio.Lock()
        async with self._wal_sync_lock:
            seq = self._wal_seq
            if self._wal_synced >= seq:
                return
            f = self._wal
            if f is None:
                return  # compaction just truncated: state is in the snapshot
            try:
                fd = f.fileno()
                await asyncio.get_event_loop().run_in_executor(
                    None, os.fsync, fd)
            except Exception:  # noqa: BLE001
                if self._wal_synced >= seq:
                    return  # compaction raced the fsync; snapshot has it
                logger.exception("WAL group fsync failed")
                self._dirty = True
                self._wal_degraded = True
                return
            if self._wal_synced < seq:
                self._wal_synced = seq

    def _compact(self) -> None:
        """Fold the WAL into a fresh snapshot and truncate it. Crash
        between the snapshot replace and the truncate replays WAL
        records on top of a snapshot that already contains them —
        harmless, records are full-row idempotent."""
        self._dirty = True
        if not self._flush():
            # snapshot failed (e.g. disk full): keep the WAL — truncating
            # would discard the only durable copy of acknowledged state
            return
        # the fsync'd snapshot now holds every mutation applied so far;
        # advance the group-commit cursor BEFORE closing the file so a
        # barrier racing the close re-checks and finds itself covered
        self._wal_synced = self._wal_seq
        try:
            if self._wal is not None:
                self._wal.close()
            self._wal = open(self._wal_path(), "wb")
            self._wal.close()
            self._wal = None
        except Exception:
            logger.exception("WAL truncate failed")
        self._wal_records = 0
        self._wal_degraded = False

    def _replay_wal(self) -> Tuple[int, bool]:
        """Returns (records replayed, wal file existed). A torn or
        corrupt tail stops replay at the last intact record; the caller
        compacts, which truncates the garbage (records beyond a torn
        length prefix are unrecoverable — the framing chain is broken)."""
        path = self._wal_path()
        if not os.path.exists(path):
            return 0, False
        n = 0
        try:
            with open(path, "rb") as f:
                data = f.read()
            off = 0
            while off + 4 <= len(data):
                (ln,) = struct.unpack_from("<I", data, off)
                if off + 4 + ln > len(data):
                    break  # torn tail record from a mid-write crash
                kind, payload = pickle.loads(data[off + 4: off + 4 + ln])
                self._apply_wal(kind, payload)
                off += 4 + ln
                n += 1
        except Exception:
            logger.exception("WAL replay failed at record %d", n)
        self._wal_records = n
        return n, True

    # the mutable ActorInfo fields a state transition can touch — the
    # slim "actor_state" record carries only these, not the (possibly
    # huge) serialized creation spec logged once at registration
    _ACTOR_STATE_FIELDS = ("state", "version", "worker_addr", "node_id",
                           "worker_id", "num_restarts", "death_cause")

    def _log_actor_state(self, a: "ActorInfo") -> None:
        if self._wal_degraded:
            # a lost append may have been this actor's base record;
            # full rows keep replay self-contained until compaction
            self._log("actor", a)
            return
        self._log("actor_state", a.actor_id,
                  {f: getattr(a, f) for f in self._ACTOR_STATE_FIELDS})

    def _apply_wal(self, kind: str, payload: tuple) -> None:
        if kind == "actor":
            a = payload[0]
            self.actors[a.actor_id] = a
        elif kind == "actor_state":
            aid, fields = payload
            a = self.actors.get(aid)
            if a is None:
                logger.warning("WAL actor_state for unknown actor %s",
                               aid[:12])
            else:
                for f, v in fields.items():
                    setattr(a, f, v)
        elif kind == "named":
            ns, name, aid = payload
            self.named_actors[(ns, name)] = aid
        elif kind == "named_del":
            ns, name = payload
            self.named_actors.pop((ns, name), None)
        elif kind == "pg":
            pg = payload[0]
            self.placement_groups[pg.pg_id] = pg
        elif kind == "job":
            jid, info = payload
            self.jobs[jid] = info
        elif kind == "job_counter":
            self._job_counter = max(self._job_counter, payload[0])
        elif kind == "kv":
            ns, key, value = payload
            self.kv.setdefault(ns, {})[key] = value
        elif kind == "kv_blob":
            ns, key = payload
            try:
                with open(os.path.join(self._blob_dir(), ns + "." + key),
                          "rb") as f:
                    self.kv.setdefault(ns, {})[key] = f.read()
            except OSError:
                logger.warning("WAL blob %s/%s missing", ns, key)
        elif kind == "kv_del":
            ns, key = payload
            self.kv.get(ns, {}).pop(key, None)
        else:
            logger.warning("unknown WAL record kind %r", kind)

    def _log_kv(self, ns: str, key: str, value: bytes) -> None:
        """KV mutations route large blob namespaces to the side files
        (content-addressed, write-once) so the WAL stays small."""
        if ns in self._BLOB_NAMESPACES and self.storage_path:
            bd = self._blob_dir()
            os.makedirs(bd, exist_ok=True)
            p = os.path.join(bd, ns + "." + key)
            if not os.path.exists(p):
                with open(p + ".tmp", "wb") as f:
                    f.write(value)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(p + ".tmp", p)
            self._log("kv_blob", ns, key)
        else:
            self._log("kv", ns, key, value)

    def _blob_dir(self) -> str:
        return self.storage_path + ".blobs"

    def _flush(self) -> bool:
        if not (self.storage_path and self._dirty):
            return False
        self._dirty = False
        kv_snap: Dict[str, Any] = {}
        try:
            for ns, table in self.kv.items():
                if ns in self._BLOB_NAMESPACES:
                    bd = self._blob_dir()
                    os.makedirs(bd, exist_ok=True)
                    for key, blob in table.items():
                        p = os.path.join(bd, ns + "." + key)
                        if not os.path.exists(p):  # content-addressed
                            with open(p + ".tmp", "wb") as f:
                                f.write(blob)
                            os.replace(p + ".tmp", p)
                    kv_snap[ns] = {"__blob_keys__": list(table.keys())}
                else:
                    kv_snap[ns] = table
            snap = {
                "kv": kv_snap,
                "actors": self.actors,
                "named_actors": self.named_actors,
                "placement_groups": self.placement_groups,
                "jobs": self.jobs,
                "job_counter": self._job_counter,
            }
            tmp = self.storage_path + ".tmp"
            with open(tmp, "wb") as f:
                pickle.dump(snap, f)
                f.flush()
                os.fsync(f.fileno())  # the WAL is truncated on the
                # strength of this snapshot — it must actually be on disk
            os.replace(tmp, self.storage_path)
        except Exception:
            logger.exception("state snapshot failed")
            self._dirty = True
            return False
        return True

    def _load_blobs(self) -> None:
        for ns, table in list(self.kv.items()):
            if isinstance(table, dict) and "__blob_keys__" in table:
                loaded = {}
                bd = self._blob_dir()
                for key in table["__blob_keys__"]:
                    try:
                        with open(os.path.join(bd, ns + "." + key),
                                  "rb") as f:
                            loaded[key] = f.read()
                    except OSError:
                        logger.warning("blob %s/%s missing", ns, key)
                self.kv[ns] = loaded

    async def _flush_loop(self) -> None:
        # periodic compaction safety net: bounds WAL replay time even
        # under a steady mutation trickle that never hits the record cap
        while True:
            await asyncio.sleep(30.0)
            if self._wal_records or self._dirty:
                self._compact()

    def _loop_handle(self):
        """Clients bound to the GCS's OWN event loop (rpc.LoopHandle):
        an ``acall`` from a handler runs in-line instead of paying two
        cross-thread handoffs to the global client loop per control
        RPC — on a 1-core host that is a measurable slice of every
        actor-creation pipeline."""
        from ray_tpu_torch._private.rpc import LoopHandle

        h = getattr(self, "_loop_handle_cached", None)
        if h is None or h.loop is not asyncio.get_event_loop():
            h = self._loop_handle_cached = LoopHandle(
                asyncio.get_event_loop())
        return h

    def _raylet(self, node_id: str) -> RpcClient:
        c = self._raylet_clients.get(node_id)
        if c is None:
            node = self.nodes[node_id]
            c = RpcClient(node.address[0], node.address[1],
                          self._loop_handle())
            self._raylet_clients[node_id] = c
        return c

    _WORKER_CLIENT_CACHE_MAX = 128

    def _worker_client(self, addr: Tuple[str, int]) -> RpcClient:
        """LRU-bounded worker connections (CreateActor / KillActor):
        creation previously opened + tore down a fresh TCP connection
        per actor — connect latency inside every gated pipeline slot and
        fd churn at 2k-actor bursts. Bounded so a 40k-actor lifetime
        cannot pin 40k sockets; evicted (and dead-worker) clients close
        asynchronously and a later use simply reconnects."""
        cache = getattr(self, "_worker_clients", None)
        if cache is None:
            from collections import OrderedDict

            cache = self._worker_clients = OrderedDict()
        c = cache.get(addr)
        if c is None:
            c = cache[addr] = RpcClient(addr[0], addr[1],
                                        self._loop_handle())
        cache.move_to_end(addr)
        if len(cache) > self._WORKER_CLIENT_CACHE_MAX:
            # evict oldest IDLE clients only: closing a client with an
            # in-flight CreateActor/KillActor would fail that call
            # spuriously (multi-node gates can exceed the cap in
            # concurrent pipelines — the cache then temporarily runs
            # over and shrinks once those calls complete)
            for old_addr in list(cache):
                if len(cache) <= self._WORKER_CLIENT_CACHE_MAX:
                    break
                old = cache[old_addr]
                if old is c or old._pending:
                    continue
                del cache[old_addr]
                try:
                    old.close()
                except Exception:  # noqa: BLE001
                    pass
        return c

    # ------------------------------------------------------------------
    # Node management
    # ------------------------------------------------------------------
    async def RegisterNode(
        self,
        node_id: str,
        address: Tuple[str, int],
        store_socket: str,
        total_resources: Dict[str, float],
        is_head: bool = False,
        labels: Optional[Dict[str, str]] = None,
        agent_port: int = 0,
    ) -> dict:
        self.nodes[node_id] = NodeInfo(
            node_id=node_id,
            address=tuple(address),
            store_socket=store_socket,
            total_resources=dict(total_resources),
            available_resources=dict(total_resources),
            is_head=is_head,
            labels=labels or {},
            agent_port=agent_port,
        )
        self._node_version += 1
        logger.info("node %s registered: %s", node_id[:12], total_resources)
        return {"ok": True}

    async def Heartbeat(
        self, node_id: str, available_resources: Dict[str, float],
        pending_shapes: Optional[List[Dict[str, float]]] = None,
        num_leases: int = 0,
        draining: bool = False,
        drain_remaining_s: float = 0.0,
        drain_reason: str = "",
    ) -> dict:
        node = self.nodes.get(node_id)
        if node is None:
            return {"ok": False, "reregister": True}
        node.last_heartbeat = time.monotonic()
        node.available_resources = dict(available_resources)
        node.pending_shapes = list(pending_shapes or [])
        node.num_leases = num_leases
        # idle tracking for scale-down: a node is idle when it holds no
        # leases and has no queued demand
        if num_leases == 0 and not node.pending_shapes:
            if node.idle_since is None:
                node.idle_since = time.monotonic()
        else:
            node.idle_since = None
        if not node.alive:
            if draining:
                # a final heartbeat from a raylet whose drain we already
                # completed (it is exiting): don't resurrect the node —
                # and don't re-enter DRAINING, which would replay the
                # completion through the watchdog
                return {"ok": True, "shutdown": True}
            node.alive = True
            # a stale draining flag (the node died mid-drain and was
            # force-completed) must not revive the node as DRAINING:
            # this resurrection is a plain health-check recovery, so it
            # re-enters ALIVE — DrainNode re-issues a drain if one is
            # still wanted
            node.draining = False
            self._node_version += 1
        if draining and not node.draining:
            # a GCS restarted mid-drain relearns the DRAINING state from
            # the raylet's heartbeats (nodes aren't persisted); the
            # raylet keeps driving its own drain and will send
            # NodeDrainComplete — no new orchestration task here, the
            # health watchdog bounds a raylet that dies first
            self._enter_draining(node, drain_reason, drain_remaining_s)
        # piggyback the cluster resource view so raylets can spill leases
        # to other nodes (reference: ray_syncer.h:91 resource broadcast)
        reply = {"ok": True, "cluster": self._cluster_view(),
                 "autoscaling":
                     time.monotonic() < self.autoscaler_enabled_until}
        if node.draining and not draining:
            # the GCS knows the node is draining but the raylet doesn't
            # (the Drain RPC was lost): re-issue the instruction on the
            # heartbeat reply
            reply["drain"] = {
                "reason": node.drain_reason,
                "deadline_s": max(0.0,
                                  node.drain_deadline - time.monotonic()),
            }
        return reply

    async def SetAutoscalerEnabled(self, enabled: bool,
                                   ttl_s: float = 30.0) -> dict:
        """An attached autoscaler flips lease semantics: locally
        infeasible requests queue (visible as demand) instead of failing
        (reference: infeasible tasks wait for the autoscaler). The flag
        is a TTL lease the autoscaler renews each reconcile round."""
        self.autoscaler_enabled_until = \
            (time.monotonic() + ttl_s) if enabled else 0.0
        return {"ok": True}

    def _cluster_view(self) -> Dict[str, dict]:
        return {
            n.node_id: {
                "addr": n.address,
                "alive": n.alive,
                "draining": n.draining,
                "total": dict(n.total_resources),
                "available": dict(n.available_resources),
            }
            for n in self.nodes.values()
        }

    async def GetClusterDemand(self) -> dict:
        """Autoscaler input (reference: autoscaler/v2 reads
        GcsAutoscalerStateManager): per-node availability, queued lease
        shapes, pending (unschedulable) actors, and idle times."""
        now = time.monotonic()
        pending_actors = [
            dict(a.resources)
            for a in self.actors.values()
            # lease_in_flight actors already appear in some raylet's
            # pending_shapes — counting both would double the demand. A
            # RESTARTING actor with no worker is as unplaced as a PENDING
            # one: its node died or drained, and its restart may need a
            # node the autoscaler has yet to launch (the JAX package
            # counts PENDING alone, so a lost card node's actor never
            # brings a replacement up)
            if a.state in ("PENDING", "RESTARTING") and a.worker_addr is None
            and not a.lease_in_flight and not a.creating
        ]
        return {
            "nodes": [
                {
                    "node_id": n.node_id,
                    "alive": n.alive,
                    "draining": n.draining,
                    "is_head": n.is_head,
                    "total": dict(n.total_resources),
                    "available": dict(n.available_resources),
                    "pending_shapes": list(n.pending_shapes),
                    "num_leases": n.num_leases,
                    "idle_s": (now - n.idle_since)
                    if n.idle_since is not None else 0.0,
                    "labels": dict(n.labels),
                }
                for n in self.nodes.values()
            ],
            "pending_actors": pending_actors,
        }

    # ------------------------------------------------------------------
    # Graceful drain (reference: gcs_service.proto DrainNode with a
    # deadline + DRAIN_NODE_REASON_PREEMPTION; _private/drain.py has the
    # lifecycle). Planned node loss is a protocol, not a health-check
    # timeout: the node stops taking work, in-flight work finishes or
    # migrates, and only then is the node marked dead.
    # ------------------------------------------------------------------
    async def DrainNode(self, node_id: str, reason: str = "",
                        deadline_s: Optional[float] = None) -> dict:
        from ray_tpu_torch._private import drain as drain_mod

        node = self.nodes.get(node_id)
        if node is None or not node.alive:
            return {"ok": False, "error": f"node {node_id[:12]} not alive"}
        if deadline_s is None:
            deadline_s = config.drain_deadline_default_s
        reason = reason or drain_mod.REASON_IDLE_TERMINATION
        # preempting one slice member preempts the whole slice: a TPU
        # pod slice is one ICI failure domain (SlicePlacementGroup /
        # JaxTrainer assume gang semantics), so the rest of the slice
        # drains with it rather than limping on and timing out later
        targets = [node]
        slice_id = node.labels.get("slice_id")
        if slice_id and reason == drain_mod.REASON_PREEMPTION:
            for n in self.nodes.values():
                if (n is not node and n.alive and not n.draining
                        and n.labels.get("slice_id") == slice_id):
                    targets.append(n)
        started = []
        for n in targets:
            if n.draining:
                continue
            self._start_drain(n, reason, deadline_s)
            started.append(n.node_id)
        return {"ok": True, "draining": started,
                "already_draining": node.draining and not started}

    def _enter_draining(self, node: NodeInfo, reason: str,
                        deadline_s: float) -> None:
        """Single entry point for the DRAINING state (used by the
        DrainNode orchestration, the heartbeat relearn after a GCS
        restart, and a raylet-initiated completion the GCS never saw
        start): sets the fields, bumps the node version, and publishes
        — every observer sees the same transition."""
        node.draining = True
        node.drain_reason = reason
        node.drain_started_at = time.monotonic()
        node.drain_deadline = node.drain_started_at + max(0.0, deadline_s)
        self._node_version += 1
        self._publish_and_wake(
            "node_state", node.node_id,
            {"alive": True, "draining": True, "reason": reason})

    def _start_drain(self, node: NodeInfo, reason: str,
                     deadline_s: float) -> None:
        from ray_tpu_torch._private import drain as drain_mod

        self._enter_draining(node, reason, deadline_s)
        logger.info("draining node %s (%s, deadline %.1fs)",
                    node.node_id[:12], reason, deadline_s)
        self.cluster_events.add([{
            "type": drain_mod.EVENT_DRAIN_START,
            "ts": time.time(),
            "node_id": node.node_id,
            "reason": reason,
            "deadline_s": deadline_s,
        }])
        asyncio.ensure_future(self._drain_node_task(node, reason, deadline_s))

    def _drain_done_event(self, node_id: str) -> asyncio.Event:
        ev = self._drain_done_events.get(node_id)
        if ev is None:
            ev = self._drain_done_events[node_id] = asyncio.Event()
        return ev

    async def _drain_node_task(self, node: NodeInfo, reason: str,
                               deadline_s: float) -> None:
        """Orchestrate one node's drain: tell the raylet, migrate the
        actors, then wait for the raylet's completion (or the deadline)
        before declaring the node dead."""
        ev = self._drain_done_event(node.node_id)
        try:
            await self._raylet(node.node_id).acall(
                "Drain", reason=reason, deadline_s=deadline_s, timeout=10)
        except Exception as e:  # noqa: BLE001 — heartbeat replies carry
            # the drain instruction as a fallback; the watchdog bounds it
            logger.warning("Drain RPC to %s failed: %s",
                           node.node_id[:12], e)
        mig = asyncio.ensure_future(self._migrate_node_actors(node, reason))
        self._drain_migrations[node.node_id] = mig
        # wait for the raylet to confirm; the deadline plus a small
        # grace bounds the wait (the health watchdog is the backstop
        # when this task itself died with a restarted GCS)
        remaining = max(0.0, node.drain_deadline - time.monotonic())
        try:
            await asyncio.wait_for(
                ev.wait(), timeout=remaining + config.drain_watchdog_grace_s)
        except asyncio.TimeoutError:
            logger.warning("drain of %s hit its deadline without raylet "
                           "confirmation", node.node_id[:12])
        try:
            await asyncio.wait_for(mig, timeout=5.0)
        except (asyncio.TimeoutError, Exception):  # noqa: BLE001
            pass
        await self._finish_drain(node.node_id)

    async def _migrate_node_actors(self, node: NodeInfo,
                                   reason: str) -> None:
        """Gracefully restart every ALIVE actor off the draining node:
        the old instance first stops accepting and finishes its accepted
        tasks (worker DrainActor), then the normal failure path restarts
        it per max_restarts — with watchers woken by the published
        actor_state event, not a health-check timeout."""
        # only ALIVE actors need migration: a PENDING actor has run no
        # code — its scheduling loop re-picks on its own (the draining
        # node is excluded from _pick_node_for and rejects its lease),
        # and routing it through _handle_actor_failure would charge (or
        # at max_restarts=0, spend) a restart for a planned drain
        victims = [a for a in self.actors.values()
                   if a.node_id == node.node_id and a.state == "ALIVE"]
        if not victims:
            return
        budget = max(0.5, node.drain_deadline - time.monotonic() - 1.0)

        async def _one(actor: ActorInfo) -> None:
            if actor.worker_addr:
                try:
                    await asyncio.wait_for(
                        self._worker_client(tuple(actor.worker_addr)).acall(
                            "DrainActor", actor_id=actor.actor_id,
                            timeout_s=budget, timeout=budget + 5),
                        timeout=budget + 6)
                except Exception:  # noqa: BLE001 — worker already gone
                    pass
            a = self.actors.get(actor.actor_id)
            if a is not None and a.node_id == node.node_id \
                    and a.state == "ALIVE":
                await self._handle_actor_failure(
                    a, f"node {node.node_id[:12]} draining ({reason})")

        await asyncio.gather(*(_one(a) for a in victims),
                             return_exceptions=True)
        logger.info("migrated %d actor(s) off draining node %s",
                    len(victims), node.node_id[:12])

    async def NodeDrainComplete(self, node_id: str,
                                moved_objects: Optional[dict] = None) -> dict:
        """Raylet-side drain finished: record where it pushed its
        primary object copies, wait for the actor migration, and mark
        the node dead. The raylet blocks on this reply before killing
        its workers, so migration RPCs to them cannot race the exit."""
        if moved_objects:
            self._record_moved_objects(moved_objects)
        mig = self._drain_migrations.get(node_id)
        if mig is not None and not mig.done():
            try:
                await asyncio.wait_for(asyncio.shield(mig), timeout=30)
            except (asyncio.TimeoutError, Exception):  # noqa: BLE001
                pass
        node = self.nodes.get(node_id)
        if node is not None and node.alive and not node.draining:
            # raylet-initiated drain that finished inside one heartbeat
            # period (we never saw DRAINING): the raylet is exiting
            # regardless — run the completion path so the node is
            # cleanly dead instead of waiting out the health checker
            self._enter_draining(node, node.drain_reason, 0.0)
        if node is not None and node.draining:
            self._drain_done_event(node_id).set()
            await self._finish_drain(node_id)
        return {"ok": True}

    _MOVED_OBJECTS_MAX = 20_000

    def _record_moved_objects(self, moved: dict) -> None:
        """Bounded oid_bin -> node_id directory of primary copies pushed
        off drained nodes; owners consult it when a pull from the
        recorded node fails (_pull_remote_object fallback)."""
        table = self.moved_objects
        for oid_bin, nid in moved.items():
            table[bytes(oid_bin)] = nid
            table.move_to_end(bytes(oid_bin))
        while len(table) > self._MOVED_OBJECTS_MAX:
            table.popitem(last=False)

    async def LookupObjectLocations(self, object_id_bins: List[bytes]) -> dict:
        table = self.moved_objects
        return {
            bytes(b): table[bytes(b)]
            for b in object_id_bins if bytes(b) in table
        }

    async def _finish_drain(self, node_id: str) -> None:
        from ray_tpu_torch._private import drain as drain_mod

        node = self.nodes.get(node_id)
        if node is None or not node.draining:
            return
        node.draining = False
        node.alive = False
        node.drain_deadline = 0.0
        self._node_version += 1
        duration = time.monotonic() - (node.drain_started_at
                                       or time.monotonic())
        logger.info("drain of node %s complete (%.1fs)",
                    node_id[:12], duration)
        self.cluster_events.add([{
            "type": drain_mod.EVENT_DRAIN_COMPLETE,
            "ts": time.time(),
            "node_id": node_id,
            "reason": node.drain_reason,
            "duration_s": round(duration, 3),
        }])
        self._publish_and_wake(
            "node_state", node_id, {"alive": False, "drained": True})
        self._drain_migrations.pop(node_id, None)
        self._drain_done_events.pop(node_id, None)
        # drop the cached raylet client — the daemon is exiting
        c = self._raylet_clients.pop(node_id, None)
        if c is not None:
            try:
                c.close()
            except Exception:  # noqa: BLE001
                pass
        # any actor the migration missed fails over through the normal
        # node-death path (idempotent for already-RESTARTING actors)
        await self._on_node_death(node_id)

    async def GetAllNodeInfo(self) -> List[dict]:
        return [
            {
                "NodeID": n.node_id,
                "Alive": n.alive,
                "Draining": n.draining,
                "DrainReason": n.drain_reason if n.draining else "",
                "NodeManagerAddress": n.address[0],
                "NodeManagerPort": n.address[1],
                "ObjectStoreSocketName": n.store_socket,
                "Resources": dict(n.total_resources),
                "AvailableResources": dict(n.available_resources),
                "IsHead": n.is_head,
                "Labels": dict(n.labels),
                "AgentPort": n.agent_port,
            }
            for n in self.nodes.values()
        ]

    async def GetClusterResources(self) -> Dict[str, Dict[str, float]]:
        total: Dict[str, float] = {}
        avail: Dict[str, float] = {}
        for n in self.nodes.values():
            if not n.alive or n.draining:
                continue
            for k, v in n.total_resources.items():
                total[k] = total.get(k, 0.0) + v
            for k, v in n.available_resources.items():
                avail[k] = avail.get(k, 0.0) + v
        return {"total": total, "available": avail}

    async def _health_check_loop(self) -> None:
        period = config.gcs_health_check_period_ms / 1000.0
        threshold = (
            config.gcs_health_check_period_ms
            * config.gcs_health_check_failure_threshold
            / 1000.0
        )
        while True:
            await asyncio.sleep(period)
            now = time.monotonic()
            self._sample_control_plane_counters()
            for node in list(self.nodes.values()):
                if node.alive and node.draining and \
                        now > node.drain_deadline \
                        + config.drain_watchdog_grace_s:
                    # drain watchdog: past deadline + grace a DRAINING
                    # node is force-completed (the raylet died mid-drain,
                    # or a restarted GCS lost the orchestration task) —
                    # no node sits DRAINING forever
                    logger.warning(
                        "node %s stuck DRAINING past its deadline; "
                        "force-completing", node.node_id[:12])
                    self._debug_dump_fanout(
                        "drain_deadline_expired", node_id=node.node_id,
                        reason=node.drain_reason)
                    await self._finish_drain(node.node_id)
                    continue
                if node.alive and now - node.last_heartbeat > threshold:
                    logger.warning("node %s missed heartbeats; marking dead", node.node_id[:12])
                    if node.draining:
                        # a DRAINING node that stops heartbeating died
                        # mid-drain: run the full completion path so the
                        # NODE_DRAIN_COMPLETE event fires and the drain
                        # bookkeeping (done events, migration task,
                        # cached raylet client) is cleaned up
                        await self._finish_drain(node.node_id)
                        continue
                    node.alive = False
                    self._node_version += 1
                    self._publish_and_wake(
                        "node_state", node.node_id, {"alive": False}
                    )
                    await self._on_node_death(node.node_id)

    async def _on_node_death(self, node_id: str) -> None:
        # actors on that node die / restart
        for actor in list(self.actors.values()):
            if actor.node_id == node_id and actor.state in ("ALIVE", "PENDING"):
                await self._handle_actor_failure(actor, f"node {node_id[:12]} died")

    # ------------------------------------------------------------------
    # Job management
    # ------------------------------------------------------------------
    async def RegisterJob(self, driver_addr: Tuple[str, int], metadata: Optional[dict] = None) -> dict:
        self._job_counter += 1
        job_id_int = self._job_counter
        from ray_tpu_torch._private.ids import JobID

        job_id = JobID.from_int(job_id_int).hex()
        self.jobs[job_id] = {
            "job_id": job_id,
            "driver_addr": tuple(driver_addr),
            "start_time": time.time(),
            "state": "RUNNING",
            "metadata": metadata or {},
        }
        self._log("job_counter", self._job_counter)
        self._log("job", job_id, self.jobs[job_id])
        return {"job_id_int": job_id_int, "job_id": job_id}

    async def MarkJobFinished(self, job_id: str) -> dict:
        if job_id in self.jobs:
            self.jobs[job_id]["state"] = "FINISHED"
            self.jobs[job_id]["end_time"] = time.time()
            self._log("job", job_id, self.jobs[job_id])
        # non-detached actors owned by the job die with it
        for actor in list(self.actors.values()):
            if actor.job_id == job_id and not actor.detached and actor.state != "DEAD":
                await self._kill_actor_impl(actor, "job finished")
        return {"ok": True}

    async def ListJobs(self) -> List[dict]:
        return list(self.jobs.values())

    # ------------------------------------------------------------------
    # KV (function table, runtime env, cluster metadata)
    # ------------------------------------------------------------------
    async def KVPut(self, ns: str, key: str, value: bytes, overwrite: bool = True) -> dict:
        table = self.kv.setdefault(ns, {})
        if not overwrite and key in table:
            return {"added": False}
        table[key] = value
        self._log_kv(ns, key, value)
        return {"added": True}

    async def KVGet(self, ns: str, key: str) -> Optional[bytes]:
        return self.kv.get(ns, {}).get(key)

    async def KVDel(self, ns: str, key: str) -> dict:
        self.kv.get(ns, {}).pop(key, None)
        if ns in self._BLOB_NAMESPACES and self.storage_path:
            try:
                os.unlink(os.path.join(self._blob_dir(), ns + "." + key))
            except OSError:
                pass
        self._log("kv_del", ns, key)
        return {"ok": True}

    async def KVKeys(self, ns: str, prefix: str = "") -> List[str]:
        return [k for k in self.kv.get(ns, {}) if k.startswith(prefix)]

    async def KVExists(self, ns: str, key: str) -> bool:
        return key in self.kv.get(ns, {})

    # ------------------------------------------------------------------
    # Actor management
    # ------------------------------------------------------------------
    async def RegisterActor(
        self,
        actor_id: str,
        job_id: str,
        serialized_spec: bytes,
        name: Optional[str],
        namespace: str,
        max_restarts: int,
        resources: Dict[str, float],
        owner_addr: Tuple[str, int],
        detached: bool = False,
        get_if_exists: bool = False,
        pg_id: Optional[str] = None,
        bundle_index: int = -1,
        cpu_scheduling_only: bool = False,
        runtime_env_hash: str = "",
        scheduling_kind: str = "DEFAULT",
        affinity_node_id: Optional[str] = None,
        strategy_soft: bool = False,
        node_labels: Optional[Dict[str, str]] = None,
    ) -> dict:
        # idempotent retry: a caller re-sending after a lost reply (GCS
        # crash post-persist, or chaos response drop) must not create a
        # second instance or see a spurious name conflict
        if actor_id in self.actors:
            return {"actor_id": actor_id, "existing": True}
        if name:
            existing = self.named_actors.get((namespace, name))
            if existing is not None and existing != actor_id:
                ex = self.actors.get(existing)
                if ex is not None and ex.state != "DEAD":
                    if get_if_exists:
                        return {"actor_id": existing, "existing": True}
                    return {"error": f"Actor with name '{name}' already exists"}
        actor = ActorInfo(
            actor_id=actor_id,
            job_id=job_id,
            name=name,
            namespace=namespace,
            state="PENDING",
            serialized_spec=serialized_spec,
            owner_addr=tuple(owner_addr),
            max_restarts=max_restarts,
            resources=dict(resources),
            detached=detached,
            pg_id=pg_id,
            bundle_index=bundle_index,
            cpu_scheduling_only=cpu_scheduling_only,
            runtime_env_hash=runtime_env_hash,
            scheduling_kind=scheduling_kind,
            affinity_node_id=affinity_node_id,
            strategy_soft=strategy_soft,
            node_labels=dict(node_labels) if node_labels else None,
        )
        self.actors[actor_id] = actor
        self._log("actor", actor)
        obs_timeline.mark_actor(actor_id, "registered", job_id=job_id)
        if name:
            self.named_actors[(namespace, name)] = actor_id
            self._log("named", namespace, name, actor_id)
        asyncio.ensure_future(self._schedule_actor(actor))
        return {"actor_id": actor_id, "existing": False}

    def _pick_node_for(self, resources: Dict[str, float], pg: Optional[PlacementGroupInfo], bundle_index: int,
                       actor: Optional[ActorInfo] = None) -> Optional[str]:
        """GCS-side actor scheduling (reference: GcsActorScheduler
        gcs_actor_scheduler.h:104 — uses cluster resource view); honors
        the actor's node-affinity / node-label strategy."""
        if pg is not None:
            if bundle_index >= 0:
                return pg.bundle_nodes.get(bundle_index)
            # any bundle's node with room
            for idx, nid in pg.bundle_nodes.items():
                node = self.nodes.get(nid)
                if node and node.alive and not node.draining:
                    return nid
            return None

        def _matches(n: NodeInfo) -> bool:
            if actor is None:
                return True
            if actor.scheduling_kind == "NODE_AFFINITY":
                return n.node_id == actor.affinity_node_id
            if actor.scheduling_kind == "NODE_LABEL":
                return all(n.labels.get(k) == v
                           for k, v in (actor.node_labels or {}).items())
            return True

        alive = [n for n in self.nodes.values()
                 if n.alive and not n.draining]
        allowed = [n for n in alive if _matches(n)]
        if actor is not None and actor.strategy_soft:
            # soft: fall back when nothing matches OR the matches can
            # never fit the request (total resources too small)
            fittable = [
                n for n in allowed
                if all(n.total_resources.get(k, 0.0) >= v
                       for k, v in resources.items())
            ]
            if not fittable:
                allowed = alive
        candidates = []
        for n in allowed:
            if all(n.available_resources.get(k, 0.0) >= v for k, v in resources.items()):
                # least-loaded first: fewest live actors already placed there
                load = sum(1 for a in self.actors.values()
                           if a.node_id == n.node_id and a.state != "DEAD")
                candidates.append((load, n.node_id))
        if not candidates:
            # fall back: any ALLOWED node whose *total* resources fit
            # (may queue behind current occupants)
            for n in allowed:
                if all(n.total_resources.get(k, 0.0) >= v for k, v in resources.items()):
                    return n.node_id
            return None
        candidates.sort()
        return candidates[0][1]

    def _creation_gate(self, node_id: str):
        """Admission control for actor creation (reference:
        GcsActorScheduler bounds in-flight leases per node). A burst of
        thousands of RegisterActor calls must NOT run thousands of
        lease+spawn+CreateActor pipelines concurrently: on a host whose
        CPU count is far below the burst size, every stage of every
        pipeline times out against the others and creation collapses
        (observed: 624/2000 actors never ALIVE on the 1-CPU CI box).
        Bounded concurrency turns the herd into a steady pipeline at
        identical throughput — the stages are CPU-bound anyway.

        One gate PER TARGET NODE (`actor_creation_concurrency` each):
        total in-flight creations scale with the cluster, and one slow
        node's pipeline backlog cannot stall placements elsewhere."""
        gate = self._actor_create_gates.get(node_id)
        if gate is None:
            gate = self._actor_create_gates[node_id] = asyncio.Semaphore(
                max(1, config.actor_creation_concurrency))
        return gate

    def _maybe_prestart_workers(self) -> None:
        """Overlap worker bring-up with the creation pipeline: when a
        burst of PENDING actors is queued, tell each node's raylet to
        prefork workers NOW (zygote spawns run while earlier creations
        hold the gate), so the lease stage of later pipelines finds
        registered idle workers instead of paying a cold spawn inside
        its gate slot (reference: WorkerPool::PrestartWorkers,
        worker_pool.h:280). Throttled; oneway — never blocks scheduling."""
        now = time.monotonic()
        if now - self._last_prestart < 0.25:
            return
        pending = sum(1 for a in self.actors.values()
                      if a.state == "PENDING")
        if pending < 2:
            return
        self._last_prestart = now
        alive = [n for n in self.nodes.values()
                 if n.alive and not n.draining]
        if not alive:
            return
        per_node = max(1, min(config.actor_creation_concurrency,
                              (pending + len(alive) - 1) // len(alive)))
        for n in alive:
            try:
                self._raylet(n.node_id).call_oneway(
                    "PrestartWorkers", count=per_node)
            except Exception:  # noqa: BLE001 — advisory
                pass

    async def _schedule_actor(self, actor: ActorInfo) -> None:
        """Lease a worker for the actor and push its creation task
        (reference: GcsActorScheduler + SchedulePendingActors
        gcs_actor_manager.cc:1721). The creation gate bounds only the
        lease+CreateActor attempt — an actor merely WAITING for
        placeable resources holds no slot, so unplaceable actors can't
        starve the pipeline."""
        deadline = time.monotonic() + config.actor_schedule_timeout_s
        while time.monotonic() < deadline:
            if actor.state == "DEAD":
                return
            # hard affinity to a node id that is registered-but-dead can
            # never succeed (node ids are never reused) — fail fast with
            # a precise cause instead of spinning out the 300s deadline.
            # (Hard LABELS keep waiting: a matching node may be added,
            # e.g. by the autoscaler.)
            if (actor.scheduling_kind == "NODE_AFFINITY"
                    and not actor.strategy_soft):
                target = self.nodes.get(actor.affinity_node_id)
                if target is not None and not target.alive:
                    actor.state = "DEAD"
                    actor.death_cause = (
                        f"node {actor.affinity_node_id[:12]} is dead "
                        f"(NodeAffinity soft=False)")
                    actor.version += 1
                    self._notify_actor(actor.actor_id)
                    return
            pg = self.placement_groups.get(actor.pg_id) if actor.pg_id else None
            node_id = self._pick_node_for(actor.resources, pg,
                                          actor.bundle_index, actor=actor)
            if node_id is None:
                await asyncio.sleep(0.2)
                continue
            self._maybe_prestart_workers()
            gate_wait_from = time.monotonic()
            async with self._creation_gate(node_id):
                # The schedule deadline must budget CREATION time, not
                # time spent QUEUED behind other creations at the gate:
                # in a large burst with slow __init__, tail actors sit at
                # the gate for most of the 300s window and were marked
                # DEAD on their first transient retry. Credit the queue
                # wait back (reference: the per-node in-flight lease
                # bound applies before the scheduling timer starts).
                deadline += time.monotonic() - gate_wait_from
                if actor.state == "DEAD":  # killed while queued at gate
                    return
                outcome = await self._try_create_once(actor, node_id)
            if outcome is None:
                return
            await asyncio.sleep(outcome)
        actor.state = "DEAD"
        if actor.scheduling_kind in ("NODE_AFFINITY", "NODE_LABEL") \
                and not actor.strategy_soft:
            actor.death_cause = (
                f"scheduling timed out: no node satisfied the hard "
                f"{actor.scheduling_kind} constraint "
                f"(node_id={actor.affinity_node_id!r}, "
                f"labels={actor.node_labels!r})")
        else:
            actor.death_cause = "scheduling timed out (insufficient resources?)"
        actor.version += 1
        self._notify_actor(actor.actor_id)

    async def _try_create_once(self, actor: ActorInfo,
                               node_id: str) -> Optional[float]:
        """One gated lease+CreateActor attempt. Returns None when the
        actor reached a terminal state (ALIVE or DEAD), else the retry
        delay for the caller's loop."""
        try:
            obs_timeline.mark_actor(actor.actor_id, "scheduled",
                                    job_id=actor.job_id, node_id=node_id)
            raylet = self._raylet(node_id)
            actor.lease_in_flight = True
            try:
                reply = await raylet.acall(
                    "RequestWorkerLease",
                    resources=actor.resources,
                    scheduling_class=("actor", actor.actor_id),
                    job_id=actor.job_id,
                    for_actor=actor.actor_id,
                    pg_id=actor.pg_id,
                    bundle_index=actor.bundle_index,
                    lease_timeout=50.0,
                    release_cpu_after_grant=actor.cpu_scheduling_only,
                    runtime_env_hash=actor.runtime_env_hash,
                    timeout=60,
                )
            finally:
                actor.lease_in_flight = False
        except Exception as e:  # noqa: BLE001
            logger.warning("actor %s lease request to %s failed: %s", actor.actor_id[:12], node_id[:12], e)
            return 0.5
        if not reply.get("granted"):
            return 0.2
        obs_timeline.mark_actor(actor.actor_id, "lease_granted",
                                job_id=actor.job_id, node_id=node_id)
        worker_addr = tuple(reply["worker_addr"])
        actor.creating = True
        try:
            worker = self._worker_client(worker_addr)
            creation_reply = await worker.acall(
                "CreateActor",
                actor_id=actor.actor_id,
                serialized_spec=actor.serialized_spec,
                # actor __init__ is user code (may cold-import jax,
                # build models); the generic RPC timeout would abort
                # + re-lease in a loop, never letting init finish
                timeout=config.actor_creation_timeout_s,
            )
        except Exception as e:  # noqa: BLE001
            actor.creating = False
            logger.warning("actor %s creation push failed: %s", actor.actor_id[:12], e)
            # the worker may still be running __init__ — return the lease
            # with worker_dead=True (kills the worker) so the retry can't
            # produce a second live instance and the lease isn't leaked
            try:
                await self._raylet(node_id).acall(
                    "ReturnWorkerLease", lease_id=reply["lease_id"], worker_dead=True
                )
            except Exception:
                pass
            return 0.5
        actor.creating = False
        if creation_reply.get("ok"):
            actor.state = "ALIVE"
            actor.worker_addr = worker_addr
            actor.node_id = node_id
            actor.worker_id = reply.get("worker_id")
            actor.version += 1
            obs_timeline.mark_actor(actor.actor_id, "alive",
                                    job_id=actor.job_id, node_id=node_id)
            self._notify_actor(actor.actor_id)
            logger.info("actor %s alive on %s", actor.actor_id[:12], node_id[:12])
            return None
        # creation raised in user __init__ — actor is dead
        actor.state = "DEAD"
        actor.death_cause = creation_reply.get("error", "creation failed")
        actor.version += 1
        self._notify_actor(actor.actor_id)
        try:
            await self._raylet(node_id).acall(
                "ReturnWorkerLease", lease_id=reply["lease_id"], worker_dead=False
            )
        except Exception:
            pass
        return None

    def _notify_actor(self, actor_id: str) -> None:
        evt = self._actor_events.get(actor_id)
        if evt is not None:
            evt.set()
            self._actor_events[actor_id] = asyncio.Event()
        a = self.actors.get(actor_id)
        self._publish_and_wake(
            "actor_state", actor_id,
            # the event carries enough to RESOLVE the actor (state +
            # address): subscribers' warm path needs no GetActorInfo
            # round-trip after the wake
            {"state": a.state, "version": a.version,
             "worker_addr": tuple(a.worker_addr) if a.worker_addr else None,
             "death_cause": a.death_cause} if a else None,
        )
        if a is not None:
            self._log_actor_state(a)  # every state change is durable;
            # slim record — the full spec was logged at registration

    async def GetActorInfo(self, actor_id: str) -> Optional[dict]:
        a = self.actors.get(actor_id)
        if a is None:
            return None
        return {
            "actor_id": a.actor_id,
            "state": a.state,
            "worker_addr": a.worker_addr,
            "node_id": a.node_id,
            "name": a.name,
            "num_restarts": a.num_restarts,
            "death_cause": a.death_cause,
            "version": a.version,
        }

    async def WaitActorUpdate(self, actor_id: str, from_version: int, timeout_s: float = 10.0) -> Optional[dict]:
        """Long-poll for actor state changes (reference: pubsub actor channel)."""
        a = self.actors.get(actor_id)
        if a is None:
            return None
        if a.version > from_version:
            return await self.GetActorInfo(actor_id)
        evt = self._actor_events.setdefault(actor_id, asyncio.Event())
        try:
            await asyncio.wait_for(evt.wait(), timeout=timeout_s)
        except asyncio.TimeoutError:
            pass
        return await self.GetActorInfo(actor_id)

    async def GetActorByName(self, name: str, namespace: str) -> Optional[str]:
        aid = self.named_actors.get((namespace, name))
        if aid is not None:
            a = self.actors.get(aid)
            if a is not None and a.state != "DEAD":
                return aid
        return None

    async def ListActors(self) -> List[dict]:
        return [await self.GetActorInfo(aid) for aid in list(self.actors)]

    async def ListPlacementGroups(self) -> List[dict]:
        return [
            {
                "placement_group_id": pg.pg_id,
                "name": pg.name,
                "state": pg.state,
                "strategy": pg.strategy,
                "bundles": pg.bundles,
                "bundle_nodes": dict(pg.bundle_nodes),
            }
            for pg in self.placement_groups.values()
        ]

    async def ReportActorFault(self, actor_id: str, worker_addr: Tuple[str, int], error: str) -> dict:
        """Called by a caller that failed to reach the actor's worker."""
        actor = self.actors.get(actor_id)
        if actor is None:
            return {"ok": False}
        if actor.state == "ALIVE" and actor.worker_addr == tuple(worker_addr):
            await self._handle_actor_failure(actor, error)
        return {"ok": True}

    async def NotifyWorkerDeath(self, node_id: str, worker_id: str, worker_addr: Tuple[str, int]) -> dict:
        """Raylet reports a worker process exit."""
        for actor in list(self.actors.values()):
            if actor.state == "ALIVE" and actor.worker_addr == tuple(worker_addr):
                await self._handle_actor_failure(actor, f"worker process died on {node_id[:12]}")
        return {"ok": True}

    async def _handle_actor_failure(self, actor: ActorInfo, cause: str) -> None:
        # actor restarts/deaths are first-class bus events (the GCS is
        # the aggregator, so it appends directly — no RPC to itself)
        self.cluster_events.add([{
            "type": "actor_restart",
            "ts": time.time(),
            "actor_id": actor.actor_id,
            "job_id": actor.job_id,
            "num_restarts": actor.num_restarts,
            "will_restart": actor.num_restarts < actor.max_restarts
            or actor.max_restarts == -1,
            "cause": cause,
        }])
        if actor.num_restarts < actor.max_restarts or actor.max_restarts == -1:
            actor.num_restarts += 1
            actor.state = "RESTARTING"
            actor.worker_addr = None
            # recorded for RESTARTING too: callers use it to tell a
            # PLANNED restart (node drain — old instance finished its
            # accepted work, safe to resend) from a crash
            actor.death_cause = cause
            actor.version += 1
            self._notify_actor(actor.actor_id)
            logger.info("actor %s restarting (%d/%s): %s", actor.actor_id[:12], actor.num_restarts, actor.max_restarts, cause)
            asyncio.ensure_future(self._schedule_actor(actor))
        else:
            actor.state = "DEAD"
            actor.death_cause = cause
            actor.worker_addr = None
            actor.version += 1
            self._notify_actor(actor.actor_id)
            # restarts exhausted: the black box gets persisted while the
            # failure context is still in everyone's rings
            self._debug_dump_fanout(
                "actor_restarts_exhausted", actor_id=actor.actor_id,
                job_id=actor.job_id, cause=cause)

    async def KillActor(self, actor_id: str, no_restart: bool = True) -> dict:
        actor = self.actors.get(actor_id)
        if actor is None:
            return {"ok": False}
        await self._kill_actor_impl(actor, "ray_tpu_torch.kill()", no_restart=no_restart)
        return {"ok": True}

    async def _kill_actor_impl(self, actor: ActorInfo, cause: str, no_restart: bool = True) -> None:
        worker_addr = actor.worker_addr
        if no_restart:
            actor.state = "DEAD"
            actor.death_cause = cause
            actor.version += 1
            if actor.name:
                # durable un-delete guard: without this record a crash
                # before the next compaction would resurrect the
                # name→DEAD-actor mapping on WAL replay
                if self.named_actors.pop(
                        (actor.namespace, actor.name), None) is not None:
                    self._log("named_del", actor.namespace, actor.name)
            self._notify_actor(actor.actor_id)
        if worker_addr:
            try:
                worker = self._worker_client(tuple(worker_addr))
                await worker.acall("KillActor", actor_id=actor.actor_id, timeout=5)
            except Exception:
                pass
        if not no_restart:
            a = self.actors.get(actor.actor_id)
            if a:
                await self._handle_actor_failure(a, cause)

    # ------------------------------------------------------------------
    # Placement groups (2PC prepare/commit — node_manager.proto:514-519)
    # ------------------------------------------------------------------
    async def CreatePlacementGroup(
        self,
        pg_id: str,
        name: str,
        bundles: List[Dict[str, float]],
        strategy: str,
        creator_job: str = "",
    ) -> dict:
        if pg_id in self.placement_groups:
            return {"pg_id": pg_id}
        pg = PlacementGroupInfo(
            pg_id=pg_id,
            name=name,
            strategy=strategy,
            bundles=[dict(b) for b in bundles],
            state="PENDING",
            creator_job=creator_job,
        )
        self.placement_groups[pg_id] = pg
        self._log("pg", pg)
        asyncio.ensure_future(self._schedule_pg(pg))
        return {"pg_id": pg_id}

    def _plan_bundles(self, pg: PlacementGroupInfo) -> Optional[Dict[int, str]]:
        """Bin-pack bundles onto alive nodes per strategy (reference:
        bundle_scheduling_policy.h bundle pack/spread)."""
        alive = [n for n in self.nodes.values()
                 if n.alive and not n.draining]
        if not alive:
            return None
        # simulate available resources
        sim = {n.node_id: dict(n.available_resources) for n in alive}

        def fits(nid: str, b: Dict[str, float]) -> bool:
            return all(sim[nid].get(k, 0.0) >= v for k, v in b.items())

        def take(nid: str, b: Dict[str, float]) -> None:
            for k, v in b.items():
                sim[nid][k] = sim[nid].get(k, 0.0) - v

        plan: Dict[int, str] = {}
        order = list(range(len(pg.bundles)))
        if pg.strategy in ("PACK", "STRICT_PACK"):
            node_ids = [n.node_id for n in alive]
            for idx in order:
                b = pg.bundles[idx]
                placed = False
                # prefer nodes already used
                used = list(dict.fromkeys(plan.values()))
                for nid in used + [n for n in node_ids if n not in used]:
                    if fits(nid, b):
                        take(nid, b)
                        plan[idx] = nid
                        placed = True
                        break
                if not placed:
                    return None
            if pg.strategy == "STRICT_PACK" and len(set(plan.values())) > 1:
                return None
        else:  # SPREAD / STRICT_SPREAD
            node_ids = [n.node_id for n in alive]
            i = 0
            for idx in order:
                b = pg.bundles[idx]
                placed = False
                for attempt in range(len(node_ids)):
                    nid = node_ids[(i + attempt) % len(node_ids)]
                    if pg.strategy == "STRICT_SPREAD" and nid in plan.values():
                        continue
                    if fits(nid, b):
                        take(nid, b)
                        plan[idx] = nid
                        i += 1
                        placed = True
                        break
                if not placed:
                    return None
        return plan

    async def _schedule_pg(self, pg: PlacementGroupInfo) -> None:
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline and pg.state == "PENDING":
            plan = self._plan_bundles(pg)
            if plan is None:
                await asyncio.sleep(0.2)
                continue
            # 2PC: PREPARE on all nodes, then COMMIT (reference:
            # PrepareBundleResources / CommitBundleResources)
            prepared: List[Tuple[str, int]] = []
            ok = True
            for idx, nid in plan.items():
                try:
                    r = await self._raylet(nid).acall(
                        "PrepareBundle",
                        pg_id=pg.pg_id,
                        bundle_index=idx,
                        resources=pg.bundles[idx],
                    )
                    if not r.get("ok"):
                        ok = False
                        break
                    prepared.append((nid, idx))
                except Exception:
                    ok = False
                    break
            if not ok:
                for nid, idx in prepared:
                    try:
                        await self._raylet(nid).acall("CancelBundle", pg_id=pg.pg_id, bundle_index=idx)
                    except Exception:
                        pass
                await asyncio.sleep(0.2)
                continue
            for idx, nid in plan.items():
                await self._raylet(nid).acall("CommitBundle", pg_id=pg.pg_id, bundle_index=idx)
            pg.bundle_nodes = plan
            pg.state = "CREATED"
            self._log("pg", pg)
            logger.info("placement group %s created: %s", pg.pg_id[:12], {i: n[:8] for i, n in plan.items()})
            return
        if pg.state == "PENDING":
            pg.state = "INFEASIBLE"

    async def GetPlacementGroup(self, pg_id: str) -> Optional[dict]:
        pg = self.placement_groups.get(pg_id)
        if pg is None:
            return None
        return {
            "pg_id": pg.pg_id,
            "name": pg.name,
            "state": pg.state,
            "strategy": pg.strategy,
            "bundles": pg.bundles,
            "bundle_nodes": dict(pg.bundle_nodes),
        }

    async def RemovePlacementGroup(self, pg_id: str) -> dict:
        pg = self.placement_groups.get(pg_id)
        if pg is None:
            return {"ok": False}
        for idx, nid in pg.bundle_nodes.items():
            try:
                await self._raylet(nid).acall("ReleaseBundle", pg_id=pg_id, bundle_index=idx)
            except Exception:
                pass
        pg.state = "REMOVED"
        pg.bundle_nodes = {}
        self._log("pg", pg)  # after the clear: replay must not
        # resurrect stale bundle->node assignments
        return {"ok": True}

    # ------------------------------------------------------------------
    # Observability: metrics aggregation + Prometheus endpoint, task
    # events, log buffering (reference: src/ray/stats/metric.h:104,
    # GcsTaskManager task-event history, _private/log_monitor.py)
    # ------------------------------------------------------------------
    async def ReportMetrics(self, producer: str, metrics: List[dict]) -> dict:
        now = time.monotonic()
        self.metrics_by_producer[producer] = (metrics, now)
        # evict dead producers here too (not only at scrape time) so the
        # table stays bounded on clusters nobody scrapes
        if len(self.metrics_by_producer) % 16 == 0:
            self.metrics_by_producer = {
                p: (m, ts) for p, (m, ts) in self.metrics_by_producer.items()
                if now - ts < 30.0
            }
        return {"ok": True}

    async def ReportTaskEvents(self, events: List[dict]) -> dict:
        self.task_events.extend(events)
        return {"ok": True}

    async def ListTaskEvents(self, job_id: Optional[str] = None,
                             limit: int = 1000) -> List[dict]:
        out = [
            e for e in self.task_events
            if job_id is None or e.get("job_id") == job_id
        ]
        return out[-limit:]

    # -- event bus + tracing (observability/: workers push typed-event
    # batches; spans are indexed per job for GetTrace) ------------------
    async def ReportClusterEvents(self, events: List[dict],
                                  clock: Optional[dict] = None) -> dict:
        self.cluster_events.add(events, clock=clock)
        return {"ok": True}

    # -- lifecycle timelines (observability/timeline.py analysis over
    # the aggregator's actor/task phase marks) --------------------------
    async def ActorTimeline(self, actor_id: str) -> dict:
        return self.cluster_events.actor_timeline(actor_id)

    async def LifecycleSummary(self, job_id: Optional[str] = None,
                               wall_s: Optional[float] = None,
                               etype: str = "actor_lifecycle") -> dict:
        return self.cluster_events.lifecycle_summary(
            job_id=job_id, wall_s=wall_s, etype=etype)

    # -- flight-recorder dumps (observability/dump.py) ------------------
    def _sample_control_plane_counters(self) -> None:
        """Counter-track samples for debug dumps: queue depths the
        postmortem trace shows next to the event timeline."""
        from ray_tpu_torch.observability import dump as obs_dump

        pending = sum(1 for a in self.actors.values()
                      if a.state in ("PENDING", "RESTARTING"))
        obs_dump.counter_sample("gcs_pending_actors", pending)
        obs_dump.counter_sample(
            "gcs_alive_nodes",
            sum(1 for n in self.nodes.values() if n.alive))

    def _debug_dump_fanout(self, reason: str, **info: Any) -> None:
        """Persist the GCS's own black box and ask every reachable
        process (raylets, job drivers, a capped set of actor workers)
        to do the same — fire-and-forget, rate-limited."""
        from ray_tpu_torch.observability import dump as obs_dump

        now = time.monotonic()
        if now - self._last_fanout_dump < 5.0:
            obs_dump.dump_now(reason, extra=info or None)
            return
        self._last_fanout_dump = now
        obs_dump.dump_now(reason, extra=dict(
            info, gcs={"actors": len(self.actors),
                       "pending_actors": sum(
                           1 for a in self.actors.values()
                           if a.state in ("PENDING", "RESTARTING")),
                       "nodes": len(self.nodes)}))
        targets: List[Tuple[str, Any]] = []
        for node in self.nodes.values():
            if node.alive:
                try:
                    targets.append((f"raylet:{node.node_id[:12]}",
                                    self._raylet(node.node_id)))
                except Exception:  # noqa: BLE001 — unreachable raylet
                    pass
        for job in self.jobs.values():
            if job.get("state") == "RUNNING" and job.get("driver_addr"):
                try:
                    targets.append((f"driver:{job['job_id'][:12]}",
                                    self._worker_client(
                                        tuple(job["driver_addr"]))))
                except Exception:  # noqa: BLE001
                    pass
        seen_addrs = set()
        for actor in self.actors.values():
            if len(seen_addrs) >= 32:
                break  # cap the worker fan-out; rings are per PROCESS
            if actor.state == "ALIVE" and actor.worker_addr and \
                    tuple(actor.worker_addr) not in seen_addrs:
                seen_addrs.add(tuple(actor.worker_addr))
                try:
                    targets.append((f"worker:{actor.actor_id[:12]}",
                                    self._worker_client(
                                        tuple(actor.worker_addr))))
                except Exception:  # noqa: BLE001
                    pass

        async def _fan() -> None:
            for name, client in targets:
                try:
                    await client.acall("DebugDump", reason=reason,
                                       info=info, timeout=5)
                except Exception:  # noqa: BLE001 — best-effort postmortem
                    logger.debug("debug dump to %s failed", name)

        asyncio.ensure_future(_fan())

    async def TriggerDebugDump(self, reason: str,
                               info: Optional[dict] = None) -> dict:
        """Any process that hit a typed failure asks the GCS to fan the
        cluster-wide dump out (see observability/dump.py)."""
        self._debug_dump_fanout(reason, **(info or {}))
        return {"ok": True}

    async def ListClusterEvents(self, etype: Optional[str] = None,
                                job_id: Optional[str] = None,
                                limit: int = 1000) -> List[dict]:
        return self.cluster_events.list_events(etype=etype, job_id=job_id,
                                               limit=limit)

    async def GetTrace(self, job_id: str) -> dict:
        return self.cluster_events.get_trace(job_id)

    async def ReportNodeStats(self, node_id: str, stats: dict) -> dict:
        """Per-node reporter samples from the dashboard agents
        (reference: dashboard/agent.py reporter module)."""
        self.cluster_events.set_node_stats(node_id, stats)
        return {"ok": True}

    async def ListNodeStats(self) -> List[dict]:
        return self.cluster_events.list_node_stats()

    async def PublishLogs(self, node_id: str, worker_id: str,
                          lines: List[str]) -> dict:
        for ln in lines:
            self._log_seq += 1
            self.log_buffer.append((self._log_seq, node_id, worker_id, ln))
        return {"ok": True}

    async def GetLogs(self, after_seq: int = 0, limit: int = 1000) -> dict:
        """Worker log lines are cluster-wide (not scoped per job — worker
        processes serve any job; the reference's per-job log routing is a
        deliberate simplification here)."""
        lines = [e for e in self.log_buffer if e[0] > after_seq][:limit]
        next_seq = lines[-1][0] if lines else after_seq
        return {"lines": lines, "next_seq": next_seq, "latest_seq": self._log_seq}

    async def GetMetricsEndpoint(self) -> dict:
        return {"host": "127.0.0.1", "port": self.metrics_http_port}

    # ------------------------------------------------------------------
    # Pubsub (reference: src/ray/pubsub/ — long-poll Publisher
    # publisher.h:357 / Subscriber subscriber.h:215). Channels carry
    # actor-state and node-state changes plus user events; this replaces
    # per-entity polling on the subscriber side.
    # ------------------------------------------------------------------
    def _pubsub_cv(self):
        import asyncio as _a

        if self._pubsub_waiters is None:
            self._pubsub_waiters = _a.Condition()
        return self._pubsub_waiters

    async def Publish(self, channel: str, key: str, payload: Any = None) -> dict:
        self._publish(channel, key, payload)
        cv = self._pubsub_cv()
        async with cv:
            cv.notify_all()
        return {"seq": self._pubsub_seq}

    def _publish(self, channel: str, key: str, payload: Any = None) -> None:
        from collections import deque as _dq

        self._pubsub_seq += 1
        q = self.pubsub.setdefault(channel, _dq(maxlen=10000))
        if q.maxlen is not None and len(q) == q.maxlen:
            # the append below evicts q[0]: remember its seq as the
            # channel's dropped floor for gap detection in Subscribe
            self.pubsub_dropped[channel] = q[0][0]
        q.append((self._pubsub_seq, key, payload))

    def _publish_and_wake(self, channel: str, key: str, payload: Any = None) -> None:
        self._publish(channel, key, payload)
        cv = self._pubsub_waiters
        if cv is not None:
            async def _wake():
                async with cv:
                    cv.notify_all()

            asyncio.ensure_future(_wake())

    async def Subscribe(self, channel: str, after_seq: int = 0,
                        timeout_s: float = 20.0) -> dict:
        """Long-poll: return events with seq > after_seq; block until one
        arrives or the timeout lapses."""
        deadline = time.monotonic() + timeout_s
        cv = self._pubsub_cv()
        # Predicate check and wait both under the condition lock — a
        # publish firing between an unlocked check and cv.wait() would
        # otherwise be a lost wakeup (delivery delayed a full timeout).
        async with cv:
            while True:
                q = self.pubsub.get(channel)
                floor = self.pubsub_dropped.get(channel, 0)
                events = [e for e in (q or ()) if e[0] > after_seq]
                if events:
                    return {"events": events, "next_seq": events[-1][0],
                            "dropped_floor": floor}
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return {"events": [], "next_seq": after_seq,
                            "dropped_floor": floor}
                try:
                    await asyncio.wait_for(cv.wait(), timeout=remaining)
                except asyncio.TimeoutError:
                    pass

    def _prometheus_text(self) -> str:
        """Aggregated user metrics + built-in cluster gauges, Prometheus
        text exposition format."""
        out: List[str] = []

        def emit(name, mtype, desc, series_fn):
            out.append(f"# HELP {name} {desc}")
            out.append(f"# TYPE {name} {mtype}")
            out.extend(series_fn())

        def esc(v: str) -> str:
            return (str(v).replace("\\", "\\\\").replace('"', '\\"')
                    .replace("\n", "\\n"))

        def fmt_tags(tags: Dict[str, str], extra: str = "") -> str:
            items = [f'{k}="{esc(v)}"' for k, v in sorted(tags.items())]
            if extra:
                items.append(extra)
            return "{" + ",".join(items) + "}" if items else ""

        # built-ins
        alive = sum(1 for n in self.nodes.values() if n.alive)
        emit("ray_tpu_nodes_alive", "gauge", "Alive nodes",
             lambda: [f"ray_tpu_nodes_alive {alive}"])
        by_state: Dict[str, int] = {}
        for a in self.actors.values():
            by_state[a.state] = by_state.get(a.state, 0) + 1
        emit("ray_tpu_actors", "gauge", "Actors by state", lambda: [
            f'ray_tpu_actors{{state="{s}"}} {c}' for s, c in sorted(by_state.items())
        ])
        ev_state: Dict[str, int] = {}
        for e in self.task_events:
            ev_state[e.get("state", "?")] = ev_state.get(e.get("state", "?"), 0) + 1
        emit("ray_tpu_task_events_total", "counter", "Task events seen", lambda: [
            f'ray_tpu_task_events_total{{state="{s}"}} {c}'
            for s, c in sorted(ev_state.items())
        ])

        # user metrics, merged across producers; producers gone silent for
        # 30s (dead workers) are evicted so the endpoint stays bounded
        now = time.monotonic()
        self.metrics_by_producer = {
            p: (m, ts) for p, (m, ts) in self.metrics_by_producer.items()
            if now - ts < 30.0
        }
        merged: Dict[str, dict] = {}
        for producer, (metrics, _ts) in self.metrics_by_producer.items():
            for m in metrics:
                ent = merged.setdefault(
                    m["name"],
                    {"type": m["type"], "description": m.get("description", ""),
                     "bounds": m.get("bounds"), "series": {}},
                )
                if ent["type"] == "histogram" and m.get("bounds") != ent["bounds"]:
                    continue  # mismatched boundaries can't be merged
                for s in m.get("series", []):
                    key = tuple(sorted(s["tags"].items()))
                    if ent["type"] == "histogram":
                        agg = ent["series"].setdefault(
                            key, {"buckets": [0] * (len(ent["bounds"]) + 1),
                                  "sum": 0.0, "count": 0})
                        agg["buckets"] = [
                            a + b for a, b in zip(agg["buckets"], s["buckets"])
                        ]
                        agg["sum"] += s["sum"]
                        agg["count"] += s["count"]
                    elif ent["type"] == "counter":
                        agg = ent["series"].setdefault(key, {"value": 0.0})
                        agg["value"] += s["value"]
                    else:  # gauge: last writer wins
                        ent["series"][key] = {"value": s["value"]}
        for name, ent in sorted(merged.items()):
            if ent["type"] == "histogram":
                def lines(ent=ent, name=name):
                    ls = []
                    for key, s in ent["series"].items():
                        tags = dict(key)
                        cum = 0
                        for bound, cnt in zip(ent["bounds"], s["buckets"]):
                            cum += cnt
                            le = 'le="%s"' % bound
                            ls.append(
                                f"{name}_bucket{fmt_tags(tags, le)} {cum}"
                            )
                        inf = 'le="+Inf"'
                        ls.append(
                            f"{name}_bucket{fmt_tags(tags, inf)} {s['count']}"
                        )
                        ls.append(f"{name}_sum{fmt_tags(tags)} {s['sum']}")
                        ls.append(f"{name}_count{fmt_tags(tags)} {s['count']}")
                    return ls
            else:
                def lines(ent=ent, name=name):
                    return [
                        f"{name}{fmt_tags(dict(key))} {s['value']}"
                        for key, s in ent["series"].items()
                    ]
            emit(name, ent["type"], ent["description"], lines)
        return "\n".join(out) + "\n"

    async def _serve_metrics_http(self) -> None:
        """Tiny HTTP/1.0 responder: any GET returns the Prometheus text
        (reference: the dashboard agent's Prometheus scrape endpoint)."""

        async def on_client(reader, writer):
            try:
                await reader.readline()  # request line; drain headers
                while True:
                    line = await reader.readline()
                    if line in (b"\r\n", b"\n", b""):
                        break
                body = self._prometheus_text().encode()
                writer.write(
                    b"HTTP/1.0 200 OK\r\n"
                    b"Content-Type: text/plain; version=0.0.4\r\n"
                    + f"Content-Length: {len(body)}\r\n\r\n".encode() + body
                )
                await writer.drain()
            except Exception:  # noqa: BLE001
                pass
            finally:
                try:
                    writer.close()
                except Exception:  # noqa: BLE001
                    pass

        server = await asyncio.start_server(on_client, "127.0.0.1", 0)
        self.metrics_http_port = server.sockets[0].getsockname()[1]
        logger.info("metrics endpoint on :%d", self.metrics_http_port)

    async def Ping(self) -> str:
        return "pong"

    async def run(self) -> None:
        asyncio.ensure_future(self._health_check_loop())
        asyncio.ensure_future(self._flush_loop())
        if self._needs_replay_reschedule:
            asyncio.ensure_future(self._reschedule_replayed())
        await self._serve_metrics_http()
        await self.server.serve_forever()


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--port", type=int, required=True)  # 0: the system picks
    parser.add_argument("--port-file", default="")  # written once listening
    parser.add_argument("--storage-path", default="")
    parser.add_argument("--log-level", default="INFO")
    args = parser.parse_args()
    logging.basicConfig(level=args.log_level, format="[gcs] %(levelname)s %(message)s")
    server = GcsServer(args.port, args.storage_path)
    import atexit

    atexit.register(server._flush)

    async def _run():
        task = asyncio.ensure_future(server.run())
        while server.server._server is None and not task.done():  # not bound yet
            await asyncio.sleep(0.01)
        if args.port_file and not task.done():
            tmp = args.port_file + ".tmp"
            with open(tmp, "w") as f:
                f.write(str(server.server.port))
            os.replace(tmp, args.port_file)
        await task

    try:
        asyncio.run(_run())
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
