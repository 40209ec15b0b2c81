"""Autoscaler v2-style reconciler (PyTorch port of
ray_tpu/autoscaler/autoscaler.py; reference:
python/ray/autoscaler/v2/autoscaler.py + scheduler.py).

One reconcile step:
1. read demand from the GCS (queued lease shapes per node + pending
   actors — `GetClusterDemand`, fed by raylet heartbeats),
2. simulate packing that demand onto the live nodes' available
   resources (first-fit decreasing),
3. bin-pack the unmet remainder onto hypothetical nodes of the
   configured types → launch decisions, bounded by max_workers,
4. terminate nodes idle longer than ``idle_timeout_s`` (never the head,
   never below min_workers).

Slices are atomic: a node type with ``slice_hosts > 1`` launches
that many host nodes per unit (all sharing a ``slice_id`` label) and is
only ever terminated whole — one busy host pins the entire slice
(SURVEY.md §7 'slice-granular gang scheduling'). The decision is
resource-name agnostic: ``{"GPU": n}`` shapes pack as ``{"TPU": n}`` do.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
import uuid
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.autoscaler.node_provider import NodeProvider

logger = logging.getLogger("ray_tpu_torch.autoscaler")


@dataclasses.dataclass
class NodeTypeConfig:
    """Reference: available_node_types in the cluster YAML
    (autoscaler/_private/util.py)."""

    resources: Dict[str, float]
    min_workers: int = 0
    max_workers: int = 10
    slice_hosts: int = 1  # >1 = a multi-host slice: launch/terminate atomically
    node_config: Dict = dataclasses.field(default_factory=dict)


def _fits(shape: Dict[str, float], avail: Dict[str, float]) -> bool:
    return all(avail.get(k, 0.0) >= v for k, v in shape.items() if v > 0)


def _subtract(avail: Dict[str, float], shape: Dict[str, float]) -> None:
    for k, v in shape.items():
        if v > 0:
            avail[k] = avail.get(k, 0.0) - v


def compute_scaling_decision(
    demand: dict,
    node_types: Dict[str, NodeTypeConfig],
    type_counts: Dict[str, int],
    idle_timeout_s: float = 60.0,
    node_slices: Optional[Dict[str, str]] = None,
    node_type_map: Optional[Dict[str, str]] = None,
    booting: Optional[Dict[str, int]] = None,
) -> Tuple[Dict[str, int], List[str]]:
    """Pure decision function (unit-testable without a cluster).

    demand: GetClusterDemand reply. type_counts: live worker count per
    node type (in slice units for slice types). node_slices: node_id →
    slice_id for slice-grouped termination. node_type_map: node_id →
    node type, used to hold min_workers through idle termination.
    booting: units per type already launched but not yet registered in
    the GCS — their capacity is credited so each reconcile round doesn't
    re-launch for the same demand (reference: the v2 instance manager
    tracks pending instances).
    Returns (launch: {type: units}, terminate: [node_ids]).
    """
    node_slices = node_slices or {}
    node_type_map = node_type_map or {}
    booting = booting or {}
    # DRAINING nodes are on their way out: their capacity must not
    # absorb simulated demand (it would under-launch), and they are
    # never idle-termination candidates (already terminating)
    nodes = [n for n in demand.get("nodes", [])
             if n.get("alive") and not n.get("draining")]
    shapes: List[Dict[str, float]] = []
    for n in nodes:
        shapes.extend(n.get("pending_shapes", []))
    shapes.extend(demand.get("pending_actors", []))
    # drop zero/empty shapes; first-fit decreasing by total magnitude
    shapes = [s for s in shapes if any(v > 0 for v in s.values())]
    shapes.sort(key=lambda s: -sum(s.values()))

    # 1) what the live cluster can already absorb
    avails = [dict(n["available"]) for n in nodes]
    unmet: List[Dict[str, float]] = []
    for s in shapes:
        for a in avails:
            if _fits(s, a):
                _subtract(a, s)
                break
        else:
            unmet.append(s)

    # 2) pack the unmet remainder onto hypothetical new nodes; nodes
    # still booting count as capacity first
    launch: Dict[str, int] = {}
    pending_avails: List[Dict[str, float]] = []
    for tname, units in booting.items():
        tc = node_types.get(tname)
        if tc is None:
            continue
        for _ in range(units * tc.slice_hosts):
            pending_avails.append(dict(tc.resources))
    for s in unmet:
        placed = False
        for a in pending_avails:
            if _fits(s, a):
                _subtract(a, s)
                placed = True
                break
        if placed:
            continue
        # smallest type that fits the shape (deterministic order)
        for tname in sorted(
                node_types, key=lambda t: sum(node_types[t].resources.values())):
            tc = node_types[tname]
            if not _fits(s, dict(tc.resources)):
                continue
            if type_counts.get(tname, 0) + launch.get(tname, 0) \
                    >= tc.max_workers:
                continue
            launch[tname] = launch.get(tname, 0) + 1
            # a slice launch adds slice_hosts nodes' worth of capacity
            for _ in range(tc.slice_hosts):
                a = dict(tc.resources)
                pending_avails.append(a)
            _subtract(pending_avails[-tc.slice_hosts], s)
            placed = True
            break
        if not placed:
            logger.warning("demand shape %s is infeasible on all node types", s)

    # 3) honor min_workers
    for tname, tc in node_types.items():
        have = type_counts.get(tname, 0) + launch.get(tname, 0)
        if have < tc.min_workers:
            launch[tname] = launch.get(tname, 0) + (tc.min_workers - have)

    # 4) idle termination — whole slices only, never the head, never
    # below min_workers; never while unmet demand exists (a just-launched
    # node can look idle for a beat before queued leases reach it —
    # terminating it then flaps)
    terminate: List[str] = []
    if unmet or launch:
        return launch, terminate
    # remaining (post-termination) count per type, for min_workers holds
    remaining: Dict[str, int] = dict(type_counts)

    def _may_remove(tname: Optional[str], units: int = 1) -> bool:
        if tname is None or tname not in node_types:
            return True
        if remaining.get(tname, 0) - units < node_types[tname].min_workers:
            return False
        remaining[tname] = remaining.get(tname, 0) - units
        return True

    by_slice: Dict[str, List[dict]] = {}
    solo: List[dict] = []
    for n in nodes:
        if n.get("is_head"):
            continue
        sid = node_slices.get(n["node_id"])
        if sid:
            by_slice.setdefault(sid, []).append(n)
        else:
            solo.append(n)
    for n in solo:
        if n.get("idle_s", 0.0) > idle_timeout_s and \
                _may_remove(node_type_map.get(n["node_id"])):
            terminate.append(n["node_id"])
    for sid, members in by_slice.items():
        if all(m.get("idle_s", 0.0) > idle_timeout_s for m in members) and \
                _may_remove(node_type_map.get(members[0]["node_id"])):
            terminate.extend(m["node_id"] for m in members)
    return launch, terminate


class Autoscaler:
    """Reconcile loop binding the decision function to a provider and a
    live GCS (reference: autoscaler/v2/autoscaler.py)."""

    def __init__(
        self,
        gcs_addr: Tuple[str, int],
        node_types: Dict[str, NodeTypeConfig],
        provider: NodeProvider,
        idle_timeout_s: float = 60.0,
        interval_s: float = 5.0,
    ):
        from ray_tpu_torch._private.rpc import RpcClient

        self.gcs = RpcClient(*gcs_addr)
        self.node_types = dict(node_types)
        self.provider = provider
        self.idle_timeout_s = idle_timeout_s
        self.interval_s = interval_s
        # provider_node_id -> (node_type, slice_id)
        self._launched: Dict[str, Tuple[str, str]] = {}
        self._launch_times: Dict[str, float] = {}
        self.boot_grace_s = 120.0  # credit booting nodes this long
        # graceful-drain deadline for idle terminations (idle nodes hold
        # no leases; the drain is just the deregister handshake)
        self.drain_deadline_s = 5.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.num_launches = 0
        self.num_terminations = 0
        # flip lease semantics cluster-wide: infeasible requests queue as
        # demand instead of failing (propagates via heartbeat replies)
        try:
            self.gcs.call("SetAutoscalerEnabled", enabled=True, timeout=10)
        except Exception:  # noqa: BLE001
            logger.warning("could not announce autoscaler to GCS")

    # -- one reconcile step -------------------------------------------
    def update(self) -> Tuple[Dict[str, int], List[str]]:
        # renew the TTL lease each round: survives a GCS restart losing
        # the flag, and expires if this autoscaler dies
        try:
            self.gcs.call("SetAutoscalerEnabled", enabled=True,
                          ttl_s=max(30.0, 3 * self.interval_s), timeout=5)
        except Exception:  # noqa: BLE001
            pass
        demand = self.gcs.call("GetClusterDemand", timeout=10)
        live = self.provider.non_terminated_nodes()
        self._launched = {nid: meta for nid, meta in self._launched.items()
                          if nid in live}
        self._launch_times = {nid: t for nid, t in self._launch_times.items()
                              if nid in self._launched}
        type_counts: Dict[str, int] = {}
        slice_units: Dict[str, set] = {}
        for nid, (tname, sid) in self._launched.items():
            tc = self.node_types.get(tname)
            if tc and tc.slice_hosts > 1:
                slice_units.setdefault(tname, set()).add(sid)
            else:
                type_counts[tname] = type_counts.get(tname, 0) + 1
        for tname, sids in slice_units.items():
            type_counts[tname] = len(sids)
        # map GCS nodes to slice/type via the labels the launch stamped —
        # provider node ids (e.g. GCE VM names) need not equal raylet
        # node ids, labels are the join key
        gcs_nodes = {n["node_id"]: n for n in demand.get("nodes", [])}
        node_slices = {
            nid: n["labels"]["slice_id"]
            for nid, n in gcs_nodes.items()
            if n.get("labels", {}).get("slice_id")
        }
        node_type_map = {
            nid: n["labels"]["node_type"]
            for nid, n in gcs_nodes.items()
            if n.get("labels", {}).get("node_type")
        }
        # nodes we launched that haven't registered in the GCS yet count
        # as booting capacity (until a grace period expires — a node that
        # never comes up stops blocking launches)
        now = time.monotonic()
        booting: Dict[str, int] = {}
        booting_sids: Dict[str, set] = {}
        for nid, (tname, sid) in self._launched.items():
            if nid in gcs_nodes:
                continue
            if now - self._launch_times.get(nid, 0.0) > self.boot_grace_s:
                continue
            tc = self.node_types.get(tname)
            if tc and tc.slice_hosts > 1:
                booting_sids.setdefault(tname, set()).add(sid)
            else:
                booting[tname] = booting.get(tname, 0) + 1
        for tname, sids in booting_sids.items():
            booting[tname] = booting.get(tname, 0) + len(sids)
        launch, terminate = compute_scaling_decision(
            demand, self.node_types, type_counts,
            idle_timeout_s=self.idle_timeout_s, node_slices=node_slices,
            node_type_map=node_type_map, booting=booting)
        for tname, units in launch.items():
            tc = self.node_types[tname]
            for _ in range(units):
                sid = uuid.uuid4().hex[:8]
                cfg = dict(tc.node_config, resources=dict(tc.resources),
                           slice_hosts=tc.slice_hosts)
                ids = self.provider.create_node(
                    tname, cfg, labels={"node_type": tname, "slice_id": sid})
                for nid in ids:
                    self._launched[nid] = (tname, sid)
                    self._launch_times[nid] = time.monotonic()
                self.num_launches += 1
                logger.info("launched %s x1 (%d hosts): %s",
                            tname, len(ids), ids)
        killed: set = set()
        killed_sids: set = set()
        for nid in terminate:
            # resolve the GCS node to provider node(s): direct id match
            # (LocalNodeProvider) or via the slice_id label (cloud
            # providers whose ids are VM names)
            sid = gcs_nodes.get(nid, {}).get("labels", {}).get("slice_id")
            if nid in self._launched:
                pids = [nid]
            else:
                pids = [p for p, (_t, s) in self._launched.items()
                        if sid and s == sid]
            pids = [p for p in pids if p not in killed]
            if not pids and not (sid and sid in killed_sids):
                continue  # not ours (e.g. manually added node)
            # gracefully drain EVERY GCS member of a terminated slice,
            # including those whose provider host was already destroyed
            # by an earlier iteration — otherwise the cluster view keeps
            # spilling leases to a dead host until heartbeat timeout.
            # Idle nodes quiesce in seconds; the short deadline bounds
            # the window before the provider hard-terminates below.
            try:
                from ray_tpu_torch._private.drain import REASON_IDLE_TERMINATION

                self.gcs.call("DrainNode", node_id=nid,
                              reason=REASON_IDLE_TERMINATION,
                              deadline_s=self.drain_deadline_s, timeout=5)
            except Exception:  # noqa: BLE001
                pass
            if sid:
                killed_sids.add(sid)
            for pid in pids:
                self.provider.terminate_node(pid)
                self._launched.pop(pid, None)
                self._launch_times.pop(pid, None)
                killed.add(pid)
                self.num_terminations += 1
                logger.info("terminated idle node %s", str(pid)[:12])
        return launch, terminate

    # -- background loop ----------------------------------------------
    def start(self) -> None:
        def _loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.update()
                except Exception:  # noqa: BLE001
                    logger.exception("autoscaler update failed")

        self._thread = threading.Thread(target=_loop, daemon=True,
                                        name="ray-tpu-torch-autoscaler")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        try:
            self.gcs.call("SetAutoscalerEnabled", enabled=False, timeout=5)
        except Exception:  # noqa: BLE001
            pass
