"""In-process multi-node test cluster (PyTorch port of
ray_tpu/cluster_utils.py).

Reference: python/ray/cluster_utils.py (Cluster :141, add_node :208) — starts
one GCS plus N raylet daemons (each with its own shared-memory store and
worker pool) as local processes, so multi-node scheduling, object transfer
and fault-tolerance are testable on a single machine.

Cards: ``add_node(num_gpus=n)`` gives the node n of the host's cards that
no live node of the cluster owns (the lowest free ids), and its raylet
leases those ids, so a lease's ``CUDA_VISIBLE_DEVICES`` names the physical
card it got and no card is leased by two nodes. Asking for more cards
than the host has left raises. The host's cards are
``RAY_TPU_FAKE_GPUS`` when set, else ``torch.cuda.device_count()``.

Usage:
    cluster = Cluster()
    cluster.add_node(num_cpus=2, num_gpus=1)  # head node, card 0
    n2 = cluster.add_node(num_cpus=2, resources={"worker2": 1})
    ray_tpu_torch.init(address=cluster.address)
    ...
    cluster.remove_node(n2)                   # simulates node failure
    cluster.shutdown()
"""

from __future__ import annotations

import json
import os
import subprocess
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._private.config import config
from ray_tpu_torch._private.ids import NodeID
from ray_tpu_torch._private.node import kill_process_tree, spawn_gcs, spawn_raylet
from ray_tpu_torch._private.rpc import RpcClient


@dataclass
class ClusterNode:
    node_id: str
    proc: subprocess.Popen
    raylet_port: int
    store_socket: str
    session_dir: str
    resources: Dict[str, float] = field(default_factory=dict)
    is_head: bool = False
    gpu_ids: List[int] = field(default_factory=list)

    @property
    def raylet_addr(self) -> Tuple[str, int]:
        return ("127.0.0.1", self.raylet_port)


def host_gpu_count() -> int:
    """The host's cards, as the NVIDIA accelerator manager counts them
    (``RAY_TPU_FAKE_GPUS`` first)."""
    from ray_tpu_torch.accelerators.gpu import NvidiaGPUAcceleratorManager

    return NvidiaGPUAcceleratorManager.get_current_node_num_accelerators()


class Cluster:
    """One GCS + N raylets on this machine, each raylet a real daemon
    process owning its own object store and workers."""

    def __init__(self, gcs_storage: bool = False):
        """gcs_storage=True enables file-backed GCS persistence so
        ``restart_gcs()`` replays state (reference: GCS fault tolerance
        over Redis, gcs_init_data.h)."""
        self.session_dir = tempfile.mkdtemp(prefix="ray_tpu_torch_cluster_")
        self.gcs_proc: Optional[subprocess.Popen] = None
        self.gcs_port: Optional[int] = None
        self.nodes: List[ClusterNode] = []
        self.gcs_storage_path = (
            os.path.join(self.session_dir, "gcs_state.bin")
            if gcs_storage else "")
        self._start_gcs()

    # ------------------------------------------------------------------
    @property
    def address(self) -> str:
        return f"127.0.0.1:{self.gcs_port}"

    @property
    def gcs_addr(self) -> Tuple[str, int]:
        return ("127.0.0.1", self.gcs_port)

    def _start_gcs(self) -> None:
        """The GCS on its port (a restart's), or on one the GCS picks."""
        old = config.gcs_storage_path
        try:
            if self.gcs_storage_path:
                config.from_json(json.dumps({"gcs_storage_path": self.gcs_storage_path}))
            self.gcs_proc, self.gcs_port = spawn_gcs(self.gcs_port or 0, self.session_dir)
        finally:
            config.from_json(json.dumps({"gcs_storage_path": old}))

    def kill_gcs(self) -> None:
        """Kill the GCS process (simulating a control-plane crash)."""
        if self.gcs_proc is not None:
            kill_process_tree(self.gcs_proc, force=True)
            self.gcs_proc = None

    def restart_gcs(self) -> None:
        """Restart the GCS on the SAME port; with gcs_storage it replays
        its persisted tables and raylets re-register via heartbeats."""
        self.kill_gcs()
        self._start_gcs()

    # ------------------------------------------------------------------
    def free_gpu_ids(self) -> List[int]:
        """The host's card ids that no node of this cluster owns."""
        owned = {i for n in self.nodes for i in n.gpu_ids}
        return [i for i in range(host_gpu_count()) if i not in owned]

    def add_node(
        self,
        num_cpus: float = 1.0,
        num_gpus: Optional[int] = None,
        resources: Optional[Dict[str, float]] = None,
        object_store_memory: Optional[int] = None,
        labels: Optional[Dict[str, str]] = None,
    ) -> ClusterNode:
        """Start a raylet with these resources. ``num_gpus`` cards are
        taken from the host's free ones (``free_gpu_ids``); more than are
        free raises ValueError, and so does a fraction of a card."""
        gpu_ids: List[int] = []
        if num_gpus:
            if int(num_gpus) != num_gpus or num_gpus < 0:
                raise ValueError(f"num_gpus={num_gpus}: a node owns whole cards")
            free = self.free_gpu_ids()
            if num_gpus > len(free):
                raise ValueError(
                    f"add_node(num_gpus={num_gpus}): the host has {host_gpu_count()} "
                    f"cards and {len(free)} are free ({free})")
            gpu_ids = free[:int(num_gpus)]
        node_id = NodeID.from_random().hex()
        node_dir = os.path.join(self.session_dir, f"node-{len(self.nodes)}-{node_id[:8]}")
        os.makedirs(node_dir, exist_ok=True)
        store_socket = os.path.join(node_dir, "store.sock")
        res: Dict[str, float] = dict(resources or {})
        res["CPU"] = float(num_cpus)
        if gpu_ids:
            res["GPU"] = float(len(gpu_ids))
        res.setdefault("memory", 1 * 1024**3)
        res["node:127.0.0.1"] = 1.0
        is_head = not self.nodes
        proc, port = spawn_raylet(
            gcs_addr=self.gcs_addr,
            node_id=node_id,
            resources=res,
            store_socket=store_socket,
            store_capacity=int(object_store_memory or config.object_store_memory_bytes),
            session_dir=node_dir,
            is_head=is_head,
            labels=labels,
            gpu_ids=gpu_ids,
        )
        node = ClusterNode(
            node_id=node_id,
            proc=proc,
            raylet_port=port,
            store_socket=store_socket,
            session_dir=node_dir,
            resources=res,
            is_head=is_head,
            gpu_ids=gpu_ids,
        )
        self.nodes.append(node)
        return node

    def remove_node(self, node: ClusterNode, allow_graceful: bool = False,
                    drain_deadline_s: float = 5.0) -> None:
        """Kill a node's raylet (and its store + workers), simulating node
        failure. ``allow_graceful`` runs the full drain protocol first
        (_private/drain.py): the node stops taking leases, in-flight work
        finishes or migrates, and the raylet deregisters and exits on its
        own — the kill below is only the backstop. Without it the GCS
        notices via missed heartbeats, as for a crash. The node's cards
        go back to the host's free ones."""
        if allow_graceful:
            from ray_tpu_torch._private.drain import REASON_IDLE_TERMINATION

            client = RpcClient("127.0.0.1", self.gcs_port)
            try:
                client.call(
                    "DrainNode", node_id=node.node_id,
                    reason=REASON_IDLE_TERMINATION,
                    deadline_s=drain_deadline_s, timeout=5,
                )
                deadline = time.monotonic() + drain_deadline_s + 3.0
                while time.monotonic() < deadline:
                    if node.proc.poll() is not None:
                        break
                    time.sleep(0.05)
            except Exception:  # noqa: BLE001
                pass  # the kill below is the backstop
            finally:
                client.close()
        kill_process_tree(node.proc, force=not allow_graceful)
        if node in self.nodes:
            self.nodes.remove(node)

    def wait_for_nodes(self, timeout: float = 30.0) -> None:
        """Block until every added node is registered and alive in the GCS."""
        client = RpcClient("127.0.0.1", self.gcs_port)
        try:
            want = {n.node_id for n in self.nodes}
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                try:
                    infos = client.call("GetAllNodeInfo", timeout=5)
                    alive = {n["NodeID"] for n in infos if n["Alive"]}
                    if want <= alive:
                        return
                except Exception:  # noqa: BLE001
                    pass  # the GCS may be restarting: poll again
                time.sleep(0.1)
            raise TimeoutError(f"nodes did not come up: want {want}")
        finally:
            client.close()

    def shutdown(self) -> None:
        """Tear the cluster down via a short graceful drain, then kill.
        Draining first quiesces lease grants and worker spawns, so the
        kills below land on idle daemons instead of racing in-flight
        RPCs; the CLUSTER_SHUTDOWN reason skips the object push — nobody
        is left to read the copies."""
        if self.gcs_proc is not None and self.nodes:
            from ray_tpu_torch._private.drain import REASON_CLUSTER_SHUTDOWN

            client = RpcClient("127.0.0.1", self.gcs_port)
            try:
                for node in self.nodes:
                    client.call(
                        "DrainNode", node_id=node.node_id,
                        reason=REASON_CLUSTER_SHUTDOWN,
                        deadline_s=0.2, timeout=2,
                    )
                # brief window for the raylets to quiesce and self-exit
                deadline = time.monotonic() + 1.5
                while time.monotonic() < deadline and any(
                        n.proc.poll() is None for n in self.nodes):
                    time.sleep(0.05)
            except Exception:  # noqa: BLE001
                pass  # best-effort quiesce; kill_process_tree is the backstop
            finally:
                client.close()
        for node in list(self.nodes):
            kill_process_tree(node.proc)
        self.nodes.clear()
        kill_process_tree(self.gcs_proc)
        self.gcs_proc = None
