"""ClusterRuntime — the real multi-process execution backend (copy of
ray_tpu/_private/cluster_runtime.py: ``num_gpus`` where JAX's takes
``num_tpus``).

Reference analogue: the Cython CoreWorker (python/ray/_raylet.pyx:2851) over
src/ray/core_worker/, plus python/ray/_private/worker.py connect() :2026.

Composition:
- GCS server process (ray_tpu_torch/_private/gcs/): node/actor/KV/job/PG tables,
  health checks, actor scheduling.
- Raylet process per node (ray_tpu_torch/_private/raylet/): worker pool, local
  scheduler that leases cards ("GPU") as instances, lease protocol, bundle 2PC.
- Native shared-memory object store (_private/object_store/csrc/store.cc).
- Worker processes (ray_tpu_torch/_private/workers/default_worker.py).
- This driver-side runtime: a CoreWorker connected as the driver.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional, Tuple

from ray_tpu_torch._private.core_worker import CoreWorker
from ray_tpu_torch._private.ids import JobID
from ray_tpu_torch._private.node import Node
from ray_tpu_torch._private.rpc import RpcClient, clear_client_cache

logger = logging.getLogger(__name__)


class ClusterRuntime(CoreWorker):
    """CoreWorker in driver mode + lifecycle of locally-started node procs."""

    def __init__(self, node: Optional[Node], gcs_addr, raylet_addr, store_socket, node_id, job_id):
        self._node = node
        super().__init__(
            gcs_addr=gcs_addr,
            raylet_addr=raylet_addr,
            store_socket=store_socket,
            node_id=node_id,
            job_id=job_id,
            is_driver=True,
        )

    @classmethod
    def create(
        cls,
        address: Optional[str] = None,
        num_cpus: Optional[float] = None,
        num_gpus: Optional[float] = None,
        resources: Optional[Dict[str, float]] = None,
        object_store_memory: Optional[int] = None,
        namespace: Optional[str] = None,
        dashboard: bool = False,
    ) -> "ClusterRuntime":
        if address in (None, "local"):
            node = Node(
                num_cpus=num_cpus,
                num_gpus=num_gpus,
                resources=resources,
                object_store_memory=object_store_memory,
            )
            node.start()
            gcs_addr = node.gcs_addr
            raylet_addr = node.raylet_addr
            store_socket = node.store_socket
            node_id = node.node_id
        else:
            # connect to an existing cluster: address = "host:port" of GCS
            node = None
            host, port_s = address.rsplit(":", 1)
            gcs_addr = (host, int(port_s))
            gcs = RpcClient(gcs_addr[0], gcs_addr[1])
            nodes = gcs.call_retrying("GetAllNodeInfo")
            alive = [n for n in nodes if n["Alive"]]
            # prefer the head node: the driver shares its object store
            local = next((n for n in alive if n.get("IsHead")), alive[0] if alive else None)
            if local is None:
                raise RuntimeError("no alive nodes in cluster")
            raylet_addr = (local["NodeManagerAddress"], local["NodeManagerPort"])
            store_socket = local["ObjectStoreSocketName"]
            node_id = local["NodeID"]
            gcs.close()

        # register the driver's job
        runtime = cls(node, gcs_addr, raylet_addr, store_socket, node_id, JobID.from_int(0))
        reply = runtime.gcs.call_retrying("RegisterJob", driver_addr=runtime.address, metadata={})
        runtime.job_id = JobID.from_int(reply["job_id_int"])
        return runtime

    def shutdown(self) -> None:
        try:
            self.gcs.call("MarkJobFinished", job_id=self.job_id.hex(), timeout=5)
        except Exception:  # GCS may already be gone — finish local teardown
            logger.debug("MarkJobFinished failed at shutdown", exc_info=True)
        super().shutdown()
        clear_client_cache()
        if self._node is not None:
            self._node.stop()
