"""Runtime context (copy of ray_tpu/runtime_context.py; reference:
python/ray/runtime_context.py)."""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private.ids import NodeID


class RuntimeContext:
    @property
    def worker_id(self):
        return worker_mod._require_connected().worker_id

    @property
    def job_id(self):
        return worker_mod._require_connected().job_id

    def get_job_id(self) -> str:
        return worker_mod._require_connected().job_id.hex()

    def get_node_id(self) -> Optional[str]:
        w = worker_mod._require_connected()
        n = w.current_node_id
        if n is not None:
            return n.hex() if hasattr(n, "hex") else str(n)
        # the backend knows which node it lives on (local mode keeps a
        # NodeID, which JAX's local mode returns as is: the hex here)
        n = getattr(w.core, "node_id", None)
        if n is not None:
            return n.hex() if isinstance(n, NodeID) else n
        nodes = w.core.nodes()
        return nodes[0]["NodeID"] if nodes else None

    def get_task_id(self) -> Optional[str]:
        tid, _ = worker_mod._require_connected().get_task_context()
        return tid.hex() if tid else None

    def get_actor_id(self) -> Optional[str]:
        _, aid = worker_mod._require_connected().get_task_context()
        return aid.hex() if aid else None

    def get_worker_id(self) -> str:
        return worker_mod._require_connected().worker_id.hex()

    @property
    def was_current_actor_reconstructed(self) -> bool:
        return False

    def get_assigned_resources(self):
        w = worker_mod._require_connected()
        return dict(getattr(w, "assigned_resources", {}) or {})


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext()
