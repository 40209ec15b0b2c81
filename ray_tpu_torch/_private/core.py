"""CoreRuntime — the interface every execution backend implements (copy of
ray_tpu/_private/core.py).

The public API (``ray_tpu_torch.get/put/remote/...``) talks only to this
interface. Two backends exist:

- ``LocalModeRuntime`` (ray_tpu_torch/_private/local_mode.py): in-process,
  for ``init(local_mode=True)`` and unit tests — reference analogue:
  python/ray/_private/worker.py LOCAL_MODE.
- ``ClusterRuntime`` (ray_tpu_torch/_private/cluster_runtime.py): the real
  multi-process runtime (GCS + raylet + shared-memory object store +
  worker processes) — reference analogue: the Cython CoreWorker
  (python/ray/_raylet.pyx:2851) over src/ray/core_worker/.
"""

from __future__ import annotations

import abc
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.task_spec import SchedulingStrategy


@dataclass
class TaskOptions:
    num_returns: int = 1
    resources: Dict[str, float] = field(default_factory=dict)
    max_retries: int = 0
    retry_exceptions: bool = False
    scheduling_strategy: SchedulingStrategy = field(default_factory=SchedulingStrategy)
    runtime_env: Dict[str, Any] = field(default_factory=dict)
    name: str = ""


@dataclass
class ActorOptions:
    resources: Dict[str, float] = field(default_factory=dict)
    max_restarts: int = 0
    max_task_retries: int = 0
    max_concurrency: int = 1
    max_pending_calls: int = -1
    name: Optional[str] = None
    namespace: Optional[str] = None
    lifetime: Optional[str] = None  # None | "detached"
    get_if_exists: bool = False
    scheduling_strategy: SchedulingStrategy = field(default_factory=SchedulingStrategy)
    runtime_env: Dict[str, Any] = field(default_factory=dict)
    # Reference semantics (actor.py:616+ docs): an actor whose num_cpus was
    # NOT specified uses 1 CPU for *scheduling* its creation but holds 0 CPU
    # while alive — otherwise long-lived actors starve task leases.
    cpu_scheduling_only: bool = True


def normalize_resources(
    num_cpus: Optional[float],
    num_gpus: Optional[float],
    num_tpus: Optional[float],
    resources: Optional[Dict[str, float]],
    memory: Optional[float] = None,
    default_cpus: float = 1.0,
) -> Dict[str, float]:
    """Fold the num_cpus/num_gpus/resources keywords into one resource dict.

    ``num_gpus`` maps to the "GPU" key, the card's resource; ``num_tpus``
    is kept, as in the JAX package, and maps to the "TPU" key.
    """
    out: Dict[str, float] = dict(resources or {})
    out["CPU"] = float(num_cpus) if num_cpus is not None else default_cpus
    if num_gpus:
        out["GPU"] = float(num_gpus)
    if num_tpus:
        out["TPU"] = float(num_tpus)
    if memory:
        out["memory"] = float(memory)
    # drop zero entries
    return {k: v for k, v in out.items() if v}


class CoreRuntime(abc.ABC):
    @abc.abstractmethod
    def put(self, value: Any) -> ObjectRef: ...

    @abc.abstractmethod
    def get(self, refs: Sequence[ObjectRef], timeout: Optional[float] = None) -> List[Any]: ...

    @abc.abstractmethod
    def wait(
        self,
        refs: Sequence[ObjectRef],
        num_returns: int,
        timeout: Optional[float],
        fetch_local: bool = True,
    ) -> Tuple[List[ObjectRef], List[ObjectRef]]: ...

    @abc.abstractmethod
    def submit_task(
        self, remote_function, args: tuple, kwargs: dict, opts: TaskOptions
    ) -> List[ObjectRef]: ...

    @abc.abstractmethod
    def create_actor(self, actor_class, args: tuple, kwargs: dict, opts: ActorOptions): ...

    @abc.abstractmethod
    def submit_actor_task(
        self, handle, method_name: str, args: tuple, kwargs: dict, opts: TaskOptions
    ) -> List[ObjectRef]: ...

    @abc.abstractmethod
    def kill_actor(self, actor_id, no_restart: bool = True) -> None: ...

    @abc.abstractmethod
    def cancel(self, ref: ObjectRef, force: bool = False, recursive: bool = True) -> None: ...

    @abc.abstractmethod
    def as_future(self, ref: ObjectRef) -> Future: ...

    @abc.abstractmethod
    def free_object(self, oid) -> None: ...

    @abc.abstractmethod
    def get_actor(self, name: str, namespace: Optional[str] = None): ...

    @abc.abstractmethod
    def cluster_resources(self) -> Dict[str, float]: ...

    @abc.abstractmethod
    def available_resources(self) -> Dict[str, float]: ...

    @abc.abstractmethod
    def nodes(self) -> List[Dict[str, Any]]: ...

    @abc.abstractmethod
    def shutdown(self) -> None: ...

    # Placement groups — implemented by cluster runtime; local mode fakes them.
    def create_placement_group(self, bundles, strategy, name=""):
        raise NotImplementedError

    def remove_placement_group(self, pg_id) -> None:
        raise NotImplementedError

    def placement_group_ready(self, pg_id, timeout=None) -> bool:
        raise NotImplementedError
