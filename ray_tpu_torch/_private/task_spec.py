"""Task specifications — the unit handed from submitter to scheduler to executor
(copy of ray_tpu/_private/task_spec.py).

Reference: src/ray/common/task/task_spec.h:82 (TaskSpecification) and
src/ray/protobuf/common.proto (TaskSpec message). We keep the same logical
fields (ids, function descriptor, args, resources, retry policy, scheduling
strategy, actor linkage) as a plain dataclass serialized with pickle over our
RPC layer.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private.ids import ActorID, JobID, ObjectID, TaskID, WorkerID


class TaskType(enum.Enum):
    NORMAL_TASK = 0
    ACTOR_CREATION_TASK = 1
    ACTOR_TASK = 2
    DRIVER_TASK = 3


@dataclass
class FunctionDescriptor:
    """Identifies a remote function/class (reference:
    src/ray/common/function_descriptor.h)."""

    module_name: str
    function_name: str
    class_name: str = ""
    function_hash: str = ""

    @property
    def repr_name(self) -> str:
        if self.class_name:
            return f"{self.class_name}.{self.function_name}"
        return self.function_name

    def key(self) -> str:
        return f"{self.module_name}:{self.class_name}:{self.function_name}:{self.function_hash}"


@dataclass
class TaskArg:
    """Either an inline serialized value or an ObjectRef passed by reference."""

    is_ref: bool
    # for by-value: serialized bytes (SerializedObject); for by-ref: object id
    value: Any = None
    object_id: Optional[ObjectID] = None
    owner_addr: Optional[Tuple[str, int]] = None


@dataclass
class SchedulingStrategy:
    """DEFAULT | SPREAD | node-affinity | placement-group (reference:
    python/ray/util/scheduling_strategies.py)."""

    kind: str = "DEFAULT"  # DEFAULT, SPREAD, NODE_AFFINITY, NODE_LABEL, PLACEMENT_GROUP
    node_id: Optional[str] = None
    soft: bool = False
    placement_group_id: Optional[str] = None
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False
    node_labels: Optional[Dict[str, str]] = None


@dataclass
class TaskSpec:
    task_id: TaskID
    job_id: JobID
    task_type: TaskType
    function_descriptor: FunctionDescriptor
    language: str = "python"
    args: List[TaskArg] = field(default_factory=list)
    num_returns: int = 1
    resources: Dict[str, float] = field(default_factory=dict)
    scheduling_strategy: SchedulingStrategy = field(default_factory=SchedulingStrategy)
    max_retries: int = 0
    retry_exceptions: bool = False
    # ownership
    caller_id: Optional[WorkerID] = None
    caller_addr: Optional[Tuple[str, int]] = None
    # actor linkage
    actor_id: Optional[ActorID] = None
    actor_creation_id: Optional[ActorID] = None  # set on creation tasks
    max_restarts: int = 0
    max_task_retries: int = 0
    sequence_number: int = 0  # actor task ordering
    concurrency_group: str = ""
    max_concurrency: int = 1
    is_asyncio: bool = False
    # runtime env / function payload
    runtime_env: Dict[str, Any] = field(default_factory=dict)
    serialized_function: Optional[bytes] = None  # inline-shipped function, small fns
    function_key: Optional[str] = None  # GCS KV key for exported functions
    # generators
    is_streaming_generator: bool = False
    # depth for scheduling-class / dedup
    attempt_number: int = 0

    def return_ids(self) -> List[ObjectID]:
        return [ObjectID.from_index(self.task_id, i + 1) for i in range(self.num_returns)]

    @property
    def scheduling_class(self) -> Tuple:
        """Group tasks by (fn, resources, runtime env) for lease reuse
        (reference: SchedulingClass in src/ray/common/task/task_spec.h —
        the reference's class includes the runtime env so leased workers
        are never shared across envs).

        Computed once per spec and cached: the submit path reads it
        several times per task (submit, lease lookup, queue keying), and
        its inputs (descriptor, resources, strategy, runtime env) are
        fixed at construction — only attempt_number mutates later."""
        cached = self.__dict__.get("_scheduling_class_cache")
        if cached is not None:
            return cached
        st = self.scheduling_strategy
        self.__dict__["_scheduling_class_cache"] = cached = (
            self.function_descriptor.key(),
            tuple(sorted(self.resources.items())),
            st.kind,
            st.placement_group_id,
            st.placement_group_bundle_index,
            # affinity/label targets must not share leases across targets
            st.node_id,
            tuple(sorted((st.node_labels or {}).items())),
            self.runtime_env_hash(),
        )
        return cached

    def runtime_env_hash(self) -> str:
        if not self.runtime_env:
            return ""
        from ray_tpu_torch._private.runtime_env import env_hash

        return env_hash(self.runtime_env)
