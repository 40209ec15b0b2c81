"""Public scheduling strategies (copy of
ray_tpu/util/scheduling_strategies.py; reference:
python/ray/util/scheduling_strategies.py)."""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch._private.task_spec import SchedulingStrategy


class PlacementGroupSchedulingStrategy:
    """Schedule onto a placement group bundle (reference:
    scheduling_strategies.py PlacementGroupSchedulingStrategy)."""

    def __init__(self, placement_group, placement_group_bundle_index: int = -1,
                 placement_group_capture_child_tasks: bool = False):
        self.placement_group = placement_group
        self.placement_group_bundle_index = placement_group_bundle_index
        self.placement_group_capture_child_tasks = placement_group_capture_child_tasks

    def to_internal(self) -> SchedulingStrategy:
        return SchedulingStrategy(
            kind="PLACEMENT_GROUP",
            placement_group_id=self.placement_group.id,
            placement_group_bundle_index=self.placement_group_bundle_index,
            placement_group_capture_child_tasks=self.placement_group_capture_child_tasks,
        )


class NodeAffinitySchedulingStrategy:
    def __init__(self, node_id: str, soft: bool = False):
        self.node_id = node_id
        self.soft = soft

    def to_internal(self) -> SchedulingStrategy:
        return SchedulingStrategy(kind="NODE_AFFINITY", node_id=self.node_id, soft=self.soft)


class NodeLabelSchedulingStrategy:
    """Schedule onto nodes whose labels match (reference:
    scheduling_strategies.py NodeLabelSchedulingStrategy / the raylet's
    node-label policy, scheduling/policy/node_label_scheduling_policy.h).

    ``hard``: {label: value} every candidate node must carry.
    ``soft=True`` falls back to default scheduling when nothing matches.
    """

    def __init__(self, hard: Optional[dict] = None, soft: bool = False):
        self.hard = dict(hard or {})
        self.soft = soft

    def to_internal(self) -> SchedulingStrategy:
        return SchedulingStrategy(kind="NODE_LABEL", node_labels=self.hard,
                                  soft=self.soft)
