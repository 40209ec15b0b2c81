"""ray_tpu_torch.util — placement groups, scheduling strategies, GPU
slices (``util.gpu``) and the collective API (``util.collective``), as in
the JAX package's ``ray_tpu.util`` (reference: python/ray/util)."""

from ray_tpu_torch.util.placement_group import (
    PACK,
    SPREAD,
    STRICT_PACK,
    STRICT_SPREAD,
    PlacementGroup,
    placement_group,
    placement_group_table,
    remove_placement_group,
)
from ray_tpu_torch.util.scheduling_strategies import (
    NodeAffinitySchedulingStrategy,
    NodeLabelSchedulingStrategy,
    PlacementGroupSchedulingStrategy,
)

__all__ = [
    "PACK",
    "SPREAD",
    "STRICT_PACK",
    "STRICT_SPREAD",
    "NodeAffinitySchedulingStrategy",
    "NodeLabelSchedulingStrategy",
    "PlacementGroup",
    "PlacementGroupSchedulingStrategy",
    "placement_group",
    "placement_group_table",
    "remove_placement_group",
]
