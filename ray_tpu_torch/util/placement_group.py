"""Placement groups — public API (copy of ray_tpu/util/placement_group.py;
reference: python/ray/util/placement_group.py:22,129; strategies :14-17).

Backed by the GCS 2PC PREPARE/COMMIT bundle reservation
(_private/gcs/server.py CreatePlacementGroup → raylet PrepareBundle/
CommitBundle, mirroring node_manager.proto:514-519). A bundle that holds
"GPU" reserves concrete cards: a ``num_gpus`` lease inside it gets the
bundle's cards in ``CUDA_VISIBLE_DEVICES``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ray_tpu_torch._private import worker as worker_mod

PACK = "PACK"
SPREAD = "SPREAD"
STRICT_PACK = "STRICT_PACK"
STRICT_SPREAD = "STRICT_SPREAD"
VALID_STRATEGIES = (PACK, SPREAD, STRICT_PACK, STRICT_SPREAD)


class PlacementGroup:
    """Handle to a reserved bundle set (reference: placement_group.py:22)."""

    def __init__(self, pg_id, bundles: List[Dict[str, float]]):
        self._id = pg_id
        self._bundles = bundles

    @property
    def id(self) -> str:
        return self._id.hex()

    @property
    def bundle_specs(self) -> List[Dict[str, float]]:
        return list(self._bundles)

    @property
    def bundle_count(self) -> int:
        return len(self._bundles)

    def ready(self, timeout: Optional[float] = None) -> bool:
        """Block until all bundles are committed (reference: pg.ready())."""
        w = worker_mod._require_connected()
        return w.core.placement_group_ready(self._id, timeout=timeout)

    def wait(self, timeout_seconds: float = 30.0) -> bool:
        return self.ready(timeout=timeout_seconds)

    def __repr__(self) -> str:
        return f"PlacementGroup(id={self.id[:12]}, bundles={self.bundle_count})"


def placement_group(
    bundles: List[Dict[str, float]],
    strategy: str = PACK,
    name: str = "",
    lifetime: Optional[str] = None,
) -> PlacementGroup:
    """Reserve resource bundles atomically across the cluster
    (reference: placement_group.py:129)."""
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"strategy must be one of {VALID_STRATEGIES}")
    if not bundles or any(not b for b in bundles):
        raise ValueError("bundles must be a non-empty list of non-empty dicts")
    w = worker_mod._require_connected()
    pg_id = w.core.create_placement_group(bundles, strategy, name=name)
    return PlacementGroup(pg_id, bundles)


def remove_placement_group(pg: PlacementGroup) -> None:
    w = worker_mod._require_connected()
    w.core.remove_placement_group(pg._id)


def placement_group_table(pg: Optional[PlacementGroup] = None):
    w = worker_mod._require_connected()
    if pg is not None:
        return w.core.get_placement_group_info(pg._id)
    return None
