"""GPU slice orchestration (PyTorch port of ray_tpu/util/tpu.py;
reference: python/ray/util/tpu.py — SlicePlacementGroup :420,
get_tpu_coordinator_env_vars :212).

The file is ``gpu.py`` and not ``tpu.py`` because what it reserves is
NVIDIA cards: a "slice" here is ``num_hosts`` hosts of ``gpus_per_host``
cards each, reserved as one gang, all hosts or none. The class keeps the
JAX package's name and members. A TPU topology string ("v5litepod-16")
has no counterpart and raises ``ValueError``; the two counts take its
place. There is no slice-head resource: a placement group's 2PC already
grants every bundle or none, and one bundle a host of ``{"CPU": 1, "GPU":
gpus_per_host}`` lands on that host's cards (``PACK`` on one host,
``STRICT_SPREAD`` across hosts, as in JAX).

Multi-slice (the JAX package's MEGASCALE DCN transport) is not ported:
``num_slices > 1`` and ``get_tpu_coordinator_env_vars`` raise naming
ROADMAP.md Queue A item 7, 'multi-slice megascale_env'.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from ray_tpu_torch.parallel.bootstrap import ITEM_7_MULTI_SLICE, HostGroupSpec, check_slices
from ray_tpu_torch.util.placement_group import (
    PACK,
    STRICT_SPREAD,
    PlacementGroup,
    placement_group,
    remove_placement_group,
)

@dataclasses.dataclass
class SliceInfo:
    num_hosts: int
    gpus_per_host: int
    num_slices: int = 1


class SlicePlacementGroup:
    """Reserve a whole GPU slice (reference: util/tpu.py:420).

    Bundle h carries host h's cards and one CPU for its worker actor.
    Workers target bundles via
    PlacementGroupSchedulingStrategy(placement_group_bundle_index=host_rank).
    """

    def __init__(self, topology: Optional[str] = None, *, num_hosts: int = 1,
                 gpus_per_host: int = 1, num_slices: int = 1, name: str = ""):
        if topology is not None:
            raise ValueError(
                f"topology={topology!r} names a TPU slice; a GPU slice is sized by "
                "num_hosts and gpus_per_host")
        if num_hosts < 1 or gpus_per_host < 1:
            raise ValueError(f"num_hosts={num_hosts} and gpus_per_host={gpus_per_host} "
                             "must both be at least 1")
        check_slices(num_slices)
        self.info = SliceInfo(num_hosts=num_hosts, gpus_per_host=gpus_per_host,
                              num_slices=num_slices)
        bundles: List[Dict[str, float]] = [
            {"CPU": 1.0, "GPU": float(gpus_per_host)} for _ in range(num_hosts)]
        self._pgs: List[PlacementGroup] = [
            placement_group(bundles, strategy=STRICT_SPREAD if num_hosts > 1 else PACK,
                            name=f"{name or 'slice'}-0")]

    @property
    def placement_groups(self) -> List[PlacementGroup]:
        return self._pgs

    @property
    def placement_group(self) -> PlacementGroup:
        return self._pgs[0]

    @property
    def num_workers(self) -> int:
        return self.info.num_hosts * self.info.num_slices

    def ready(self, timeout: Optional[float] = None) -> bool:
        return all(pg.ready(timeout=timeout) for pg in self._pgs)

    def remove(self) -> None:
        for pg in self._pgs:
            try:
                remove_placement_group(pg)
            except Exception:  # noqa: BLE001 — a group already gone
                pass

    def drain(self, deadline_s: Optional[float] = None,
              slice_index: Optional[int] = None) -> List[str]:
        """Gracefully drain the hosts backing this reservation, the whole
        gang at once (reference: DrainNode with
        DRAIN_NODE_REASON_PREEMPTION). ``slice_index`` limits the drain to
        one slice. Returns the drained node ids; the gang's workers
        restart per their max_restarts once replacement capacity
        registers. Reads each group by its ID object (``pg._id``), which
        is what ``get_placement_group_info`` takes."""
        from ray_tpu_torch._private import worker as worker_mod
        from ray_tpu_torch._private.drain import REASON_PREEMPTION

        core = worker_mod._require_connected().core
        pgs = self._pgs if slice_index is None else [self._pgs[slice_index]]
        node_ids: List[str] = []
        for pg in pgs:
            info = core.get_placement_group_info(pg._id) or {}
            for nid in (info.get("bundle_nodes") or {}).values():
                if nid not in node_ids:
                    node_ids.append(nid)
        drained: List[str] = []
        for nid in node_ids:
            try:
                rep = core.gcs.call_retrying(
                    "DrainNode", node_id=nid, reason=REASON_PREEMPTION,
                    deadline_s=deadline_s)
            except Exception:  # noqa: BLE001 — a node already gone
                continue
            drained.extend(rep.get("draining") or [])
        return drained

    def host_group_specs(self, coordinator_address: str) -> List[HostGroupSpec]:
        """The bootstrap spec of every host process in the gang
        (``parallel.bootstrap.initialize_host`` takes one each)."""
        total = self.num_workers
        return [HostGroupSpec(coordinator_address=coordinator_address,
                              num_processes=total,
                              process_id=s * self.info.num_hosts + h,
                              num_slices=self.info.num_slices, slice_id=s)
                for s in range(self.info.num_slices)
                for h in range(self.info.num_hosts)]


def get_tpu_coordinator_env_vars(spec: HostGroupSpec) -> Dict[str, str]:
    """The JAX package's MEGASCALE_* env of a host: multi-slice transport,
    which is not ported."""
    raise NotImplementedError(
        "get_tpu_coordinator_env_vars: the MEGASCALE env of multi-slice (DCN) "
        f"bring-up is not ported to ray_tpu_torch yet ({ITEM_7_MULTI_SLICE})")
