"""Scaling policies — how many workers each (re)start gets (PyTorch port
of ray_tpu/train/scaling_policy.py).

Reference: train/v2/_internal/execution/scaling_policy/
(`FixedScalingPolicy` fixed.py:13, `ElasticScalingPolicy` elastic.py:29).
Fixed always asks for ScalingConfig.num_workers; elastic sizes the group
to what the cluster can host RIGHT NOW within [min_workers, num_workers]
— after a node loss the next attempt restarts smaller from the latest
checkpoint instead of waiting for replacement capacity, and a later
attempt can grow back when capacity returns.

The JAX package's whole-slice branch (a TPU ``topology`` resizes in
whole slices) has no counterpart: the port's ``ScalingConfig`` rejects
``topology``, and a GPU worker group grows and shrinks one card-holding
worker at a time.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional

from ray_tpu_torch.train.config import ScalingConfig

logger = logging.getLogger("ray_tpu_torch.train")


def _hostable_workers(per_worker: Dict[str, float]) -> Optional[int]:
    """How many workers the cluster's CURRENT total resources can host
    (per-node bin-packing is the scheduler's job; totals bound us).
    None = the resource query failed — the caller must NOT treat a
    control-plane blip as a shrunken cluster."""
    import ray_tpu_torch

    total = None
    for attempt in range(3):
        try:
            total = ray_tpu_torch.cluster_resources()
            break
        except Exception:  # noqa: BLE001
            time.sleep(0.5 * (attempt + 1))
    if total is None:
        return None
    n = None
    for k, need in per_worker.items():
        if need <= 0:
            continue
        can = int(total.get(k, 0.0) // need)
        n = can if n is None else min(n, can)
    return n if n is not None else 0


def decide_num_workers(scaling: ScalingConfig) -> int:
    """The group size for this (re)start attempt."""
    if not scaling.elastic:
        return scaling.num_workers
    lo = max(1, int(scaling.min_workers))
    hi = max(lo, scaling.num_workers)
    hostable = _hostable_workers(scaling.worker_resources())
    if hostable is None:
        # transient query failure: run at the requested size rather than
        # silently shrinking a healthy cluster's group to the floor
        logger.warning(
            "elastic sizing: cluster resource query failed; keeping "
            "num_workers=%d", hi)
        return hi
    n = max(lo, min(hi, hostable))
    if n != hi:
        logger.info("elastic sizing: %d/%d workers hostable", n, hi)
    return n
