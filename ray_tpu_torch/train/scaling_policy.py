"""Scaling policies — how many workers each (re)start gets (PyTorch port
of ray_tpu/train/scaling_policy.py).

Reference: train/v2/_internal/execution/scaling_policy/
(`FixedScalingPolicy` fixed.py:13, `ElasticScalingPolicy` elastic.py:29).
Fixed always asks for ScalingConfig.num_workers. Elastic sizing asks the
cluster what it can host now, which needs the actor runtime's resource
view: not ported yet."""

from __future__ import annotations

from ray_tpu_torch.train.config import ScalingConfig

ELASTIC_ROW = ("elastic sizing waits for the actor runtime's cluster resources "
               "(ROADMAP.md Queue A, item 7: 'the worker group waits for the actor runtime')")


def decide_num_workers(scaling: ScalingConfig) -> int:
    """The group size for this (re)start attempt."""
    if not scaling.elastic:
        return scaling.num_workers
    raise NotImplementedError(ELASTIC_ROW)
