"""Train config surface (PyTorch port of ray_tpu/train/config.py;
reference: python/ray/air/config.py).

``ScalingConfig`` speaks GPUs: ``use_gpu`` and ``gpus_per_worker`` stand
for the JAX package's ``use_tpu`` and ``chips_per_worker`` (resource key
``"GPU"``), and ``mesh`` is the port's ``MeshSpec``, the parallelism
plan. A TPU slice's ``topology`` has no counterpart on a GPU host, and
more than one slice (``num_slices``) raises, as the port's bootstrap
does."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from ray_tpu_torch.parallel.bootstrap import check_slices
from ray_tpu_torch.parallel.mesh import MeshSpec


@dataclasses.dataclass
class ScalingConfig:
    """How many workers and what devices each gets.

    num_workers = host processes (one worker per host, reference:
    train/v2/api/data_parallel_trainer.py)."""

    num_workers: int = 1
    use_gpu: bool = False
    topology: Optional[str] = None  # a TPU slice's; setting it raises
    gpus_per_worker: Optional[int] = None
    num_cpus_per_worker: float = 1.0
    resources_per_worker: Optional[Dict[str, float]] = None
    mesh: MeshSpec = dataclasses.field(default_factory=lambda: MeshSpec(data=-1))
    num_slices: int = 1  # >1 = multi-slice; raises (not ported)
    # elastic scaling (reference: scaling_policy/elastic.py:29): when set,
    # each (re)start sizes the group to what the cluster can host, between
    # min_workers and num_workers
    min_workers: Optional[int] = None

    def __post_init__(self):
        if self.topology is not None:
            raise ValueError(
                f"topology={self.topology!r} names a TPU slice; a GPU worker group "
                "is sized by num_workers and gpus_per_worker")
        check_slices(self.num_slices)

    @property
    def elastic(self) -> bool:
        return self.min_workers is not None

    def worker_resources(self) -> Dict[str, float]:
        """What one worker leases. A ``use_gpu`` worker takes
        ``gpus_per_worker`` cards, one when that is unset (a JAX worker
        takes chips only when ``chips_per_worker`` is set: a GPU worker
        group is sized in cards)."""
        res = dict(self.resources_per_worker or {})
        res.setdefault("CPU", self.num_cpus_per_worker)
        gpus = 1 if self.gpus_per_worker is None else self.gpus_per_worker
        if self.use_gpu and gpus:
            res.setdefault("GPU", gpus)
        return res


@dataclasses.dataclass
class FailureConfig:
    """Retry budget for worker-group failures (reference:
    train/v2/_internal/execution/failure_handling/failure_policy.py:14)."""

    max_failures: int = 0  # 0 = fail fast; -1 = infinite retries


@dataclasses.dataclass
class CheckpointConfig:
    """Keep-K checkpoint retention (reference:
    train/v2/_internal/execution/checkpoint/checkpoint_manager.py)."""

    num_to_keep: Optional[int] = None
    checkpoint_frequency: int = 0  # steps between auto-checkpoints (0 = manual)


@dataclasses.dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None  # a local directory
    failure_config: FailureConfig = dataclasses.field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = dataclasses.field(default_factory=CheckpointConfig)


@dataclasses.dataclass
class Result:
    """What `.fit()` returns (reference: python/ray/air/result.py)."""

    metrics: Dict[str, Any]
    checkpoint: Optional[Any]  # train.Checkpoint
    error: Optional[BaseException] = None
    path: Optional[str] = None

    @property
    def best_checkpoint(self):
        return self.checkpoint
