"""Per-worker train session: `report`, `get_context`, checkpoint access
(copy of ray_tpu/train/session.py).

Reference surface: ray.train.report / get_context
(train/v2/api/train_fn_utils.py:23, train/_internal/session.py:698).
The session is a thread-local set up by the worker actor before calling
the user's train loop; `report()` hands metrics (+ optional checkpoint
dir) back to the controller."""

from __future__ import annotations

import os
import queue
import threading
from typing import Any, Dict, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint

_session: threading.local = threading.local()


class TrainContext:
    def __init__(self, world_rank: int, world_size: int,
                 local_rank: int = 0, local_world_size: int = 1,
                 node_rank: int = 0, experiment_name: str = "train",
                 storage_path: Optional[str] = None,
                 latest_checkpoint: Optional[Checkpoint] = None):
        self._world_rank = world_rank
        self._world_size = world_size
        self._local_rank = local_rank
        self._local_world_size = local_world_size
        self._node_rank = node_rank
        self._experiment_name = experiment_name
        self._storage_path = storage_path
        self._latest_checkpoint = latest_checkpoint
        self._report_queue: "queue.Queue" = queue.Queue()
        self._stop_event = threading.Event()
        # step-span bookkeeping: report() closes a span covering the
        # work since the previous report (observability/tracing.py)
        self._step = 0
        self._last_report_wall: Optional[float] = None
        self._last_report_mono: Optional[float] = None

    def get_world_rank(self) -> int:
        return self._world_rank

    def get_world_size(self) -> int:
        return self._world_size

    def get_local_rank(self) -> int:
        return self._local_rank

    def get_local_world_size(self) -> int:
        return self._local_world_size

    def get_node_rank(self) -> int:
        return self._node_rank

    def get_experiment_name(self) -> str:
        return self._experiment_name

    def get_storage_path(self) -> Optional[str]:
        return self._storage_path

    def get_checkpoint(self) -> Optional[Checkpoint]:
        return self._latest_checkpoint


def _set_session(ctx: Optional[TrainContext]) -> None:
    _session.ctx = ctx


def get_context() -> TrainContext:
    ctx = getattr(_session, "ctx", None)
    if ctx is None:
        # Outside a worker (tests / local scripts): a 1-process context.
        ctx = TrainContext(world_rank=0, world_size=1)
        _session.ctx = ctx
    return ctx


def report(metrics: Dict[str, Any], checkpoint: Optional[Checkpoint] = None) -> None:
    """Report metrics (and optionally a checkpoint) to the controller.
    Reference: train/v2/api/train_fn_utils.py:23."""
    ctx = get_context()
    _record_step_span(ctx)
    ctx._report_queue.put({"metrics": dict(metrics),
                           "checkpoint": checkpoint.path if checkpoint else None})
    if ctx._stop_event.is_set():
        raise SystemExit("train loop stopped by controller")


def _record_step_span(ctx: TrainContext) -> None:
    """Each report() closes a ``train.step`` span covering the interval
    since the previous report (step N's compute), parented to whatever
    span context the worker actor inherited — so a traced training run
    shows per-step rows per rank. No-ops when the chain is untraced."""
    import time as _time

    from ray_tpu_torch.observability import tracing as obs_tracing

    now_wall, now_mono = _time.time(), _time.monotonic()
    if ctx._last_report_mono is not None:
        obs_tracing.record_span(
            "train.step", kind="train",
            ts=ctx._last_report_wall,
            dur=now_mono - ctx._last_report_mono,
            attrs={"step": ctx._step, "world_rank": ctx._world_rank},
        )
    ctx._step += 1
    ctx._last_report_wall = now_wall
    ctx._last_report_mono = now_mono


def get_checkpoint() -> Optional[Checkpoint]:
    return get_context().get_checkpoint()
