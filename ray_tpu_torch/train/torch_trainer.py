"""TorchTrainer: controller + worker group (PyTorch port of
ray_tpu/train/jax_trainer.py, the Train v2 architecture).

Reference call stack (SURVEY.md §3.4): `fit()` (train/v2/jax/
jax_trainer.py:20) → TrainController (v2/_internal/execution/controller/
controller.py:105) → WorkerGroup (worker_group/worker_group.py:88) →
user loop. The failure domain is the worker GROUP: on failure the group
restarts from the latest checkpoint (reference FailurePolicy semantics,
failure_handling/failure_policy.py:14).

A group of one runs in the calling process (one card a host: the
single-host case, no actor hop on the hot path). A group of several runs
its loop in ``TrainWorker`` actors named ``{name}-worker-{i}``, each
leasing ``ScalingConfig.worker_resources()`` (``gpus_per_worker`` cards,
which its lease makes its ``cuda:0``); the group is killed after each
attempt. With ``use_gpu`` the workers first join one process group
(``_host_specs``: a fresh rendezvous port each attempt) over NCCL, or
over gloo where the node's cards are the CPU tests' fake ones
(``bootstrap.group_backend``). The train function and its config reach
the workers pickled; each worker builds or restores its own state.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import traceback
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.exceptions import RayActorError
from ray_tpu_torch.parallel.bootstrap import (
    HostGroupSpec, group_backend, initialize_host, local_process_specs,
)
from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager
from ray_tpu_torch.train.config import FailureConfig, Result, RunConfig, ScalingConfig
from ray_tpu_torch.train.scaling_policy import decide_num_workers
from ray_tpu_torch.train.session import TrainContext, _session, _set_session

def _run_worker_loop(
    train_fn: Callable,
    config: Optional[Dict[str, Any]],
    world_rank: int,
    world_size: int,
    experiment_name: str,
    storage_path: Optional[str],
    latest_checkpoint_path: Optional[str],
    host_spec: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Body executed on each worker (actor or in-process). Returns the
    ordered report stream + error info. A failure comes back as its
    formatted traceback only: nothing keeps the exception, its frames or
    the loop's locals (a failed attempt's train state) alive into the
    retry. With ``host_spec`` the worker joins the group's process group
    first; it leaves it when its process ends (the controller kills the
    group's workers)."""
    if host_spec:
        initialize_host(HostGroupSpec(**host_spec), group_backend())
    ctx = TrainContext(
        world_rank=world_rank,
        world_size=world_size,
        node_rank=world_rank,
        experiment_name=experiment_name,
        storage_path=storage_path,
        latest_checkpoint=(
            Checkpoint(latest_checkpoint_path) if latest_checkpoint_path else None
        ),
    )
    prev_ctx = getattr(_session, "ctx", None)  # restore outer session
    _set_session(ctx)                          # (Train-in-Tune nesting)
    error = None
    try:
        if config is not None:
            train_fn(config)
        else:
            train_fn()
    except BaseException as e:  # reported to the controller, not raised here
        error = "".join(traceback.format_exception(type(e), e, e.__traceback__))
    finally:
        _set_session(prev_ctx)
    reports: List[Dict[str, Any]] = []
    while not ctx._report_queue.empty():
        reports.append(ctx._report_queue.get())
    return {"rank": world_rank, "reports": reports, "error": error}


@ray_tpu_torch.remote
class TrainWorker:
    """One per host (reference: worker_group/worker_group.py:88)."""

    def run(self, train_fn, config, world_rank, world_size, experiment_name,
            storage_path, latest_checkpoint_path, host_spec):
        return _run_worker_loop(
            train_fn, config, world_rank, world_size, experiment_name,
            storage_path, latest_checkpoint_path, host_spec,
        )


class TorchTrainer:
    """Data-parallel-style trainer for PyTorch workloads (JaxTrainer's
    counterpart).

    `train_loop_per_worker(config)` runs on every worker with a live
    session (ray_tpu_torch.train.report / get_context). Reference:
    train/v2/jax/jax_trainer.py:20 + data_parallel_trainer.py:159.
    """

    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[Dict[str, Any]] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
    ):
        self._train_fn = train_loop_per_worker
        self._config = train_loop_config
        self._scaling = scaling_config or ScalingConfig()
        self._run = run_config or RunConfig()
        self._resume = resume_from_checkpoint

    # -- controller loop (reference: controller.py:105) -----------------
    def fit(self) -> Result:
        name = self._run.name or "train_run"
        storage = self._run.storage_path or os.path.join(
            tempfile.gettempdir(), "ray_tpu_torch_train", name
        )
        ckpt_mgr = CheckpointManager(
            storage, self._run.checkpoint_config.num_to_keep
        )
        latest = self._resume or ckpt_mgr.latest()
        failure: FailureConfig = self._run.failure_config
        attempts_left = failure.max_failures
        last_error: Optional[str] = None

        while True:
            results = self._run_attempt(name, storage, latest)
            errors = [r["error"] for r in results if r["error"]]
            rank0 = next((r for r in results if r["rank"] == 0), results[0])
            # Register rank-0 checkpoints (workers write per-report dirs
            # under storage; the manager applies keep-K retention).
            last_metrics: Dict[str, Any] = {}
            for rep in rank0["reports"]:
                last_metrics = rep["metrics"]
                if rep["checkpoint"]:
                    ckpt_mgr.register(Checkpoint(rep["checkpoint"]), rep["metrics"])
            latest = ckpt_mgr.latest()
            if not errors:
                return Result(
                    metrics=last_metrics, checkpoint=latest, path=storage
                )
            last_error = errors[0]
            if attempts_left == 0:
                return Result(
                    metrics=last_metrics,
                    checkpoint=latest,
                    error=RuntimeError(last_error),
                    path=storage,
                )
            if attempts_left > 0:
                attempts_left -= 1
            # group restart from latest checkpoint

    def _run_attempt(self, name: str, storage: str,
                     latest: Optional[Checkpoint]) -> List[Dict[str, Any]]:
        # elastic: size this (re)start to what the cluster can host now
        # (reference: ElasticScalingPolicy elastic.py:29) — a lost node
        # shrinks the group, restarting from the latest checkpoint
        n = decide_num_workers(self._scaling)
        latest_path = latest.path if latest else None
        if n <= 1:
            # In-process fast path (reference: local mode,
            # train/v2/_internal/execution/local_mode/): one card, no
            # actor hop on the hot path.
            return [
                _run_worker_loop(
                    self._train_fn, self._config, 0, 1, name, storage,
                    latest_path, None,
                )
            ]
        res = self._scaling.worker_resources()
        workers = [
            TrainWorker.options(
                name=f"{name}-worker-{i}",
                num_cpus=res.get("CPU", 1),
                num_gpus=res.get("GPU", 0),
            ).remote()
            for i in range(n)
        ]
        try:
            specs = self._host_specs(n)
            futs = {
                w.run.remote(
                    self._train_fn, self._config, i, n, name, storage,
                    latest_path, specs[i],
                ): i
                for i, w in enumerate(workers)
            }
            return self._gather(futs, workers)
        finally:
            for w in workers:
                try:
                    ray_tpu_torch.kill(w)
                except Exception:  # noqa: BLE001 — already dead
                    pass

    @staticmethod
    def _gather(futs: Dict[Any, int], workers: List[Any]) -> List[Dict[str, Any]]:
        """Every worker's result, by rank, as each comes in. The worker of a
        failed loop is killed as soon as its result is in: its process
        group's links close with it, so its peers' collectives fail (and
        their loops return their reports) instead of waiting for it. A
        worker that died is a failed rank with no reports."""
        results: Dict[int, Dict[str, Any]] = {}
        pending = list(futs)
        while pending:
            ready, pending = ray_tpu_torch.wait(pending, num_returns=1)
            for f in ready:
                i = futs[f]
                try:
                    results[i] = ray_tpu_torch.get(f)
                except RayActorError as e:
                    results[i] = {"rank": i, "reports": [], "error": f"worker {i} died: {e}"}
                if results[i]["error"]:
                    ray_tpu_torch.kill(workers[i])
        return [results[i] for i in range(len(workers))]

    def _host_specs(self, n: int) -> List[Optional[Dict[str, Any]]]:
        """Process-group specs: only for a group of several card-holding
        workers (JAX gives them only to TPU groups; CPU workers run
        independent loops)."""
        if not self._scaling.use_gpu or n <= 1:
            return [None] * n
        return [dataclasses.asdict(s) for s in local_process_specs(n)]
