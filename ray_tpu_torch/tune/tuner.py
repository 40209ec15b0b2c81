"""Tuner + trial controller (PyTorch port of ray_tpu/tune/tuner.py).

Reference call path: `Tuner.fit` (tune/tuner.py:43) → `TuneController`
(tune/execution/tune_controller.py:72) — trials run as actors, the
controller polls intermediate results, the scheduler may stop trials
early, results land in a ResultGrid.

A trial's resource request names cards (``resources_per_trial=
{"GPU": n}``, an actor's ``num_gpus``, where the JAX package's names TPU
chips). Trials are actors: in local mode on threads, the trainable
passed by reference; under a cluster in worker processes, the trainable
pickled by the vendored cloudpickle. A trial may itself be a
TorchTrainer run (Train-in-Tune, reference: train v2 runs as a Tune
trial).
"""

from __future__ import annotations

import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train.config import RunConfig
from ray_tpu_torch.tune.schedulers import EXPLOIT, FIFOScheduler, STOP
from ray_tpu_torch.tune.search import generate_variants


@dataclass
class TuneConfig:
    """Reference: tune/tune_config.py."""

    metric: Optional[str] = None
    mode: str = "min"
    num_samples: int = 1
    max_concurrent_trials: Optional[int] = None
    scheduler: Any = None
    seed: Optional[int] = None
    # model-based sequential searcher (e.g. tune.TpeSearcher) — when set,
    # configs come from search_alg.suggest() as trials launch instead of
    # being pre-sampled, and final metrics are fed back to the model
    # (reference: tune_config.search_alg → optuna_search.py:87)
    search_alg: Any = None


@dataclass
class TrialResult:
    trial_id: str
    config: Dict[str, Any]
    metrics: Dict[str, Any] = field(default_factory=dict)
    history: List[Dict[str, Any]] = field(default_factory=list)
    error: Optional[str] = None
    # set when PBT restarted this trial from a donor's checkpoint
    restart_ckpt: Optional[str] = None

    @property
    def done(self) -> bool:
        return True


class ResultGrid:
    """Reference: tune/result_grid.py."""

    def __init__(self, results: List[TrialResult], metric: Optional[str], mode: str):
        self._results = results
        self._metric = metric
        self._mode = mode

    def __len__(self) -> int:
        return len(self._results)

    def __getitem__(self, i: int) -> TrialResult:
        return self._results[i]

    @property
    def errors(self) -> List[str]:
        return [r.error for r in self._results if r.error]

    def get_best_result(self, metric: Optional[str] = None, mode: Optional[str] = None) -> TrialResult:
        metric = metric or self._metric
        mode = mode or self._mode
        scored = [r for r in self._results if r.error is None and metric in r.metrics]
        if not scored:
            raise ValueError("No successful trial reported metric " + str(metric))
        return (min if mode == "min" else max)(scored, key=lambda r: r.metrics[metric])

    def get_dataframe(self):
        import pandas as pd

        rows = []
        for r in self._results:
            row = {"trial_id": r.trial_id, **{f"config/{k}": v for k, v in r.config.items()}}
            row.update(r.metrics)
            rows.append(row)
        return pd.DataFrame(rows)


@ray_tpu_torch.remote
class _TrialActor:
    """Runs one trial's function in a thread; controller polls reports.
    max_concurrency=4 (set at creation) lets poll() run during the trial."""

    def __init__(self):
        self._reports: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._done = False
        self._error: Optional[str] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self, fn: Callable, config: Dict[str, Any],
              checkpoint_path: Optional[str] = None) -> bool:
        from ray_tpu_torch.train import session as train_session
        from ray_tpu_torch.train.checkpoint import Checkpoint

        ctx = train_session.TrainContext(
            world_rank=0, world_size=1,
            latest_checkpoint=Checkpoint(checkpoint_path)
            if checkpoint_path else None,
        )
        ctx._stop_event = self._stop
        self._ctx = ctx

        def _run():
            train_session._set_session(ctx)
            try:
                fn(config)
            except SystemExit:
                pass
            except BaseException:
                with self._lock:
                    self._error = traceback.format_exc()
            finally:
                train_session._set_session(None)
                with self._lock:
                    self._done = True

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()
        return True

    def poll(self) -> Dict[str, Any]:
        # drain the live session queue so intermediate reports reach the
        # scheduler while the trial is still running (ASHA early stop)
        ctx = getattr(self, "_ctx", None)
        if ctx is not None:
            while not ctx._report_queue.empty():
                item = ctx._report_queue.get()
                with self._lock:
                    self._reports.append(item["metrics"])
                    if item.get("checkpoint"):
                        self._ckpt = item["checkpoint"]
        with self._lock:
            out = {"reports": list(self._reports), "done": self._done,
                   "error": self._error,
                   "checkpoint": getattr(self, "_ckpt", None)}
            self._reports.clear()
        return out

    # the trial thread runs user code that may never observe _stop; joining
    # here would hang the tuner loop, and the actor process exit reaps the
    # daemon thread — raycheck: disable=RC005
    def stop(self) -> bool:
        self._stop.set()
        return True


class Tuner:
    """Reference surface: tune/tuner.py:43."""

    def __init__(
        self,
        trainable: Callable,
        *,
        param_space: Optional[Dict[str, Any]] = None,
        tune_config: Optional[TuneConfig] = None,
        run_config: Optional[RunConfig] = None,
        resources_per_trial: Optional[Dict[str, float]] = None,
    ):
        self._trainable = trainable
        self._space = param_space or {}
        self._cfg = tune_config or TuneConfig()
        self._run = run_config or RunConfig()
        self._resources = resources_per_trial or {}

    def fit(self) -> ResultGrid:
        searcher = self._cfg.search_alg
        if searcher is not None:
            searcher.set_search_properties(self._cfg.metric, self._cfg.mode,
                                           self._space)
            # configs are suggested lazily at launch; placeholders here
            variants = [None] * self._cfg.num_samples
        else:
            variants = generate_variants(self._space, self._cfg.num_samples, self._cfg.seed)
        scheduler = self._cfg.scheduler or FIFOScheduler()
        max_conc = self._cfg.max_concurrent_trials
        if max_conc is None:
            # fit concurrency to the cluster so trial actors can schedule
            # (reference: TuneController shares resources across trials).
            # cluster_resources() races node registration right after
            # init() and can return {} — sizing off the 8-CPU fallback
            # then OVERSUBSCRIBES the real cluster and the surplus
            # trial's launch deadlocks against its finished-but-unkilled
            # peers until the 180s wait-alive timeout rescues it
            # (observed: a 6s fit taking 182s). Wait briefly for a real
            # snapshot before falling back.
            cpus = 0.0
            for _ in range(50):
                try:
                    cpus = ray_tpu_torch.cluster_resources().get("CPU", 0.0)
                except Exception:  # noqa: BLE001 — registration race
                    cpus = 0.0
                if cpus:
                    break
                time.sleep(0.1)
            cpus = cpus or 8.0
            per_trial = max(self._resources.get("CPU", 1), 0.5)
            max_conc = max(1, min(len(variants), int(cpus / per_trial) - 1 or 1))
        pending = [
            TrialResult(trial_id=f"trial_{i:05d}", config=cfg)
            for i, cfg in enumerate(variants)
        ]
        queue = list(pending)
        running: Dict[str, Any] = {}  # trial_id -> (actor, TrialResult)
        finished: List[TrialResult] = []
        ckpts: Dict[str, str] = {}  # trial_id -> latest checkpoint path

        def _launch(tr: TrialResult, checkpoint_path: Optional[str] = None):
            actor = _TrialActor.options(
                max_concurrency=4,
                num_cpus=self._resources.get("CPU", 1),
                num_gpus=self._resources.get("GPU", 0),
            ).remote()
            try:
                # bounded: an unplaceable actor must hand control back to
                # the poll loop (which processes done trials and frees
                # their resources) instead of parking the controller for
                # the full 180s actor-resolve window
                ray_tpu_torch.get(
                    actor.start.remote(self._trainable, tr.config, checkpoint_path),
                    timeout=30)
            except Exception:
                # couldn't place the actor (cluster full) — retry later
                try:
                    ray_tpu_torch.kill(actor)
                except Exception:
                    pass
                return None
            if hasattr(scheduler, "register"):
                scheduler.register(tr.trial_id, tr.config)
            return actor

        last_progress = time.monotonic()
        while queue or running:
            # launch up to max_conc; scheduling pressure backs off instead
            # of failing the trial
            while queue and len(running) < max_conc:
                tr = queue.pop(0)
                if searcher is not None and tr.config is None:
                    cfg = searcher.suggest(tr.trial_id)
                    if cfg is None:
                        # budget exhausted: the trial is RECORDED as
                        # errored, not silently vanished — the grid's
                        # length must match num_samples
                        tr.config = {}
                        tr.error = ("search_alg exhausted its budget "
                                    "before this trial")
                        finished.append(tr)
                        continue
                    tr.config = cfg
                actor = _launch(tr, tr.restart_ckpt)
                if actor is None:
                    queue.insert(0, tr)
                    max_conc = max(1, len(running))
                    # nothing running and nothing placeable: the trial's
                    # resource request can never be satisfied — fail it
                    # instead of spinning forever (reference: infeasible
                    # trials error out in TuneController)
                    if not running and time.monotonic() - last_progress > 60:
                        tr = queue.pop(0)
                        tr.error = (
                            "trial unplaceable: resource request "
                            f"{self._resources} cannot be satisfied"
                        )
                        finished.append(tr)
                    break
                running[tr.trial_id] = (actor, tr)
                last_progress = time.monotonic()
            # poll — two phases: gather every trial's state (so donor
            # checkpoints are recorded regardless of iteration order),
            # then feed reports to the scheduler
            time.sleep(0.05)
            states: Dict[str, Dict] = {}
            for tid in list(running):
                actor, tr = running[tid]
                try:
                    states[tid] = ray_tpu_torch.get(actor.poll.remote())
                except Exception as e:  # actor died
                    tr.error = f"trial actor died: {e}"
                    finished.append(tr)
                    running.pop(tid)
                    if searcher is not None:
                        searcher.on_trial_complete(tid, error=True)
                    continue
                if states[tid].get("checkpoint"):
                    ckpts[tid] = states[tid]["checkpoint"]
            for tid, state in states.items():
                if tid not in running:
                    continue
                actor, tr = running[tid]
                for rep in state["reports"]:
                    tr.history.append(rep)
                    tr.metrics = rep
                    decision = scheduler.on_result(tid, rep)
                    if decision == STOP and not state["done"]:
                        try:
                            actor.stop.remote()
                        except Exception:
                            pass
                    elif decision == EXPLOIT:
                        donor, new_cfg = scheduler.exploit_info(tid)
                        if state["done"] or ckpts.get(donor) is None:
                            # trial already finished, or the donor hasn't
                            # checkpointed yet — drop; PBT retries at the
                            # next interval boundary (re-register the old
                            # config: the mutation was not applied)
                            if hasattr(scheduler, "register"):
                                scheduler.register(tid, tr.config)
                            continue
                        # PBT: restart this trial from the donor's
                        # checkpoint with a perturbed config
                        try:
                            actor.stop.remote()
                            ray_tpu_torch.kill(actor, no_restart=True)
                        except Exception:
                            pass
                        running.pop(tid)
                        tr.config = new_cfg
                        tr.restart_ckpt = ckpts.get(donor)
                        # the pre-restart checkpoint no longer matches the
                        # trial's config — don't let anyone exploit it
                        ckpts.pop(tid, None)
                        queue.insert(0, tr)
                        last_progress = time.monotonic()
                        break
                else:
                    if state["done"]:
                        tr.error = state["error"]
                        finished.append(tr)
                        running.pop(tid)
                        last_progress = time.monotonic()
                        if searcher is not None:
                            searcher.on_trial_complete(
                                tid, tr.metrics, error=bool(tr.error))
                        try:
                            ray_tpu_torch.kill(actor)
                        except Exception:
                            pass
        return ResultGrid(finished, self._cfg.metric, self._cfg.mode)


def report(metrics: Dict[str, Any], **kwargs) -> None:
    """tune.report — same session channel as train.report
    (reference: tune reuses the train session, train/_internal/session.py)."""
    from ray_tpu_torch.train.session import report as _report

    _report(metrics, **kwargs)
