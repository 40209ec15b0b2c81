"""Control-plane lifecycle timelines: phase marks + critical path (copy of
ray_tpu/observability/timeline.py).

Reference: the reference's task-event state machine (GcsTaskManager
records SUBMITTED/.../FINISHED per task) extended to the *actor
bring-up* pipeline — ROADMAP's #1 wall (10.4–13.4 actors/s) with no
attribution for where the time goes. Every phase of actor creation

    submit -> registered -> scheduled -> lease_granted ->
    worker_started -> init_done -> alive -> first_ping

and of the task path (submit -> lease -> run_start -> run_end ->
result) is stamped as one ``actor_lifecycle``/``task_lifecycle`` bus
event carrying BOTH clocks: wall ``ts`` for human display and
monotonic ``mono`` for cross-process reconciliation at GCS ingest
(``aggregator.py`` turns per-sender monotonic stamps into one shared
timebase ``gts`` using a min-transit clock-offset estimate).

Marking is OFF by default: ``mark_actor``/``mark_task`` cost one dict
read when disabled (the overhead-guard test pins that). Enable with
``RAY_TPU_TIMELINE=1`` (inherited by every spawned process) or
:func:`configure`. Task marks are additionally sampled by a
deterministic hash of the task id (``RAY_TPU_TIMELINE_TASK_SAMPLE``)
so a 100k-task flood doesn't swamp the aggregator while any given
task's timeline stays all-or-nothing.

The analysis half is pure functions over event dicts — shared by the
GCS aggregator (state API), ``tools/obsdump`` (offline shards) and
``scale_bench`` (the per-phase bring-up row).
"""

from __future__ import annotations

import os
import time
import zlib
from typing import Any, Dict, List, Optional

from ray_tpu_torch.observability import events as _events

# canonical phase orders (documentation + plot ordering; analysis uses
# observed timestamps, so a missing or out-of-order mark degrades to
# whatever actually happened instead of lying)
ACTOR_PHASES = ("submit", "registered", "scheduled", "lease_granted",
                "worker_started", "init_done", "alive", "first_ping")
TASK_PHASES = ("submit", "lease", "run_start", "run_end", "result")

_config = {
    "enabled": os.environ.get("RAY_TPU_TIMELINE", "0").lower()
    not in ("0", "", "false"),
    "task_sample": float(
        os.environ.get("RAY_TPU_TIMELINE_TASK_SAMPLE", "0.01")),
}


def configure(enabled: Optional[bool] = None,
              task_sample: Optional[float] = None) -> None:
    """Per-process switch; processes spawned by the raylet inherit the
    ``RAY_TPU_TIMELINE`` env instead (set it before ``init()``)."""
    if enabled is not None:
        _config["enabled"] = bool(enabled)
    if task_sample is not None:
        _config["task_sample"] = min(1.0, max(0.0, float(task_sample)))


def enabled() -> bool:
    return _config["enabled"]


def mark_actor(actor_id: str, phase: str,
               mono: Optional[float] = None, **fields: Any) -> None:
    """Stamp one actor bring-up phase. No-op unless enabled.

    ``mono`` overrides the stamp with an earlier monotonic instant on
    the SAME host. Use sparingly: a backdated mark that predates the
    entity's ``submit`` (e.g. a prestarted worker's fork time) reorders
    the whole timeline — prefer marking at arrival and attaching the
    earlier instant as a field (see ``worker_started``'s
    ``spawn_age_s``)."""
    if not _config["enabled"]:
        return
    _events.record_event(
        "actor_lifecycle", actor_id=actor_id, phase=phase,
        mono=time.monotonic() if mono is None else float(mono), **fields)


def task_sampled(task_id: str) -> bool:
    """Deterministic per-task sampling decision: every process that
    sees this task id agrees, so a sampled task's timeline is complete
    and an unsampled one costs nothing anywhere."""
    rate = _config["task_sample"]
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    h = zlib.crc32(task_id.encode()) & 0xFFFFFFFF
    return h / 4294967296.0 < rate


def mark_task(task_id: str, phase: str, **fields: Any) -> None:
    """Stamp one task lifecycle phase (sampled). No-op unless enabled."""
    if not _config["enabled"]:
        return
    if not task_sampled(task_id):
        return
    _events.record_event("task_lifecycle", task_id=task_id,
                         phase=phase, mono=time.monotonic(), **fields)


# =====================================================================
# analysis — pure functions over event dicts
# =====================================================================

def _ev_time(ev: dict) -> float:
    """Reconciled time when the aggregator stamped one (``gts``), the
    sender's raw monotonic otherwise (single-host shards share the
    boot clock), wall as the last resort."""
    t = ev.get("gts")
    if t is None:
        t = ev.get("mono")
    if t is None:
        t = ev.get("ts", 0.0)
    return float(t)


def build_timelines(events: List[dict],
                    etype: str = "actor_lifecycle",
                    key: str = "actor_id") -> Dict[str, List[dict]]:
    """Group lifecycle marks per entity, ordered by reconciled time.
    Returns ``{entity_id: [{"phase", "t", "ts"}, ...]}``."""
    out: Dict[str, List[dict]] = {}
    for ev in events:
        if ev.get("type") != etype:
            continue
        eid = ev.get(key)
        if not eid:
            continue
        out.setdefault(eid, []).append(
            {"phase": ev.get("phase", "?"), "t": _ev_time(ev),
             "ts": ev.get("ts", 0.0)})
    for marks in out.values():
        marks.sort(key=lambda m: m["t"])
    return out


def transitions(marks: List[dict]) -> List[dict]:
    """Durations between consecutive observed marks:
    ``[{"name": "submit->registered", "dur": s}, ...]``."""
    out: List[dict] = []
    for a, b in zip(marks, marks[1:]):
        out.append({"name": f"{a['phase']}->{b['phase']}",
                    "dur": max(0.0, b["t"] - a["t"])})
    return out


def _pctl(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[idx]


def summarize(timelines: Dict[str, List[dict]]) -> Dict[str, dict]:
    """Per-transition stats across entities:
    ``{"submit->registered": {"n", "p50", "p99", "mean", "total_s"}}``."""
    durs: Dict[str, List[float]] = {}
    for marks in timelines.values():
        for tr in transitions(marks):
            durs.setdefault(tr["name"], []).append(tr["dur"])
    out: Dict[str, dict] = {}
    for name, vals in durs.items():
        vals.sort()
        total = sum(vals)
        out[name] = {
            "n": len(vals),
            "p50": round(_pctl(vals, 0.50), 6),
            "p99": round(_pctl(vals, 0.99), 6),
            "mean": round(total / len(vals), 6),
            "total_s": round(total, 6),
        }
    return out


def critical_path(timelines: Dict[str, List[dict]],
                  wall_s: Optional[float] = None) -> Dict[str, Any]:
    """Attribute measured wall clock per phase transition.

    With N entities moving through the pipeline concurrently, summed
    per-entity durations overshoot the wall by the effective
    concurrency (``sum_busy / wall``); dividing each transition's total
    by that factor yields a per-phase wall attribution that sums to the
    measured wall *by construction* — the honest way to say "of the
    43 s bring-up wall, 31 s is lease_granted->worker_started". The
    p50/p99 columns next to it stay raw per-entity latencies.
    """
    summary = summarize(timelines)
    tmin, tmax = None, None
    for marks in timelines.values():
        if not marks:
            continue
        t0, t1 = marks[0]["t"], marks[-1]["t"]
        tmin = t0 if tmin is None else min(tmin, t0)
        tmax = t1 if tmax is None else max(tmax, t1)
    coverage = (tmax - tmin) if tmin is not None else 0.0
    if wall_s is None:
        wall_s = coverage
    sum_busy = sum(s["total_s"] for s in summary.values())
    eff = (sum_busy / wall_s) if wall_s and wall_s > 0 else 1.0
    phases: Dict[str, dict] = {}
    for name, s in summary.items():
        wall_attr = s["total_s"] / eff if eff > 0 else 0.0
        phases[name] = dict(s, wall_s=round(wall_attr, 6),
                            share=round(wall_attr / wall_s, 4)
                            if wall_s else 0.0)
    return {
        "entities": len(timelines),
        "wall_s": round(wall_s, 6),
        "coverage_s": round(coverage, 6),
        "effective_concurrency": round(eff, 3),
        "phase_sum_s": round(sum(p["wall_s"] for p in phases.values()), 6),
        "phases": phases,
    }


def lifecycle_summary_doc(events: List[dict],
                          wall_s: Optional[float] = None,
                          etype: str = "actor_lifecycle",
                          key: str = "actor_id") -> Dict[str, Any]:
    """One-call analysis used by the GCS state API and obsdump."""
    return critical_path(build_timelines(events, etype=etype, key=key),
                         wall_s=wall_s)
