"""Collective-op observability: spans, bandwidth histograms, events (copy of
ray_tpu/observability/collective.py).

One outer :func:`op_span` per collective call (parents into whatever
trace the calling task inherited) plus nested :func:`phase_span`s for
the hierarchical phases (encode / reduce_local / xh / publish /
gather). Besides tracing, the op span feeds two Prometheus histograms
(whole-op and per-phase effective MB/s) and — for ops big enough to
matter — drops one ``collective_op`` event on the flight-recorder ring
with the phase timing breakdown, so a postmortem can see where an op's
time went without tracing having been enabled in advance.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict

from ray_tpu_torch.observability import events as obs_events
from ray_tpu_torch.observability import tracing as obs_tracing

# below this, ops are latency-regime noise: keep them off the event ring
_EVENT_MIN_BYTES = 64 << 10

# interned span names: the op/phase universe is tiny and fixed, so
# building "collective.allreduce.encode" once per process (instead of an
# f-string per call) keeps the hot path alloc-free AND keeps span names
# out of the free-form-name trap raycheck RC009 guards against
_SPAN_NAMES: Dict[Any, str] = {}


def _span_name(op: str, phase: str = "") -> str:
    key = (op, phase)
    name = _SPAN_NAMES.get(key)
    if name is None:
        name = "collective." + op + ("." + phase if phase else "")
        _SPAN_NAMES[key] = name
    return name


def _histogram(name: str, description: str, tag_keys):
    from ray_tpu_torch.util.metrics import get_histogram

    return get_histogram(
        name,
        description=description,
        boundaries=(1, 10, 50, 100, 500, 1000, 5000, 20000),
        tag_keys=tag_keys,
    )


def _observe(name: str, description: str, tags: Dict[str, str],
             mb_per_s: float) -> None:
    try:
        _histogram(name, description, tuple(tags)).observe(
            mb_per_s, tags=tags)
    except Exception:  # noqa: BLE001 — metrics must not fail the op
        pass


@contextlib.contextmanager
def op_span(op: str, nbytes: int, world_size: int, rank: int):
    """Whole-op span. Yields a mutable record dict — the executor fills
    ``algo`` / ``codec`` once routing is decided and :func:`phase_span`
    appends per-phase durations to ``phases``."""
    rec: Dict[str, Any] = {"algo": "", "codec": "", "phases": {}}
    t0 = time.monotonic()
    with obs_tracing.span(
            _span_name(op), kind="collective",
            attrs={"op": op, "nbytes": nbytes,
                   "world_size": world_size, "rank": rank}):
        yield rec
    dur = time.monotonic() - t0
    if dur <= 0 or not nbytes:
        return
    mb_s = nbytes / dur / 1e6
    _observe("ray_tpu_collective_mb_per_s",
             "Collective op effective bandwidth", {"op": op}, mb_s)
    if nbytes >= _EVENT_MIN_BYTES:
        try:
            obs_events.record_event(
                "collective_op", op=op, nbytes=int(nbytes),
                world_size=world_size, rank=rank,
                algo=rec.get("algo", ""), codec=rec.get("codec", ""),
                topology=dict(rec.get("topology", {})),
                dur_s=round(dur, 6), mb_per_s=round(mb_s, 3),
                phases=dict(rec.get("phases", {})))
        except Exception:  # noqa: BLE001 — observability must not fail ops
            pass


@contextlib.contextmanager
def phase_span(rec: Dict[str, Any], op: str, phase: str, nbytes: int):
    """One hierarchical phase inside an :func:`op_span`."""
    t0 = time.monotonic()
    with obs_tracing.span(
            _span_name(op, phase), kind="collective.phase",
            attrs={"op": op, "phase": phase, "nbytes": nbytes}):
        yield
    dur = time.monotonic() - t0
    rec.setdefault("phases", {})[phase] = \
        round(rec.get("phases", {}).get(phase, 0.0) + dur, 6)
    if dur > 0 and nbytes:
        _observe("ray_tpu_collective_phase_mb_per_s",
                 "Collective per-phase effective bandwidth",
                 {"op": op, "phase": phase}, nbytes / dur / 1e6)
