"""Exporters: Chrome-trace / Perfetto JSON from span records (copy of
ray_tpu/observability/export.py).

Reference: ray.timeline's Chrome-trace output (_private/profiling.py)
— same JSON dialect, but built from the tracing subsystem's spans, so
the rows show the caller→callee tree (via ``parent_span_id`` args)
instead of flat task lifetimes. Open in chrome://tracing or
https://ui.perfetto.dev.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional


def to_chrome_trace(spans: List[dict]) -> Dict[str, Any]:
    """Complete-event ("ph": "X") trace. pid groups by process (the
    recording worker), tid by span kind; span/parent/trace ids ride in
    ``args`` so the tree is reconstructible from the file alone."""
    events: List[dict] = []
    for s in spans:
        events.append({
            "name": s.get("name", "?"),
            "cat": s.get("kind", "span"),
            "ph": "X",
            "ts": float(s.get("ts", 0.0)) * 1e6,
            "dur": max(0.0, float(s.get("dur", 0.0)) * 1e6),
            "pid": s.get("worker", "proc"),
            "tid": s.get("kind", "span"),
            "args": {
                "span_id": s.get("span_id"),
                "parent_span_id": s.get("parent_span_id", ""),
                "trace_id": s.get("trace_id"),
                "status": s.get("status", "ok"),
                **(s.get("attrs") or {}),
            },
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def export_trace(job_id: str, filename: Optional[str] = None):
    """Fetch a job's span tree from the head and export it. With a
    ``filename``, writes Chrome-trace JSON and returns None (mirrors
    ``ray_tpu_torch.timeline``); otherwise returns the trace dict."""
    from ray_tpu_torch.util import state as rstate

    trace = rstate.get_trace(job_id)
    doc = to_chrome_trace(trace.get("spans", []))
    if filename:
        with open(filename, "w") as f:
            json.dump(doc, f)
        return None
    return doc
