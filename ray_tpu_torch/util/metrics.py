"""Application metrics API: Counter / Gauge / Histogram (copy of
ray_tpu/util/metrics.py).

Reference: python/ray/util/metrics.py (user API) over the C++ metric
registry (src/ray/stats/metric.h:104) exported to Prometheus. Here every
process keeps a local registry and a pusher thread ships snapshots to the
GCS, which aggregates and serves the Prometheus text endpoint
(GET /metrics on the port from `ray_tpu_torch.util.state.metrics_endpoint()`).

Usage (driver, task, or actor):
    from ray_tpu_torch.util import metrics
    c = metrics.Counter("requests_total", description="...", tag_keys=("route",))
    c.inc(1, tags={"route": "/infer"})
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

_DEFAULT_HIST_BUCKETS = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 50.0, 100.0
)


class _Registry:
    """Per-process metric registry + GCS pusher."""

    _instance: Optional["_Registry"] = None
    _lock = threading.Lock()
    PUSH_PERIOD_S = 2.0

    def __init__(self) -> None:
        self.metrics: List["Metric"] = []
        self.reg_lock = threading.Lock()
        self._pusher_started = False

    @classmethod
    def get(cls) -> "_Registry":
        with cls._lock:
            if cls._instance is None:
                cls._instance = _Registry()
            return cls._instance

    def register(self, metric: "Metric") -> None:
        with self.reg_lock:
            self.metrics.append(metric)
        self._ensure_pusher()

    def _ensure_pusher(self) -> None:
        with self.reg_lock:
            if self._pusher_started:
                return
            self._pusher_started = True
        threading.Thread(
            target=self._push_loop, daemon=True, name="metrics-push"
        ).start()

    def snapshot(self) -> List[dict]:
        with self.reg_lock:
            metrics = list(self.metrics)
        return [m._snapshot() for m in metrics]

    def _push_loop(self) -> None:
        from ray_tpu_torch._private import worker as worker_mod

        while True:
            time.sleep(self.PUSH_PERIOD_S)
            w = worker_mod.global_worker
            if w is None or w.core is None:
                continue
            gcs = getattr(w.core, "gcs", None)
            if gcs is None:
                continue  # local mode: metrics stay process-local
            snap = self.snapshot()
            if not snap:
                continue
            try:
                gcs.call_oneway(
                    "ReportMetrics",
                    producer=getattr(w.core, "worker_id_hex", "driver"),
                    metrics=snap,
                )
            except Exception:  # noqa: BLE001
                pass


def _tags_key(tags: Optional[Dict[str, str]]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((tags or {}).items()))


class Metric:
    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] = ()):
        self._name = name
        self._description = description
        self._tag_keys = tuple(tag_keys)
        self._default_tags: Dict[str, str] = {}
        self._lock = threading.Lock()
        _Registry.get().register(self)

    def set_default_tags(self, tags: Dict[str, str]) -> None:
        self._default_tags = dict(tags)

    def _merged(self, tags: Optional[Dict[str, str]]) -> Dict[str, str]:
        out = dict(self._default_tags)
        if tags:
            out.update(tags)
        return out


class Counter(Metric):
    """Monotonic counter (reference: util/metrics.py Counter)."""

    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] = ()):
        super().__init__(name, description, tag_keys)
        self._values: Dict[Tuple, float] = {}

    def inc(self, value: float = 1.0, tags: Optional[Dict[str, str]] = None) -> None:
        if value < 0:
            raise ValueError("Counter.inc() requires value >= 0")
        key = _tags_key(self._merged(tags))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def _snapshot(self) -> dict:
        with self._lock:
            series = [
                {"tags": dict(k), "value": v} for k, v in self._values.items()
            ]
        return {"name": self._name, "type": "counter",
                "description": self._description, "series": series}


class Gauge(Metric):
    """Last-value gauge (reference: util/metrics.py Gauge)."""

    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] = ()):
        super().__init__(name, description, tag_keys)
        self._values: Dict[Tuple, float] = {}

    def set(self, value: float, tags: Optional[Dict[str, str]] = None) -> None:
        key = _tags_key(self._merged(tags))
        with self._lock:
            self._values[key] = float(value)

    def _snapshot(self) -> dict:
        with self._lock:
            series = [
                {"tags": dict(k), "value": v} for k, v in self._values.items()
            ]
        return {"name": self._name, "type": "gauge",
                "description": self._description, "series": series}


class Histogram(Metric):
    """Bucketed histogram (reference: util/metrics.py Histogram)."""

    def __init__(self, name: str, description: str = "",
                 boundaries: Sequence[float] = _DEFAULT_HIST_BUCKETS,
                 tag_keys: Sequence[str] = ()):
        super().__init__(name, description, tag_keys)
        self._bounds = tuple(sorted(boundaries))
        self._series: Dict[Tuple, dict] = {}

    def observe(self, value: float, tags: Optional[Dict[str, str]] = None) -> None:
        key = _tags_key(self._merged(tags))
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = {
                    "buckets": [0] * (len(self._bounds) + 1),
                    "sum": 0.0,
                    "count": 0,
                }
            i = 0
            while i < len(self._bounds) and value > self._bounds[i]:
                i += 1
            s["buckets"][i] += 1
            s["sum"] += value
            s["count"] += 1

    def _snapshot(self) -> dict:
        with self._lock:
            series = [
                {"tags": dict(k), "buckets": list(s["buckets"]),
                 "sum": s["sum"], "count": s["count"]}
                for k, s in self._series.items()
            ]
        return {"name": self._name, "type": "histogram",
                "description": self._description,
                "bounds": list(self._bounds), "series": series}


_named_hist_lock = threading.Lock()
_named_hists: Dict[str, Histogram] = {}


def get_histogram(name: str, description: str = "",
                  boundaries: Sequence[float] = _DEFAULT_HIST_BUCKETS,
                  tag_keys: Sequence[str] = ()) -> Histogram:
    """Process-wide idempotent histogram lookup: instrumentation call
    sites (task latency, queue wait, collective bandwidth) share one
    instance per name without each carrying its own lazy-init globals.
    First caller's description/boundaries win; registration (and the
    pusher thread) happens only when a site actually records."""
    h = _named_hists.get(name)
    if h is None:
        with _named_hist_lock:
            h = _named_hists.get(name)
            if h is None:
                h = _named_hists[name] = Histogram(
                    name, description=description,
                    boundaries=boundaries, tag_keys=tag_keys)
    return h
