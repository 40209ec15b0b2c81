"""Flag/config system for ray_tpu_torch (copy of
ray_tpu/_private/config.py).

TPU-native equivalent of the reference's ``RAY_CONFIG(type, name, default)``
macro table (reference: src/ray/common/ray_config_def.h:18 — 244 flags,
overridable via ``RAY_<name>`` env vars and a ``_system_config`` dict at init).

Here every flag is declared once in ``_DEFINITIONS`` with a type and default,
is overridable via the ``RAY_TPU_<NAME>`` environment variable, and can be
overridden programmatically via ``RayTpuConfig.initialize(system_config)``.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Tuple


def _parse_bool(v: str) -> bool:
    return v.strip().lower() in ("1", "true", "yes", "on")


# name -> (type, default)
_DEFINITIONS: Dict[str, Tuple[type, Any]] = {
    # --- event loop / rpc ---
    "rpc_connect_timeout_s": (float, 10.0),
    "rpc_call_timeout_s": (float, 60.0),
    # actor __init__ runs user code (model builds, framework imports)
    "actor_creation_timeout_s": (float, 600.0),
    "rpc_retry_base_delay_ms": (int, 100),
    "rpc_retry_max_delay_ms": (int, 5000),
    "rpc_max_retries": (int, 5),
    "event_loop_slow_handler_ms": (int, 100),
    # --- chaos / fault injection (reference: src/ray/rpc/rpc_chaos.h:8,
    # src/ray/asio/asio_chaos.h) ---
    "testing_rpc_failure": (str, ""),  # "method=prob" comma list
    "testing_asio_delay_us": (str, ""),
    # --- gcs ---
    "gcs_port": (int, 0),  # 0 = pick free port
    "gcs_storage_path": (str, ""),  # "" = in-memory; else file-backed persistence
    "gcs_health_check_period_ms": (int, 1000),
    "gcs_health_check_timeout_ms": (int, 5000),
    # 20 missed beats (~20s) before a node is declared dead. 5 was too
    # twitchy on an oversubscribed 1-core host: a 2,000-actor burst
    # starves the raylet process of CPU long enough to gap heartbeats
    # >10s, and one false death cascades (every actor on the node
    # fails — observed killing the combined scale phase). The reference
    # defaults to ~30s of missed heartbeats; tests that kill nodes
    # budget >=30s for detection, so 20s keeps their margin.
    "gcs_health_check_failure_threshold": (int, 20),
    "gcs_pubsub_poll_timeout_s": (float, 30.0),
    # --- graceful node drain (reference: DrainNode with a deadline and
    # DRAIN_NODE_REASON_PREEMPTION in gcs_service.proto; TPU preemption
    # notices give the whole slice a short window to quiesce) ---
    "drain_deadline_default_s": (float, 30.0),
    # how long past its deadline a DRAINING node may sit before the GCS
    # watchdog force-completes the drain (marks it dead) — bounds the
    # "node stuck DRAINING forever" failure mode across GCS restarts
    "drain_watchdog_grace_s": (float, 5.0),
    # --- raylet / scheduler ---
    "raylet_heartbeat_period_ms": (int, 500),
    "worker_lease_timeout_ms": (int, 30000),
    "worker_pool_prestart_workers": (bool, False),
    # fork workers from a warmed zygote process instead of cold
    # interpreter starts (workers/zygote.py)
    "worker_zygote_enabled": (bool, True),
    "worker_idle_timeout_s": (float, 60.0),
    "max_workers_per_node": (int, 64),
    "scheduler_top_k_fraction": (float, 0.2),
    "scheduler_top_k_absolute": (int, 1),
    "scheduler_spread_threshold": (float, 0.5),
    "worker_startup_timeout_s": (float, 60.0),
    # OOM worker killing (reference: raylet memory monitor +
    # worker_killing_policy_group_by_owner.h); >= 1.0 disables
    "memory_usage_threshold": (float, 0.97),
    "memory_monitor_period_s": (float, 1.0),
    # test hook: read the fake memory pct from this file instead of
    # psutil (lets tests drive pressure up and down deterministically)
    "testing_memory_pct_file": (str, ""),
    # --- object store ---
    "object_store_memory_bytes": (int, 2 * 1024**3),
    "object_store_socket": (str, ""),
    "object_spilling_dir": (str, ""),
    "object_store_full_delay_ms": (int, 100),
    "object_store_inline_max_bytes": (int, 100 * 1024),
    "object_pull_chunk_bytes": (int, 8 * 1024**2),
    # --- tasks ---
    "task_max_retries_default": (int, 3),
    # how long a submitter keeps an idle granted lease warm before
    # returning it to the raylet. A sync small-task loop previously paid
    # RequestWorkerLease + SetLeaseContext + ReturnWorkerLease around
    # EVERY PushTask (~4 control RPCs per call); with keep-alive the warm
    # path is one worker RPC. 0 restores return-on-idle.
    "worker_lease_keepalive_s": (float, 0.5),
    # queued same-class tasks pushed to a leased worker per RPC roundtrip
    # (1 = the reference's one-PushTask-per-task behavior)
    "task_push_batch_size": (int, 32),
    # producer pauses when this many yields sit unconsumed at the caller
    # (reference: generator_backpressure_num_objects)
    "streaming_generator_buffer_size": (int, 256),
    "actor_max_restarts_default": (int, 0),
    "max_pending_lease_requests_per_class": (int, 10),
    # how long a caller keeps resending an un-acked actor task while the
    # actor is unreachable/restarting before failing it
    "actor_task_resend_timeout_s": (float, 60.0),
    # how long a caller waits for a PENDING actor to come ALIVE before
    # its queued task fails (actor __init__ can be slow; large actor
    # bursts queue behind each other)
    "actor_wait_alive_timeout_s": (float, 180.0),
    # GCS-side deadline for finding+leasing a worker for a PENDING actor
    # (the whole creation backlog of a large burst queues behind it)
    "actor_schedule_timeout_s": (float, 300.0),
    # in-flight actor creations (lease+spawn+CreateActor pipelines) the
    # GCS runs concurrently — admission control against thundering-herd
    # collapse on hosts with few cores
    "actor_creation_concurrency": (int, 48),
    # owner-side sweep dropping borrowers whose process died without
    # deregistering (reference: WaitForRefRemoved, reference_counter.h:44)
    "borrower_liveness_period_s": (float, 30.0),
    # --- tpu ---
    "tpu_chips_per_host_default": (int, 4),
    "megascale_port": (int, 8081),
    "jax_coordinator_port": (int, 8476),
    # --- logging ---
    "log_dir": (str, ""),
    "log_to_driver": (bool, True),
}


class _Config:
    """Singleton holding resolved config values."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._values: Dict[str, Any] = {}
        self._load_defaults()

    def _load_defaults(self) -> None:
        for name, (typ, default) in _DEFINITIONS.items():
            env = os.environ.get("RAY_TPU_" + name.upper())
            if env is not None:
                if typ is bool:
                    self._values[name] = _parse_bool(env)
                else:
                    self._values[name] = typ(env)
            else:
                self._values[name] = default

    def initialize(self, system_config: Dict[str, Any] | None = None) -> None:
        """Apply a programmatic override dict (like Ray's _system_config)."""
        with self._lock:
            self._load_defaults()
            if system_config:
                for k, v in system_config.items():
                    if k not in _DEFINITIONS:
                        raise ValueError(f"Unknown config flag: {k}")
                    typ = _DEFINITIONS[k][0]
                    self._values[k] = _parse_bool(v) if typ is bool and isinstance(v, str) else typ(v)

    def to_json(self) -> str:
        with self._lock:
            return json.dumps(self._values)

    def from_json(self, payload: str) -> None:
        with self._lock:
            self._values.update(json.loads(payload))

    def __getattr__(self, name: str) -> Any:
        try:
            return self._values[name]
        except KeyError:
            raise AttributeError(name) from None


config = _Config()
