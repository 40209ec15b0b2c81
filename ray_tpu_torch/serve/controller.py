"""Serve control plane: controller actor + replica actors (copy of
ray_tpu/serve/controller.py).

Reference: ServeController (serve/_private/controller.py:127) reconciles
DeploymentState (deployment_state.py:2820); replicas are plain actors
(replica.py:1554 handle_request, :1630 streaming); queue-depth autoscaling
from handle-reported metrics (autoscaling_state.py:340); config fan-out via
long-poll push (long_poll.py:318).

Cards: replicas ask for them through normal actor options
(``num_gpus`` or ``resources={"GPU": n}``) — the raylet leases "GPU"
instances and pins them through ``CUDA_VISIBLE_DEVICES``; batching
(serve/batching.py here) is what keeps the tensor cores busy.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.serve import slo
from ray_tpu_torch.serve.deployment import (
    Application,
    Deployment,
    DeploymentHandle,
)

CONTROLLER_NAME = "__serve_controller"


class _Rejected:
    """Replica-at-capacity sentinel (reference: the REJECTED status in
    replica.py:1630 handle_request_with_rejection). The handle retries
    on another replica when a response resolves to this."""

    __slots__ = ("ongoing",)

    def __init__(self, ongoing: int):
        self.ongoing = ongoing


@ray_tpu_torch.remote
class Replica:
    """Hosts one copy of the deployment callable (reference:
    serve/_private/replica.py:1554 handle_request, :1630
    handle_request_with_rejection — the replica, not the caller, is the
    authority on its own capacity: N handles each see only their own
    in-flight counts, so caller-side bounding alone lets N handles
    overload one replica N-fold)."""

    def __init__(self, serialized_target: bytes, init_args, init_kwargs,
                 user_config: Optional[Dict] = None,
                 max_ongoing_requests: int = 0):
        from ray_tpu_torch._private.serialization import loads_function

        target = loads_function(serialized_target)
        if isinstance(target, type):
            self._callable = target(*init_args, **init_kwargs)
        else:
            self._callable = target
        if user_config is not None and hasattr(self._callable, "reconfigure"):
            self._callable.reconfigure(user_config)
        self._loop = None
        self._loop_lock = threading.Lock()
        self._max_ongoing = max_ongoing_requests  # 0 = unenforced
        self._ongoing = 0
        self._ongoing_peak = 0
        self._deadline_rejects = 0  # arrived with no budget left
        self._ongoing_lock = threading.Lock()
        # streams get their OWN cap, below the request cap, so
        # long-lived streams can't occupy every slot and starve unary
        # traffic. Degenerate cases keep streaming usable rather than
        # the invariant absolute: max_ongoing=1 still admits 1 stream
        # (which then does fill the only slot), 0 = unenforced.
        self._max_streams = max(1, max_ongoing_requests - 1) \
            if max_ongoing_requests else 0
        self._streams = 0

    def _acquire_slot(self) -> bool:
        with self._ongoing_lock:
            if self._max_ongoing and self._ongoing >= self._max_ongoing:
                return False
            self._ongoing += 1
            self._ongoing_peak = max(self._ongoing_peak, self._ongoing)
            return True

    def _release_slot(self) -> None:
        with self._ongoing_lock:
            self._ongoing -= 1

    def ongoing_stats(self) -> Dict[str, int]:
        with self._ongoing_lock:
            return {"ongoing": self._ongoing, "peak": self._ongoing_peak,
                    "max": self._max_ongoing,
                    "deadline_rejects": self._deadline_rejects}

    def _check_deadline(self, deadline_s: Optional[float]
                        ) -> Optional[slo.Deadline]:
        """Re-anchor the caller's relative budget against this clock;
        raise if it already ran out in flight / in the replica queue —
        executing a request nobody is waiting for is pure waste."""
        if deadline_s is None:
            return None
        if deadline_s <= 0:
            with self._ongoing_lock:
                self._deadline_rejects += 1
            raise slo.DeadlineExceededError(
                "request deadline exceeded before the replica started "
                "executing")
        return slo.Deadline(deadline_s)

    def _maybe_await(self, out, model_id: str = "", deadline=None):
        """Async deployment callables run on a per-replica event loop
        (reference: replicas are fully async in serve/_private/replica.py).
        The multiplexed model id and request deadline are re-set INSIDE
        the coroutine: the Task created on the loop thread copies that
        thread's context, not the request thread's, so the contextvars
        would otherwise read empty."""
        import asyncio
        import inspect

        if not inspect.iscoroutine(out):
            return out
        with self._loop_lock:
            if self._loop is None:
                self._loop = asyncio.new_event_loop()
                threading.Thread(
                    target=self._loop.run_forever, daemon=True,
                    name="replica-loop",
                ).start()

        async def _with_model_id():
            from ray_tpu_torch.serve.multiplex import _current_model_id

            token = _current_model_id.set(model_id)
            dtoken = slo._request_deadline.set(deadline)
            try:
                return await out
            finally:
                slo._request_deadline.reset(dtoken)
                _current_model_id.reset(token)

        fut = asyncio.run_coroutine_threadsafe(_with_model_id(), self._loop)
        # the request deadline bounds the wait; without one, a generous
        # fixed cap (no serve-path wait is allowed to be unbounded)
        timeout = deadline.remaining_or_raise() if deadline is not None \
            else slo.MAX_TIMEOUT_S
        import concurrent.futures

        try:
            return fut.result(timeout=timeout)
        except (TimeoutError, concurrent.futures.TimeoutError):
            # 3.10: futures.TimeoutError is not the builtin — catch both
            fut.cancel()
            raise slo.DeadlineExceededError(
                "request deadline exceeded while executing") from None

    def handle_request(self, method: str, args, kwargs,
                       multiplexed_model_id: str = "",
                       deadline_s: Optional[float] = None):
        from ray_tpu_torch.serve.multiplex import _current_model_id

        deadline = self._check_deadline(deadline_s)
        token = _current_model_id.set(multiplexed_model_id)
        dtoken = slo._request_deadline.set(deadline)
        try:
            if method == "__call__":
                return self._maybe_await(self._callable(*args, **kwargs),
                                         multiplexed_model_id, deadline)
            return self._maybe_await(
                getattr(self._callable, method)(*args, **kwargs),
                multiplexed_model_id, deadline)
        finally:
            slo._request_deadline.reset(dtoken)
            _current_model_id.reset(token)

    def handle_request_with_rejection(self, method: str, args, kwargs,
                                      multiplexed_model_id: str = "",
                                      deadline_s: Optional[float] = None):
        """Accept-or-reject at the replica's own cap: returns a
        ``_Rejected`` sentinel instead of queueing past
        ``max_ongoing_requests`` (reference: replica.py:1630). The
        handle retries elsewhere with backoff. A dead-on-arrival
        deadline raises DeadlineExceededError instead of executing."""
        if not self._acquire_slot():
            return _Rejected(self._ongoing)
        try:
            return self.handle_request(method, args, kwargs,
                                       multiplexed_model_id, deadline_s)
        finally:
            self._release_slot()

    def handle_request_streaming(self, method: str, args, kwargs,
                                 multiplexed_model_id: str = "",
                                 deadline_s: Optional[float] = None):
        """Generator method: the actor-streaming machinery turns each yield
        into an ObjectRefGenerator item on the caller (replica.py:1630).
        Streams occupy a capacity slot for their whole lifetime, visible
        to unary rejection — but they draw from a SEPARATE stream budget
        (max_ongoing - 1, floored at 1 so a cap-1 replica can still
        stream): a burst of long-lived streams saturating every replica
        slot would starve unary traffic until a stream ends. At the
        stream cap the call raises OverloadedError BEFORE the first
        yield (the consumer sees it as the stream's first item — the
        proxy can still shed with a clean 503 because no response byte
        exists yet) instead of queueing past the cap. A deadline that
        expires mid-stream raises DeadlineExceededError between yields
        (the proxy's documented terminal frame)."""
        from ray_tpu_torch.serve.multiplex import _current_model_id

        deadline = self._check_deadline(deadline_s)
        with self._ongoing_lock:
            if self._max_streams and self._streams >= self._max_streams:
                raise slo.OverloadedError(
                    f"replica stream capacity exhausted "
                    f"({self._streams}/{self._max_streams} streams)")
            if self._max_ongoing and self._ongoing >= self._max_ongoing:
                # the overall request cap binds streams too — now that
                # streams reject pre-first-yield, admitting past it would
                # let stream bursts exceed the configured concurrency
                raise slo.OverloadedError(
                    f"replica capacity exhausted "
                    f"({self._ongoing}/{self._max_ongoing} requests)")
            self._streams += 1
            self._ongoing += 1
            self._ongoing_peak = max(self._ongoing_peak, self._ongoing)
        token = _current_model_id.set(multiplexed_model_id)
        dtoken = slo._request_deadline.set(deadline)
        try:
            if method == "__call__":
                out = self._callable(*args, **kwargs)
            else:
                out = getattr(self._callable, method)(*args, **kwargs)
            for item in out:
                if deadline is not None and deadline.expired():
                    raise slo.DeadlineExceededError(
                        "request deadline exceeded mid-stream")
                yield item
        finally:
            slo._request_deadline.reset(dtoken)
            _current_model_id.reset(token)
            with self._ongoing_lock:
                self._streams -= 1
                self._ongoing -= 1

    def multiplexed_model_ids(self) -> list:
        from ray_tpu_torch.serve.multiplex import replica_multiplexed_model_ids

        return replica_multiplexed_model_ids(self._callable)

    def reconfigure(self, user_config: Dict) -> bool:
        if hasattr(self._callable, "reconfigure"):
            self._callable.reconfigure(user_config)
        return True

    def health_check(self) -> bool:
        return True


class _DeploymentState:
    """Controller-side record for one deployment (reference:
    deployment_state.py:2820, radically reduced)."""

    def __init__(self, name: str, spec: dict):
        self.name = name
        self.spec = spec  # serialized_target, init_args/kwargs, options...
        self.replicas: List[Any] = []
        self.draining: List[tuple] = []  # (actor, kill_after_ts)
        # handle-reported ongoing requests: handle_id -> (count, ts)
        self.handle_metrics: Dict[str, tuple] = {}
        self.last_scale_up = 0.0
        self.last_scale_down = 0.0
        self.version = 1

    @property
    def autoscaling(self) -> Optional[dict]:
        return self.spec.get("autoscaling_config")

    def total_ongoing(self, now: float) -> float:
        return sum(
            c for c, ts in self.handle_metrics.values() if now - ts < 5.0
        )


@ray_tpu_torch.remote(max_concurrency=256)
class ServeController:
    """Reference: controller.py:127. A reconcile thread drives autoscaling;
    long-poll listeners get pushed new replica sets (long_poll.py:318)."""

    _RECONCILE_PERIOD_S = 0.25
    _DRAIN_GRACE_S = 3.0
    # a replica retired on SUSPICION (failed health check) keeps running
    # long enough for in-flight streams to finish before the reap
    _SUSPECT_REAP_GRACE_S = 30.0

    def __init__(self):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)  # notifies long-pollers
        self._deployments: Dict[str, _DeploymentState] = {}
        self._stopped = False
        threading.Thread(
            target=self._reconcile_loop, daemon=True, name="serve-reconcile"
        ).start()

    # -- deployment lifecycle ------------------------------------------
    def deploy(self, name: str, spec: dict) -> dict:
        # build the new state FULLY before publishing it — the reconcile
        # loop must never see a half-deployed state (it would race the
        # initial replica start and orphan actors)
        st = _DeploymentState(name, spec)
        auto = spec.get("autoscaling_config")
        if auto is not None:
            n = auto.get("initial_replicas")
            if n is None:
                n = auto.get("min_replicas", 1)
        else:
            n = spec["num_replicas"]
        st.replicas = [self._start_replica(st) for i in range(n)]
        ray_tpu_torch.get([r.health_check.remote() for r in st.replicas], timeout=300)
        st.version += 1
        with self._lock:
            old = self._deployments.get(name)
            if old is not None:
                # carry the old version's drain queue so its replicas are
                # still reaped; retire its serving replicas now
                st.draining.extend(old.draining)
                now = time.monotonic()
                st.draining.extend(
                    (a, now + self._DRAIN_GRACE_S) for a in old.replicas
                )
            self._deployments[name] = st
            self._cv.notify_all()
        return self._snapshot_locked_free(name)

    def _start_replica(self, st: _DeploymentState):
        spec = st.spec
        opts = spec.get("ray_actor_options") or {}
        return Replica.options(
            # headroom over the request cap so the accept-or-reject check
            # itself never queues behind executing requests
            max_concurrency=max(2, spec["max_ongoing_requests"]) + 4,
            # survive node churn: a drained node's replicas migrate via
            # the DrainActor protocol instead of dying with it —
            # handles cover the restart window with idempotent retry
            max_restarts=int(opts.get("max_restarts", 2)),
            num_cpus=opts.get("num_cpus"),
            num_gpus=opts.get("num_gpus", 0),
            num_tpus=opts.get("num_tpus", 0),
            resources=opts.get("resources"),
        ).remote(
            spec["serialized_target"], spec["init_args"], spec["init_kwargs"],
            spec.get("user_config"),
            max_ongoing_requests=spec["max_ongoing_requests"],
        )

    def _kill(self, actor) -> None:
        try:
            ray_tpu_torch.kill(actor)
        except Exception:  # noqa: BLE001
            pass

    def delete(self, name: str) -> bool:
        with self._lock:
            st = self._deployments.pop(name, None)
            if st is not None:
                self._cv.notify_all()
        if st:
            for a in st.replicas:
                self._kill(a)
            for a, _ in st.draining:
                self._kill(a)
        return st is not None

    def shutdown(self) -> bool:
        with self._lock:
            self._stopped = True
        for name in list(self._deployments):
            self.delete(name)
        return True

    def list_deployments(self) -> List[str]:
        with self._lock:
            return list(self._deployments)

    # -- handle-facing --------------------------------------------------
    def _snapshot_locked_free(self, name: str) -> Optional[dict]:
        with self._lock:
            st = self._deployments.get(name)
            if st is None:
                return None
            return {
                "replicas": list(st.replicas),
                "max_ongoing_requests": st.spec["max_ongoing_requests"],
                "version": st.version,
                "streaming_methods": st.spec.get("streaming_methods", []),
            }

    def get_deployment(self, name: str) -> Optional[dict]:
        return self._snapshot_locked_free(name)

    def listen_for_change(self, name: str, known_version: int,
                          timeout_s: float = 20.0) -> Optional[dict]:
        """Long-poll: block until the deployment's version moves past
        known_version (reference: LongPollHost long_poll.py:318)."""
        deadline = time.monotonic() + timeout_s
        with self._cv:
            while True:
                st = self._deployments.get(name)
                if st is None:
                    return None
                if st.version > known_version:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(timeout=remaining)
        return self._snapshot_locked_free(name)

    def report_handle_metrics(self, name: str, handle_id: str, ongoing: float) -> bool:
        """Handles push their in-flight request counts; this is the
        autoscaler's signal (reference: autoscaling_state.py:340)."""
        with self._lock:
            st = self._deployments.get(name)
            if st is None:
                return False
            st.handle_metrics[handle_id] = (float(ongoing), time.monotonic())
        return True

    def _actor_state(self, actor_id_hex: str) -> Optional[str]:
        """The GCS's view of a replica actor — the drain-awareness
        signal: a RESTARTING actor is mid-migration (graceful
        drain), not dead."""
        try:
            from ray_tpu_torch._private import worker as worker_mod

            info = worker_mod._require_connected().core.gcs.call(
                "GetActorInfo", actor_id=actor_id_hex, timeout=10)
            return None if info is None else info.get("state")
        except Exception:  # noqa: BLE001 — GCS blip: unknown state
            return None

    def report_replica_down(self, name: str, actor_id_hex: str) -> bool:
        """A handle observed this replica fail. Verify before acting —
        two distinct cases, and killing in the wrong one destroys a
        live stream:

        * the replica's actor is RESTARTING/PENDING in the GCS — the
          drain is migrating it off a preempted node; it will come
          back at a new address. Do nothing (the reporting handle's
          down-mark, which has a TTL, reroutes its own traffic).
        * the actor is gone, DEAD, or ALIVE-but-hung (fails a health
          check twice over) — retire it, bump the version so every
          handle reroutes, and let the reconcile loop top back up."""
        with self._lock:
            st = self._deployments.get(name)
            if st is None:
                return False
            victim = next((a for a in st.replicas
                           if a._actor_id.hex() == actor_id_hex), None)
        if victim is None:
            return False  # already retired (or a stale report)
        state = self._actor_state(actor_id_hex)
        if state in ("RESTARTING", "PENDING"):
            return False  # planned migration — the replica comes back
        if state != "DEAD":
            try:
                ray_tpu_torch.get(victim.health_check.remote(), timeout=5.0)
                return False  # alive: the handle hit a transient blip
            except Exception:  # noqa: BLE001 — dead or hung; re-check
                pass
            # the health check races the drain window: re-read the state
            # so a migration that STARTED during the check isn't killed
            state = self._actor_state(actor_id_hex)
            if state in ("RESTARTING", "PENDING"):
                return False
        with self._lock:
            st = self._deployments.get(name)
            if st is None or victim not in st.replicas:
                return False
            st.replicas = [a for a in st.replicas if a is not victim]
            # retire through the drain-grace path, NOT an instant kill:
            # a replica that merely failed a health check under load
            # (suspected, not proven dead) finishes its in-flight
            # streams inside the grace window; a truly dead one doesn't
            # care. Handles stop routing to it at the version bump.
            st.draining.append(
                (victim,
                 time.monotonic() + self._SUSPECT_REAP_GRACE_S))
            st.version += 1
            self._cv.notify_all()
        return True

    # -- autoscaling reconcile (reference: autoscaling_state.py:340) ----
    def _reconcile_loop(self) -> None:
        while True:
            time.sleep(self._RECONCILE_PERIOD_S)
            with self._lock:
                if self._stopped:
                    return
                states = list(self._deployments.values())
            for st in states:
                try:
                    self._reconcile_one(st)
                except Exception:  # noqa: BLE001
                    pass

    def _reconcile_one(self, st: _DeploymentState) -> None:
        now = time.monotonic()
        # reap drained replicas; drop handle-metrics entries gone silent
        with self._lock:
            ripe = [a for a, ts in st.draining if now >= ts]
            st.draining = [(a, ts) for a, ts in st.draining if now < ts]
            st.handle_metrics = {
                h: (c, ts) for h, (c, ts) in st.handle_metrics.items()
                if now - ts < 30.0
            }
        for a in ripe:
            # drain-aware reap: a retired-on-suspicion replica may still
            # be serving streams it accepted before (or right after) its
            # retirement — killing it would violate the mid-stream
            # contract for requests that did nothing wrong. A busy
            # replica gets its grace re-armed; only an idle or
            # unreachable one is killed.
            busy = False
            try:
                stats = ray_tpu_torch.get(a.ongoing_stats.remote(), timeout=3.0)
                busy = stats.get("ongoing", 0) > 0
            except Exception:  # noqa: BLE001 — dead/unreachable: reap
                pass
            if busy:
                with self._lock:
                    st.draining.append((a, now + 10.0))
            else:
                self._kill(a)
        auto = st.autoscaling
        # repair: a replica retired by report_replica_down (node died /
        # was preempted) is replaced here, below any autoscale delay —
        # capacity lost to churn comes back as fast as actors start
        floor = int(auto.get("min_replicas", 1)) if auto \
            else int(st.spec.get("num_replicas", 1))
        with self._lock:
            short = floor - len(st.replicas)
        if short > 0:
            new = [self._start_replica(st) for _ in range(short)]
            try:
                ray_tpu_torch.get([r.health_check.remote() for r in new],
                            timeout=300)
            except Exception:  # noqa: BLE001 — failed starts retried
                for a in new:  # next reconcile tick; don't publish them
                    self._kill(a)
                return
            with self._lock:
                st.replicas.extend(new)
                st.version += 1
                self._cv.notify_all()
        if not auto:
            return
        target = max(0.1, float(auto.get("target_ongoing_requests", 2.0)))
        lo = int(auto.get("min_replicas", 1))
        hi = int(auto.get("max_replicas", 8))
        up_delay = float(auto.get("upscale_delay_s", 0.5))
        down_delay = float(auto.get("downscale_delay_s", 2.0))
        with self._lock:
            ongoing = st.total_ongoing(now)
            n = len(st.replicas)
        desired = min(hi, max(lo, math.ceil(ongoing / target)))
        if desired > n and now - st.last_scale_up >= up_delay:
            new = [self._start_replica(st) for _ in range(desired - n)]
            try:
                ray_tpu_torch.get([r.health_check.remote() for r in new], timeout=300)
            except Exception:  # noqa: BLE001
                for a in new:
                    self._kill(a)
                return
            with self._lock:
                st.replicas.extend(new)
                st.version += 1
                st.last_scale_up = now
                self._cv.notify_all()
        elif desired < n and now - st.last_scale_down >= down_delay:
            with self._lock:
                victims = st.replicas[desired:]
                st.replicas = st.replicas[:desired]
                # drain: handles stop routing after the version bump; the
                # replica is killed after a grace for in-flight requests
                st.draining.extend(
                    (a, now + self._DRAIN_GRACE_S) for a in victims
                )
                st.version += 1
                st.last_scale_down = now
                self._cv.notify_all()


# ---------------------------------------------------------------------------
# Module-level client API (reference: serve/api.py)
# ---------------------------------------------------------------------------
_state = threading.local()


def _controller():
    ctl = getattr(_state, "controller", None)
    if ctl is None:
        try:
            ctl = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        except Exception:
            ctl = ServeController.options(name=CONTROLLER_NAME, get_if_exists=True).remote()
        _state.controller = ctl
    return ctl


def run(app: Application, *, name: Optional[str] = None,
        route_prefix: Optional[str] = None,
        local_testing_mode: bool = False, **_ignored) -> DeploymentHandle:
    """Deploy the application; returns a live-updating handle
    (reference: serve.run api.py:930). ``local_testing_mode`` runs the
    deployment in-process with no cluster (reference:
    serve/_private/local_testing_mode.py)."""
    import inspect

    if local_testing_mode:
        from ray_tpu_torch.serve.local_mode import run_local

        return run_local(app)

    from ray_tpu_torch._private.serialization import dumps_function

    dep: Deployment = app.deployment
    cfg = dep._config
    target = dep._target
    streaming_methods = []
    if isinstance(target, type):
        for m in dir(target):
            if not m.startswith("_") or m == "__call__":
                fn = getattr(target, m, None)
                if callable(fn) and inspect.isgeneratorfunction(fn):
                    streaming_methods.append(m)
    elif inspect.isgeneratorfunction(target):
        streaming_methods.append("__call__")
    spec = {
        "serialized_target": dumps_function(target),
        "init_args": app.init_args,
        "init_kwargs": app.init_kwargs,
        "num_replicas": cfg.num_replicas,
        "max_ongoing_requests": cfg.max_ongoing_requests,
        "ray_actor_options": cfg.ray_actor_options,
        "user_config": cfg.user_config,
        "autoscaling_config": cfg.autoscaling_config,
        "streaming_methods": streaming_methods,
    }
    ctl = _controller()
    snapshot = ray_tpu_torch.get(ctl.deploy.remote(cfg.name, spec), timeout=600)
    return DeploymentHandle(cfg.name, ctl, snapshot)


def get_app_handle(name: str) -> DeploymentHandle:
    ctl = _controller()
    snapshot = ray_tpu_torch.get(ctl.get_deployment.remote(name), timeout=60)
    if snapshot is None:
        raise ValueError(f"No deployment named {name!r}")
    return DeploymentHandle(name, ctl, snapshot)


def delete(name: str) -> None:
    ray_tpu_torch.get(_controller().delete.remote(name), timeout=120)


def shutdown() -> None:
    from ray_tpu_torch.serve.http_proxy import stop_http_proxy

    stop_http_proxy()
    ctl = getattr(_state, "controller", None)
    try:
        ctl = ctl or ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except Exception:
        return
    try:
        ray_tpu_torch.get(ctl.shutdown.remote(), timeout=60)
        ray_tpu_torch.kill(ctl)
    except Exception:
        pass  # controller already dead/killed — shutdown is idempotent
    _state.controller = None


def status() -> Dict[str, Any]:
    ctl = _controller()
    return {"deployments": ray_tpu_torch.get(ctl.list_deployments.remote(), timeout=60)}
