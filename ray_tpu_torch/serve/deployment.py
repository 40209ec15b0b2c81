"""Deployment decorator + handle (copy of ray_tpu/serve/deployment.py;
reference: serve/api.py @serve.deployment, serve/handle.py
DeploymentHandle).

A deployment is a replicated actor class. The handle routes calls to
replicas with power-of-two-choices on outstanding requests (reference:
request_router/pow_2_router.py:27), keeps its replica set fresh via a
long-poll listener on the controller (long_poll.py:318), and pushes its
in-flight counts back as the autoscaling signal (autoscaling_state.py:340).
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.exceptions import (
    ActorDiedError,
    ActorUnavailableError,
    GetTimeoutError,
    ObjectLostError,
    RayActorError,
    WorkerCrashedError,
)
from ray_tpu_torch.serve import slo

# failures that mean "this replica (or its node) is gone / unreachable"
# — retryable on another replica for idempotent requests; the drain
# protocol surfaces a draining replica's loss through exactly these
# (actor migrated: ActorUnavailable/RayActorError window; node hard-kill
# at the preemption deadline: ActorDied/Connection/ObjectLost).
REPLICA_FAILURES = (RayActorError, ActorDiedError, ActorUnavailableError,
                    WorkerCrashedError, ObjectLostError, ConnectionError)


@dataclasses.dataclass
class DeploymentConfig:
    name: str
    num_replicas: int = 1
    max_ongoing_requests: int = 16
    ray_actor_options: Dict[str, Any] = dataclasses.field(default_factory=dict)
    user_config: Optional[Dict[str, Any]] = None
    # {"min_replicas", "max_replicas", "target_ongoing_requests",
    #  "upscale_delay_s", "downscale_delay_s", "initial_replicas"}
    autoscaling_config: Optional[Dict[str, Any]] = None


class Deployment:
    """Result of @serve.deployment on a class/function; `.bind(*args)`
    produces an Application to pass to serve.run (reference: DAG-style
    app building, serve/api.py)."""

    def __init__(self, target: Any, config: DeploymentConfig):
        self._target = target
        self._config = config

    @property
    def name(self) -> str:
        return self._config.name

    def options(self, **kwargs) -> "Deployment":
        cfg = dataclasses.replace(self._config)
        for k, v in kwargs.items():
            if k == "name":
                cfg.name = v
            elif k == "num_replicas":
                cfg.num_replicas = v
            elif k == "max_ongoing_requests":
                cfg.max_ongoing_requests = v
            elif k == "ray_actor_options":
                cfg.ray_actor_options = v
            elif k == "user_config":
                cfg.user_config = v
            elif k == "autoscaling_config":
                cfg.autoscaling_config = v
            else:
                raise ValueError(f"Unknown deployment option {k}")
        return Deployment(self._target, cfg)

    def bind(self, *args, **kwargs) -> "Application":
        return Application(self, args, kwargs)


class Application:
    def __init__(self, deployment: Deployment, init_args, init_kwargs):
        self.deployment = deployment
        self.init_args = init_args
        self.init_kwargs = init_kwargs


def deployment(_target=None, *, name: Optional[str] = None, num_replicas: int = 1,
               max_ongoing_requests: int = 16,
               ray_actor_options: Optional[Dict[str, Any]] = None,
               user_config: Optional[Dict[str, Any]] = None,
               autoscaling_config: Optional[Dict[str, Any]] = None,
               **_ignored):
    """@serve.deployment (reference: serve/api.py)."""

    def deco(target):
        cfg = DeploymentConfig(
            name=name or getattr(target, "__name__", "deployment"),
            num_replicas=num_replicas,
            max_ongoing_requests=max_ongoing_requests,
            ray_actor_options=ray_actor_options or {},
            user_config=user_config,
            autoscaling_config=autoscaling_config,
        )
        return Deployment(target, cfg)

    return deco(_target) if _target is not None else deco


class _ReplicaSet:
    """Caller-side routing state for one deployment version."""

    def __init__(self, actors: List[Any], max_ongoing: int):
        self.actors = list(actors)
        self.max_ongoing = max_ongoing
        self.outstanding = [0] * len(actors)
        self.lock = threading.Lock()
        # replicas observed dead/unreachable by this handle's own calls:
        # routed AROUND until the controller publishes a fresh replica
        # set (version bump swaps the whole _ReplicaSet). The drain
        # protocol surfaces a preempted node's replicas here via
        # failed calls — the handle reroutes without waiting for the
        # controller's health sweep. Marks carry a TTL: a replica that
        # was merely MIGRATING off a drained node (same actor id, new
        # address) re-enters rotation after probation instead of being
        # shunned until the next version bump.
        self.down: Dict[int, float] = {}
        # routing randomness is seeded (RC004): soak/chaos runs replay
        self.rng = random.Random(0)
        # model id -> replica idx: cache-aware routing for multiplexed
        # models (reference: multiplexed model routing prefers replicas
        # that already hold the model). Learned from this handle's own
        # routing; dies with the replica set, so scaling resets it.
        self.model_affinity: Dict[str, int] = {}

    _DOWN_TTL_S = 10.0

    def mark_down(self, idx: int) -> None:
        with self.lock:
            if 0 <= idx < len(self.actors):
                self.down[idx] = time.monotonic()

    def alive_indices(self) -> List[int]:
        now = time.monotonic()
        return [i for i in range(len(self.actors))
                if i not in self.down
                or now - self.down[i] >= self._DOWN_TTL_S]

    def pick(self) -> int:
        """Power-of-two-choices by outstanding count among live
        replicas (reference: pow_2_router.py:27)."""
        with self.lock:
            return self._pick_locked()

    def _pick_locked(self) -> int:
        cands = self.alive_indices() or list(range(len(self.actors)))
        if len(cands) == 1:
            idx = cands[0]
        else:
            i, j = self.rng.sample(cands, 2)
            idx = i if self.outstanding[i] <= self.outstanding[j] else j
        self.outstanding[idx] += 1
        return idx

    def pick_for_model(self, model_id: str,
                       avoid: Optional[int] = None) -> int:
        """Prefer the replica that already loaded model_id; a COLD model
        goes to the replica with the fewest models pinned — tie-broken
        by outstanding load — so replica LRUs hold disjoint model sets
        (reference: multiplex routing balances model placement, not just
        request load — pure pow-2 on cold models lands several on one
        replica ~25% of the time and thrashes its LRU). ``avoid`` is the
        replica that just REJECTED this request: it must not win the
        re-pick even when its pin count is lowest, or the retry loop
        would ping-pong against a saturated replica while others idle."""
        with self.lock:
            alive = self.alive_indices() or list(range(len(self.actors)))
            idx = self.model_affinity.get(model_id)
            if idx is not None and 0 <= idx < len(self.actors) \
                    and idx != avoid and idx in alive:
                self.outstanding[idx] += 1
                return idx
            counts = [0] * len(self.actors)
            for i in self.model_affinity.values():
                if 0 <= i < len(counts):
                    counts[i] += 1
            cands = [i for i in alive if i != avoid] or alive
            best = min((counts[i], self.outstanding[i]) for i in cands)
            idx = self.rng.choice(
                [i for i in cands
                 if (counts[i], self.outstanding[i]) == best])
            self.outstanding[idx] += 1
            self.model_affinity[model_id] = idx
            return idx

    def release(self, idx: int) -> None:
        with self.lock:
            if 0 <= idx < len(self.outstanding):
                self.outstanding[idx] -= 1

    def total_outstanding(self) -> int:
        with self.lock:
            return sum(self.outstanding)


class DeploymentResponse:
    """Future-like result (reference: handle.py DeploymentResponse).

    Two transparent retry axes, both deadline-bounded:

    * replica-side **rejection** (at-capacity sentinel, reference
      replica.py:1630) — re-route to another replica with jittered
      exponential backoff; past the budget the caller sees
      :class:`~ray_tpu_torch.serve.slo.OverloadedError`.
    * replica **failure** (died / unreachable / draining node hard-
      killed) — idempotent unary requests are re-dispatched around the
      dead replica (it is marked down in the router and reported to the
      controller); after ``RetryPolicy.max_attempts`` the caller sees
      :class:`~ray_tpu_torch.serve.slo.ReplicasUnavailableError`.

    A replica-raised :class:`~ray_tpu_torch.serve.slo.DeadlineExceededError`
    (or a deadline expiring caller-side) is terminal — retrying a
    request with no budget left only adds load."""

    _policy = slo.RetryPolicy()  # shared default; seeded (RC004)

    def __init__(self, ref, on_done: Callable[[], None],
                 retry: Optional[Callable[[], "DeploymentResponse"]] = None,
                 on_failure: Optional[Callable[[], None]] = None,
                 deadline: Optional[slo.Deadline] = None):
        self._ref = ref
        self._on_done = on_done
        self._done = False
        self._retry = retry
        self._on_failure = on_failure  # mark-down + report hook
        self._deadline = deadline
        # requests are idempotent by default (the serve contract);
        # callers that can't tolerate a re-execution clear this —
        # rejection retry stays on (a rejected request never ran)
        self.retry_on_failure = True

    # -- shared retry state machine ------------------------------------
    def _classify(self, out, exc, attempt: int, remaining: Optional[float]):
        """Decide the next step from one attempt's outcome. Returns
        ("return", value) | ("raise", exc) | ("retry", backoff_s)."""
        from ray_tpu_torch.serve.controller import _Rejected

        if exc is None:
            if not isinstance(out, _Rejected):
                return ("return", out)
            # definitively rejected; retry elsewhere — unless the
            # deadline can't absorb another roundtrip, in which case
            # overload IS the caller's story
            if self._retry is None or (
                    remaining is not None and remaining < 0.5):
                return ("raise", slo.OverloadedError(
                    "deployment overloaded: all replicas at "
                    "max_ongoing_requests",
                    retry_after_s=1.0))
            return ("retry", self._policy.backoff(attempt))
        if isinstance(exc, slo.DeadlineExceededError):
            return ("raise", exc)  # no budget left anywhere
        if isinstance(exc, REPLICA_FAILURES) and not isinstance(
                exc, slo.ReplicasUnavailableError):
            if self._on_failure is not None:
                self._on_failure()  # mark down + report controller
            if not self.retry_on_failure:
                return ("raise", exc)
            if self._retry is None or attempt + 1 >= self._policy.max_attempts \
                    or (remaining is not None and remaining < 0.2):
                return ("raise", slo.ReplicasUnavailableError(
                    f"replica failed and retry budget exhausted "
                    f"(attempt {attempt + 1}): {exc}"))
            return ("retry", self._policy.backoff(attempt))
        return ("raise", exc)

    def result(self, timeout: Optional[float] = None):
        """Resolve, transparently retrying rejection and replica death.
        ``timeout`` keeps its historical GetTimeoutError semantics; the
        request deadline (when set) additionally bounds every wait and
        surfaces as DeadlineExceededError."""
        deadline = None if timeout is None else time.monotonic() + timeout
        resp: "DeploymentResponse" = self
        attempt = 0
        while True:
            remaining = None if deadline is None \
                else max(0.001, deadline - time.monotonic())
            if resp._deadline is not None:
                req_rem = resp._deadline.remaining()
                remaining = req_rem if remaining is None \
                    else min(remaining, max(0.001, req_rem))
                if req_rem <= 0:
                    resp._release()
                    raise slo.DeadlineExceededError(
                        "request deadline exceeded before a replica "
                        "produced a result")
            out, exc = None, None
            try:
                # a GetTimeoutError here propagates as-is: the in-flight
                # attempt may well be ACCEPTED and merely slow —
                # claiming "overloaded" would misdiagnose it
                out = ray_tpu_torch.get(resp._ref, timeout=remaining)
            except Exception as e:  # noqa: BLE001 — classified below
                exc = e
            finally:
                resp._release()
            if exc is not None and isinstance(exc, GetTimeoutError):
                if resp._deadline is not None and resp._deadline.expired():
                    raise slo.DeadlineExceededError(
                        "request deadline exceeded while waiting on the "
                        "replica") from None
                raise exc
            rem_now = None if deadline is None \
                else deadline - time.monotonic()
            if resp._deadline is not None:
                r2 = resp._deadline.remaining()
                rem_now = r2 if rem_now is None else min(rem_now, r2)
            step, val = resp._classify(out, exc, attempt, rem_now)
            if step == "return":
                return val
            if step == "raise":
                raise val
            time.sleep(val if rem_now is None else min(val, rem_now / 2))
            attempt += 1
            nxt = resp._retry()
            nxt.retry_on_failure = resp.retry_on_failure
            resp = nxt

    async def result_async(self):
        """Async resolve for proxy-loop callers — same retry semantics
        as :meth:`result`, waiting on the event loop via the owned-
        object future instead of parking an executor thread per request
        (the fast path: the result lands in the memory store
        off the fastpath-coded RPC loop; we await that arrival
        directly)."""
        resp: "DeploymentResponse" = self
        attempt = 0
        while True:
            if resp._deadline is not None and resp._deadline.expired():
                resp._release()
                raise slo.DeadlineExceededError(
                    "request deadline exceeded before a replica produced "
                    "a result")
            remaining = None if resp._deadline is None \
                else max(0.001, resp._deadline.remaining())
            out, exc = None, None
            try:
                out = await _resolve_ref_async(resp._ref, remaining)
            except Exception as e:  # noqa: BLE001 — classified below
                exc = e
            finally:
                resp._release()
            if exc is not None and isinstance(exc, GetTimeoutError):
                raise slo.DeadlineExceededError(
                    "request deadline exceeded while waiting on the "
                    "replica") from None
            rem_now = None if resp._deadline is None \
                else resp._deadline.remaining()
            step, val = resp._classify(out, exc, attempt, rem_now)
            if step == "return":
                return val
            if step == "raise":
                raise val
            import asyncio

            await asyncio.sleep(val if rem_now is None
                                else min(val, rem_now / 2))
            attempt += 1
            nxt = resp._retry()
            nxt.retry_on_failure = resp.retry_on_failure
            resp = nxt

    def _release(self):
        if not self._done:
            self._done = True
            self._on_done()

    def _to_object_ref(self):
        return self._ref


async def _resolve_ref_async(ref, timeout: Optional[float]):
    """Await an owned ObjectRef on the calling event loop.

    Fast path: the result is pushed into this process's memory store by
    the RPC loop (inline payload over the fastpath codec); we await that
    future and deserialize in place — no executor-thread handoff per
    request. Plasma-located results (large values, zero-copy segments)
    and borrowed refs fall back to one executor hop for the blocking
    read."""
    import asyncio

    from ray_tpu_torch._private import worker as worker_mod

    core = worker_mod._require_connected().core
    oid = ref.id()
    deadline = None if timeout is None else time.monotonic() + timeout
    while True:
        entry = core.memory_store.get_if_exists(oid)
        if entry is not None:
            kind = entry.value[0] if isinstance(entry.value, tuple) else None
            if kind == "inline":
                # raises the task's error (RayTaskError cause) in place
                return core._deserialize_entry(oid, entry.value)
            break  # plasma (or exotic) — blocking read path below
        if not core._ref_counter().is_owned(oid):
            break  # borrowed: the full get() protocol handles owners
        fut = core.memory_store.as_future(oid)
        remaining = None if deadline is None else deadline - time.monotonic()
        if remaining is not None and remaining <= 0:
            raise GetTimeoutError(f"Get timed out for {oid.hex()}")
        try:
            # timeout-cancel is safe: memory_store skips done futures
            await asyncio.wait_for(asyncio.wrap_future(fut),
                                   timeout=remaining)
        except asyncio.TimeoutError:
            raise GetTimeoutError(
                f"Get timed out for {oid.hex()}") from None
        except Exception:  # noqa: BLE001 — error entries re-read below
            pass  # the loop re-reads the entry and raises properly
    remaining = None if deadline is None \
        else max(0.001, deadline - time.monotonic())
    loop = asyncio.get_event_loop()
    import functools

    return await loop.run_in_executor(
        None, functools.partial(ray_tpu_torch.get, ref, timeout=remaining))


class DeploymentHandle:
    """Reference: serve/handle.py:1041. handle.method.remote(args) →
    DeploymentResponse; plain handle.remote() calls __call__. Streaming
    methods return an ObjectRefGenerator of per-yield refs.

    Background threads keep the handle live: a long-poll listener swaps in
    new replica sets when the controller scales the deployment, and a
    metrics pusher reports this handle's in-flight counts (the autoscaling
    signal)."""

    _METRICS_PERIOD_S = 0.5

    def __init__(self, name: str, controller, snapshot: dict):
        self._name = name
        self._controller = controller
        self._handle_id = uuid.uuid4().hex[:16]
        self._version = snapshot["version"]
        self._streaming_methods = set(snapshot.get("streaming_methods") or [])
        self._rs = _ReplicaSet(snapshot["replicas"], snapshot["max_ongoing_requests"])
        self._closed = False
        # background threads hold only a WEAKREF to the handle — a strong
        # self-reference would keep every (un)pickled handle, and its two
        # threads plus its controller long-poll slot, alive forever
        import weakref

        ref = weakref.ref(self)
        for fn, nm in ((_handle_long_poll_loop, "poll"), (_handle_metrics_loop, "metrics")):
            threading.Thread(
                target=fn, args=(ref,), daemon=True,
                name=f"serve-handle-{nm}-{name}",
            ).start()

    def close(self) -> None:
        """Stop the background threads; the handle stops tracking scaling."""
        self._closed = True

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass

    # -- calls ----------------------------------------------------------
    def __getattr__(self, method: str) -> "_HandleMethod":
        if method.startswith("_"):
            raise AttributeError(method)
        return _HandleMethod(self, method)

    def options(self, *, multiplexed_model_id: str = "",
                timeout_s: Optional[float] = None,
                **_ignored) -> "_HandleOptions":
        """Per-call options (reference: handle.options):
        multiplexed_model_id routes to a replica that already holds the
        model and sets serve.get_multiplexed_model_id() there;
        ``timeout_s`` attaches a per-request deadline carried through to
        the replica (every wait on the call path derives from it)."""
        deadline = None if timeout_s is None else slo.Deadline(timeout_s)
        return _HandleOptions(self, multiplexed_model_id, deadline)

    def remote(self, *args, **kwargs):
        return _HandleMethod(self, "__call__").remote(*args, **kwargs)

    def _report_replica_down(self, rs: "_ReplicaSet", idx: int) -> None:
        """This handle observed replica ``idx`` fail: route around it
        now and tell the controller (fire-and-forget — the controller
        health-checks before replacing, so a false report is cheap)."""
        rs.mark_down(idx)
        try:
            actor = rs.actors[idx]
            self._controller.report_replica_down.remote(
                self._name, actor._actor_id.hex())
        except Exception:  # noqa: BLE001 — reporting is best-effort;
            pass  # the down-mark already reroutes this handle

    def _call(self, method: str, args, kwargs, model_id: str = "",
              deadline: Optional[slo.Deadline] = None):
        from ray_tpu_torch.observability import tracing as obs_tracing

        rs = self._rs
        idx = rs.pick_for_model(model_id) if model_id else rs.pick()
        actor = rs.actors[idx]
        # relative remaining budget at submit: the replica re-anchors it
        # on arrival (queue time there still counts; clock skew doesn't)
        deadline_s = None if deadline is None else deadline.remaining()
        # request span: the replica-side execution span parents to this
        # one (the trace context is injected into the actor submit below
        # while the span is active) — so a trace shows proxy→replica
        # hops. One enabled-check when tracing is off.
        with obs_tracing.span(
                "serve.request", kind="serve",
                attrs={"deployment": self._name, "method": method,
                       "replica": idx}):
            if method in self._streaming_methods:
                gen = actor.handle_request_streaming.remote(
                    method, args, kwargs, model_id, deadline_s)
                # the stream holds the routing slot until it completes or
                # is dropped — otherwise streaming load is invisible to
                # pow-2 routing and the autoscaler
                gen._set_close_callback(lambda: rs.release(idx))
                gen._replica_idx = idx  # proxy retry needs the loser
                gen._replica_set = rs
                return gen
            ref = actor.handle_request_with_rejection.remote(
                method, args, kwargs, model_id, deadline_s)
        return DeploymentResponse(
            ref, on_done=lambda: rs.release(idx),
            # rejection re-pick goes through the LIVE handle state: a
            # scale-up between attempts routes to the new replicas
            retry=lambda: self._retry_after_rejection(
                method, args, kwargs, model_id, rejected_idx=idx,
                deadline=deadline),
            on_failure=lambda: self._report_replica_down(rs, idx),
            deadline=deadline)

    def _retry_after_rejection(self, method, args, kwargs, model_id,
                               rejected_idx: Optional[int] = None,
                               deadline: Optional[slo.Deadline] = None):
        if model_id:
            rs = self._rs
            with rs.lock:
                # the pin points at the replica that just rejected us —
                # drop it so the cold path (which excludes that
                # replica) routes elsewhere; the new replica cold-loads
                # the model, the right trade under overload
                if rs.model_affinity.get(model_id) == rejected_idx:
                    rs.model_affinity.pop(model_id, None)
            idx = rs.pick_for_model(model_id, avoid=rejected_idx)
            actor = rs.actors[idx]
            deadline_s = None if deadline is None else deadline.remaining()
            ref = actor.handle_request_with_rejection.remote(
                method, args, kwargs, model_id, deadline_s)
            return DeploymentResponse(
                ref, on_done=lambda: rs.release(idx),
                retry=lambda: self._retry_after_rejection(
                    method, args, kwargs, model_id, rejected_idx=idx,
                    deadline=deadline),
                on_failure=lambda: self._report_replica_down(rs, idx),
                deadline=deadline)
        return self._call(method, args, kwargs, model_id, deadline=deadline)

    def __reduce__(self):
        return (_rebuild_handle, (self._name,))

    def __repr__(self) -> str:
        return f"DeploymentHandle({self._name}, replicas={len(self._rs.actors)})"


def _handle_long_poll_loop(handle_ref) -> None:
    while True:
        h = handle_ref()
        if h is None or h._closed:
            return
        controller, name, version = h._controller, h._name, h._version
        del h  # don't pin the handle across the blocking poll
        try:
            snap = ray_tpu_torch.get(
                controller.listen_for_change.remote(name, version, timeout_s=20.0),
                timeout=40,
            )
        except Exception:  # noqa: BLE001
            time.sleep(1.0)
            continue
        h = handle_ref()
        if h is None or h._closed:
            return
        if snap is None:
            time.sleep(1.0)  # deployment deleted (or being redeployed)
            continue
        if snap["version"] != h._version:
            h._version = snap["version"]
            h._streaming_methods = set(snap.get("streaming_methods") or [])
            h._rs = _ReplicaSet(snap["replicas"], snap["max_ongoing_requests"])


def _handle_metrics_loop(handle_ref) -> None:
    while True:
        time.sleep(DeploymentHandle._METRICS_PERIOD_S)
        h = handle_ref()
        if h is None or h._closed:
            return
        try:
            h._controller.report_handle_metrics.remote(
                h._name, h._handle_id, h._rs.total_outstanding()
            )
        except Exception:  # noqa: BLE001
            pass
        del h


def _rebuild_handle(name: str) -> DeploymentHandle:
    from ray_tpu_torch.serve.controller import get_app_handle

    return get_app_handle(name)


class _HandleMethod:
    def __init__(self, handle: DeploymentHandle, method: str,
                 model_id: str = "",
                 deadline: Optional[slo.Deadline] = None):
        self._handle = handle
        self._method = method
        self._model_id = model_id
        self._deadline = deadline

    def remote(self, *args, **kwargs):
        return self._handle._call(self._method, args, kwargs,
                                  self._model_id,
                                  deadline=self._deadline)


class _HandleOptions:
    """handle.options(multiplexed_model_id=..., timeout_s=...) view."""

    def __init__(self, handle: DeploymentHandle, model_id: str,
                 deadline: Optional[slo.Deadline] = None):
        self._handle = handle
        self._model_id = model_id
        self._deadline = deadline

    def __getattr__(self, method: str) -> _HandleMethod:
        if method.startswith("_"):
            raise AttributeError(method)
        return _HandleMethod(self._handle, method, self._model_id,
                             self._deadline)

    def remote(self, *args, **kwargs):
        return _HandleMethod(self._handle, "__call__",
                             self._model_id,
                             self._deadline).remote(*args, **kwargs)
