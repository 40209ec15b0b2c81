"""Streaming operator-graph executor for Dataset map stages (PyTorch
port of ray_tpu/data/_internal/streaming_executor.py).

Reference: python/ray/data/_internal/execution/streaming_executor.py:100
(operator graph with concurrent stages), backpressure_policy/ (resource
backpressure), execution/operators/map_operator.py:196 (task- and
actor-pool map operators).

Shape: a chain of map operators connected by in-memory ref queues. The
driver's scheduling loop submits block tasks for EVERY operator each
tick, so stage N+1 processes block i while stage N processes block i+1
— no barrier between stages. Three forms of backpressure bound memory:

- per-operator in-flight task budgets (concurrency caps),
- object-store pressure: while the local store is above the high
  watermark, no new tasks are submitted (completions drain it) — with a
  one-task escape hatch so an over-full store cannot deadlock progress,
- consumer pull: outputs sit in the final queue until the caller's
  iterator takes them, and the bounded queues upstream fill up behind
  it.

Tasks complete out of order; each operator tracks completions as they
land and (by default) releases them downstream in submission order, so
a straggler delays only the ordering boundary, not execution.

A stage's ``remote_args`` (``num_cpus``, ``num_gpus``, ``resources``,
``scheduling_strategy``, as Ray's ``map_batches`` takes them) go into
the options of its tasks or pool actors: a stage that asks for a card
runs where the raylet leases one.
"""

from __future__ import annotations

import collections
import logging
from typing import Any, Callable, Dict, Iterator, List, Optional

import ray_tpu_torch
from ray_tpu_torch.data._internal.executor import _apply_block_fn, _pack

logger = logging.getLogger(__name__)

# Backpressure knobs (reference: concurrency_cap_backpressure_policy.py
# and the resource-manager object-store budget).
DEFAULT_OP_CONCURRENCY = 8
STORE_HIGH_WATERMARK = 0.8
MAX_QUEUED_PER_OP = 32


@ray_tpu_torch.remote
class _MapActor:
    """Actor-pool worker for stateful transforms (reference:
    map_operator.py actor pool): the callable class is constructed ONCE
    and reused across blocks; ``wrapper(instance, block)`` carries the
    stage's batch-format/slicing logic."""

    def __init__(self, ctor_bytes: bytes, wrapper_bytes: bytes):
        from ray_tpu_torch._private.serialization import loads_function

        self._instance = loads_function(ctor_bytes)()
        self._wrapper = loads_function(wrapper_bytes)

    def apply(self, block):
        return self._wrapper(self._instance, block)


class MapOp:
    """One physical map stage: bounded in-flight tasks over blocks."""

    def __init__(self, name: str, fn: Optional[Callable] = None,
                 actor_cls: Optional[type] = None,
                 actor_wrapper: Optional[Callable] = None,
                 concurrency: int = DEFAULT_OP_CONCURRENCY,
                 preserve_order: bool = True,
                 remote_args: Optional[Dict[str, Any]] = None):
        self.name = name
        self.remote_args = dict(remote_args or {})
        self.concurrency = max(1, concurrency)
        self.preserve_order = preserve_order
        self._fn_bytes = _pack(fn) if fn is not None else None
        self._actor_cls = actor_cls
        self._actor_wrapper = actor_wrapper
        self._actors: List[Any] = []
        self._actor_load: Dict[int, int] = {}
        self.pending_in: collections.deque = collections.deque()
        self.inflight: Dict[Any, int] = {}  # ref -> submit seq
        self._inflight_actor: Dict[Any, int] = {}  # ref -> actor index
        self._ready: Dict[int, Any] = {}  # seq -> ref (completed)
        self._unordered_ready: collections.deque = collections.deque()
        self._next_seq = 0
        self._next_emit = 0
        self.input_done = False

    # -- feeding -------------------------------------------------------
    def wants_input(self) -> bool:
        return (not self.input_done
                and len(self.pending_in) < MAX_QUEUED_PER_OP)

    def add_input(self, ref: Any) -> None:
        self.pending_in.append(ref)

    def close_input(self) -> None:
        self.input_done = True

    # -- scheduling ----------------------------------------------------
    def _ensure_actors(self) -> None:
        if self._actors or self._actor_cls is None:
            return
        ctor = _pack(self._actor_cls)
        wrapper = _pack(self._actor_wrapper)
        cls = _MapActor.options(**self.remote_args) if self.remote_args \
            else _MapActor
        self._actors = [cls.remote(ctor, wrapper)
                        for _ in range(self.concurrency)]
        self._actor_load = {i: 0 for i in range(len(self._actors))}

    def schedule(self, under_pressure: bool, force_one: bool,
                 downstream_free: int) -> bool:
        """Submit tasks within budget; returns True if any submitted.
        ``downstream_free``: remaining queue slots in the next operator —
        the inter-stage backpressure bound (an upstream op must not
        produce blocks its consumer has no room to queue)."""
        submitted = False
        while self.pending_in and \
                len(self.inflight) + self._backlog() < self.concurrency:
            # _backlog counts completed-but-unemitted outputs: under
            # preserve_order a head-of-line straggler must throttle new
            # submissions, not let the ready set grow without bound
            if len(self.inflight) >= max(0, downstream_free):
                break
            if under_pressure and not (force_one and not submitted):
                break
            ref = self.pending_in.popleft()
            if self._actor_cls is not None:
                self._ensure_actors()
                idx = min(self._actor_load,
                          key=lambda i: self._actor_load[i])
                out = self._actors[idx].apply.remote(ref)
                self._actor_load[idx] += 1
                self._inflight_actor[out] = idx
            else:
                fn = _apply_block_fn.options(**self.remote_args) \
                    if self.remote_args else _apply_block_fn
                out = fn.remote(self._fn_bytes, ref)
            self.inflight[out] = self._next_seq
            self._next_seq += 1
            submitted = True
        return submitted

    def absorb_completions(self) -> bool:
        """Collect finished tasks (out-of-order) into the ready set."""
        if not self.inflight:
            return False
        refs = list(self.inflight)
        done, _ = ray_tpu_torch.wait(refs, num_returns=len(refs), timeout=0,
                               fetch_local=False)
        for r in done:
            seq = self.inflight.pop(r)
            idx = self._inflight_actor.pop(r, None)
            if idx is not None:
                self._actor_load[idx] -= 1
            if self.preserve_order:
                self._ready[seq] = r
            else:
                self._unordered_ready.append(r)
        return bool(done)

    def take_outputs(self) -> List[Any]:
        out: List[Any] = []
        if self.preserve_order:
            while self._next_emit in self._ready:
                out.append(self._ready.pop(self._next_emit))
                self._next_emit += 1
        else:
            while self._unordered_ready:
                out.append(self._unordered_ready.popleft())
        return out

    def _backlog(self) -> int:
        return len(self._ready) + len(self._unordered_ready)

    def exhausted(self) -> bool:
        return (self.input_done and not self.pending_in
                and not self.inflight and not self._ready
                and not self._unordered_ready)

    def shutdown(self) -> None:
        for a in self._actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:  # noqa: BLE001
                pass
        self._actors = []


def _store_pressure() -> bool:
    """True while the local object store is above the high watermark
    (reference: backpressure on object_store_memory usage)."""
    from ray_tpu_torch._private import worker as wm

    w = wm.global_worker
    if w is None or not getattr(w, "connected", False):
        return False
    plasma = getattr(getattr(w, "core", None), "plasma", None)
    if plasma is None:
        return False
    try:
        m = plasma.metrics()
    except Exception:  # noqa: BLE001
        return False
    cap = m.get("capacity") or 0
    return cap > 0 and m.get("allocated", 0) / cap > STORE_HIGH_WATERMARK


class StreamingExecutor:
    """Drives a chain of MapOps over a source-ref iterator, yielding
    final output refs as they become available."""

    def __init__(self, ops: List[MapOp]):
        self.ops = ops

    def execute(self, source: Iterator[Any]) -> Iterator[Any]:
        ops = self.ops
        src = iter(source)
        src_done = False
        for op in ops:
            # actor pools spin up eagerly so their (seconds-long) start
            # overlaps with upstream compute instead of serializing it
            op._ensure_actors()
        try:
            while True:
                progress = False
                pressure = _store_pressure()  # once per tick
                # feed the head operator from the source
                while not src_done and ops[0].wants_input() \
                        and not pressure:
                    try:
                        ops[0].add_input(next(src))
                        progress = True
                    except StopIteration:
                        src_done = True
                        ops[0].close_input()
                if not src_done and ops[0].wants_input() \
                        and not any(op.inflight for op in ops):
                    # escape hatch: a full store with nothing in flight
                    # must still admit one block or nothing ever drains
                    try:
                        ops[0].add_input(next(src))
                        progress = True
                    except StopIteration:
                        src_done = True
                        ops[0].close_input()
                total_inflight = sum(len(op.inflight) for op in ops)
                allow_force = total_inflight == 0  # ONE task total under
                # pressure, across all ops — not one per op
                for k, op in enumerate(ops):
                    free = (MAX_QUEUED_PER_OP - len(ops[k + 1].pending_in)
                            if k + 1 < len(ops) else MAX_QUEUED_PER_OP)
                    if op.schedule(pressure, force_one=allow_force,
                                   downstream_free=free):
                        progress = True
                        allow_force = False
                    if op.absorb_completions():
                        progress = True
                    outs = op.take_outputs()
                    if outs:
                        progress = True
                    if k + 1 < len(ops):
                        for r in outs:
                            ops[k + 1].add_input(r)
                        if op.exhausted() and not ops[k + 1].input_done:
                            ops[k + 1].close_input()
                    else:
                        yield from outs
                if all(op.exhausted() for op in ops) and src_done:
                    return
                if not progress:
                    # block until SOME inflight task finishes
                    inflight = [r for op in ops for r in op.inflight]
                    if inflight:
                        ray_tpu_torch.wait(inflight, num_returns=1, timeout=0.5,
                                     fetch_local=False)
                    # else: only queued work gated by pressure — loop
                    # re-enters schedule(force_one=...) to make progress
        finally:
            for op in ops:
                op.shutdown()
