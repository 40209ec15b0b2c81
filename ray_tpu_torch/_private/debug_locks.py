"""RAY_TPU_DEBUG_LOCKS=1 — dynamic lock-order validation (copy of
ray_tpu/_private/debug_locks.py).

The static RC002 rule (tools/raycheck/lockgraph.py) models lock
acquisition order from the AST; this module validates that model against
reality. With ``RAY_TPU_DEBUG_LOCKS=1`` in the environment, the
``maybe_wrap`` calls sprinkled on the _private module locks return an
order-recording proxy instead of the bare lock:

  * every acquisition records edges  held-lock -> new-lock  into one
    process-global order graph,
  * an acquisition that would close a cycle in that graph (thread A took
    X then Y, thread B now holds Y and asks for X) raises
    :class:`LockOrderError` at the exact acquisition site instead of
    deadlocking silently in production.

Off (the default) the cost is one ``os.environ`` check at lock-creation
time and zero per-acquisition overhead — ``maybe_wrap`` returns the raw
lock object untouched.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Set


class LockOrderError(RuntimeError):
    """An acquisition would create a lock-order cycle (potential deadlock)."""


def enabled() -> bool:
    return os.environ.get("RAY_TPU_DEBUG_LOCKS", "0").strip() in (
        "1", "true", "on")


class _OrderGraph:
    """Process-global acquisition-order graph, guarded by its own lock
    (which is never itself wrapped)."""

    def __init__(self) -> None:
        self._edges: Dict[str, Set[str]] = {}
        self._guard = threading.Lock()
        self._held = threading.local()

    def held_stack(self) -> List[str]:
        st = getattr(self._held, "stack", None)
        if st is None:
            st = self._held.stack = []
        return st

    def _path_exists(self, src: str, dst: str) -> bool:
        stack, seen = [src], {src}
        while stack:
            n = stack.pop()
            if n == dst:
                return True
            for nxt in self._edges.get(n, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append(nxt)
        return False

    def before_acquire(self, name: str) -> None:
        held = self.held_stack()
        if not held:
            return
        with self._guard:
            for h in held:
                if h == name:
                    continue  # re-entrant acquire: not an order edge
                # adding h -> name while name -> ... -> h already exists
                # means two code paths take these locks in opposite
                # orders — the cycle that deadlocks under the right race
                if self._path_exists(name, h):
                    order = " -> ".join(held + [name])
                    raise LockOrderError(
                        f"lock-order cycle: acquiring {name!r} while "
                        f"holding {held!r} (this thread: {order}), but "
                        f"{name!r} -> {h!r} was previously acquired in "
                        f"the opposite order elsewhere")
                self._edges.setdefault(h, set()).add(name)

    def after_acquire(self, name: str) -> None:
        self.held_stack().append(name)

    def after_release(self, name: str) -> None:
        st = self.held_stack()
        # release may happen on another thread or out of order — tolerate
        if name in st:
            st.reverse()
            st.remove(name)
            st.reverse()

    def reset(self) -> None:
        """Test hook: forget recorded orders."""
        with self._guard:
            self._edges.clear()


_graph = _OrderGraph()


def order_graph() -> _OrderGraph:
    return _graph


class DebugLock:
    """Order-recording proxy over a Lock/RLock. Supports the full
    surface the codebase uses: ``with``, acquire(timeout=...), release,
    locked."""

    __slots__ = ("_lock", "name")

    def __init__(self, lock, name: str):
        self._lock = lock
        self.name = name

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if blocking:
            _graph.before_acquire(self.name)
        got = self._lock.acquire(blocking, timeout)
        if got:
            _graph.after_acquire(self.name)
        return got

    def release(self) -> None:
        self._lock.release()
        _graph.after_release(self.name)

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "DebugLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<DebugLock {self.name} over {self._lock!r}>"


def maybe_wrap(lock, name: str):
    """Wrap ``lock`` in a DebugLock when RAY_TPU_DEBUG_LOCKS=1; otherwise
    return it untouched (zero overhead on the hot path)."""
    if enabled():
        return DebugLock(lock, name)
    return lock
