"""In-process memory store for small objects + pending-result futures (copy of
ray_tpu/_private/memory_store.py).

Reference: src/ray/core_worker/store_provider/memory_store/memory_store.h:48
(CoreWorkerMemoryStore). Small task returns and errors land here on the
*owner* worker; ``get`` blocks on a per-object condition until the value
arrives or a timeout fires.
"""

from __future__ import annotations

import threading
import concurrent.futures
from concurrent.futures import Future
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private import debug_locks
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch.exceptions import GetTimeoutError


class _Entry:
    __slots__ = ("value", "is_exception")

    def __init__(self, value: Any, is_exception: bool):
        self.value = value
        self.is_exception = is_exception


class MemoryStore:
    def __init__(self) -> None:
        # reentrant: a garbage collection can run inside any of these
        # sections (an allocation, an ID's hash) and finalize an ObjectRef
        # whose release deletes from this store on the same thread. A
        # plain Lock deadlocked there (ROADMAP.md Queue C, the cluster hang)
        self._lock = debug_locks.maybe_wrap(
            threading.RLock(), "memory_store.MemoryStore._lock")
        self._objects: Dict[ObjectID, _Entry] = {}
        self._waiters: Dict[ObjectID, List[Future]] = {}

    def put(self, oid: ObjectID, value: Any, is_exception: bool = False) -> None:
        with self._lock:
            self._objects[oid] = _Entry(value, is_exception)
            waiters = self._waiters.pop(oid, [])
        for f in waiters:
            if not f.done():
                if is_exception:
                    f.set_exception(value)
                else:
                    f.set_result(value)

    def contains(self, oid: ObjectID) -> bool:
        with self._lock:
            return oid in self._objects

    def get_if_exists(self, oid: ObjectID) -> Optional[_Entry]:
        with self._lock:
            return self._objects.get(oid)

    def as_future(self, oid: ObjectID) -> Future:
        f: Future = Future()
        with self._lock:
            e = self._objects.get(oid)
            if e is None:
                self._waiters.setdefault(oid, []).append(f)
                return f
        if e.is_exception:
            f.set_exception(e.value)
        else:
            f.set_result(e.value)
        return f

    def get(self, oid: ObjectID, timeout: Optional[float] = None) -> Any:
        f = self.as_future(oid)
        try:
            return f.result(timeout=timeout)
        except (TimeoutError, concurrent.futures.TimeoutError):
            # 3.10: futures.TimeoutError is not the builtin — catch both
            raise GetTimeoutError(f"Get timed out for object {oid.hex()}")

    def delete(self, oid: ObjectID) -> None:
        with self._lock:
            self._objects.pop(oid, None)
            self._waiters.pop(oid, None)

    def size(self) -> int:
        with self._lock:
            return len(self._objects)
