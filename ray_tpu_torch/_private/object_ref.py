"""ObjectRef — the future/handle for an object of the runtime (copy of
ray_tpu/_private/object_ref.py).

Reference: python/ray/includes/object_ref.pxi and src/ray/common/id.h.
An ObjectRef carries its id plus owner metadata (the address of the worker
that owns the object's lifetime — reference ownership model:
src/ray/core_worker/reference_counter.h:44). Serializing a ref through a
task argument registers a borrow with the owner.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from ray_tpu_torch._private.ids import ObjectID


class ObjectRef:
    __slots__ = ("_id", "_owner_addr", "_call_site", "__weakref__")

    def __init__(
        self,
        object_id: ObjectID,
        owner_addr: Optional[Tuple[str, int]] = None,
        call_site: str = "",
    ) -> None:
        self._id = object_id
        self._owner_addr = owner_addr
        self._call_site = call_site
        # Register with the current worker's reference counter, if connected.
        from ray_tpu_torch._private import worker as _worker_mod

        w = _worker_mod.global_worker
        if w is not None and w.connected:
            w.reference_counter.add_local_reference(self._id)
            # Borrowed ref (constructed from a deserialized payload in a
            # process that doesn't own it): register with the owner so it
            # keeps the object alive (reference_counter.h:44 borrowers).
            if owner_addr is not None:
                core = getattr(w, "core", None)
                if core is not None and hasattr(core, "on_ref_created"):
                    core.on_ref_created(self._id, tuple(owner_addr))

    # -- identity ---------------------------------------------------------
    def id(self) -> ObjectID:
        return self._id

    def binary(self) -> bytes:
        return self._id.binary()

    def hex(self) -> str:
        return self._id.hex()

    def task_id(self):
        return self._id.task_id()

    @property
    def owner_address(self) -> Optional[Tuple[str, int]]:
        return self._owner_addr

    # -- lifecycle --------------------------------------------------------
    def __del__(self) -> None:
        try:
            from ray_tpu_torch._private import worker as _worker_mod

            w = _worker_mod.global_worker
            if w is not None and w.connected:
                w.reference_counter.remove_local_reference(self._id)
        except Exception:
            pass  # __del__ during interpreter teardown: modules half-gone

    # -- pickling: refs travel with owner metadata ------------------------
    def __reduce__(self):
        return (ObjectRef, (self._id, self._owner_addr, self._call_site))

    # -- conveniences -----------------------------------------------------
    def future(self):
        """Return a concurrent.futures.Future resolved with the value."""
        from ray_tpu_torch._private import worker as _worker_mod

        return _worker_mod.global_worker.core.as_future(self)

    def __await__(self):
        from ray_tpu_torch._private.async_compat import as_asyncio_future

        return as_asyncio_future(self).__await__()

    def __eq__(self, other: object) -> bool:
        return isinstance(other, ObjectRef) and other._id == self._id

    def __hash__(self) -> int:
        return hash(self._id)

    def __repr__(self) -> str:
        return f"ObjectRef({self._id.hex()})"
