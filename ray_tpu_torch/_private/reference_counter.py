"""Distributed reference counting (per-worker part) (copy of
ray_tpu/_private/reference_counter.py).

Reference: src/ray/core_worker/reference_counter.h:44. Each worker tracks,
per ObjectID: local refcount (live ObjectRef pythons), submitted-task count
(refs in flight as pending task args), and borrower state. The *owner* of an
object (the worker that created it) additionally tracks borrowers and frees
the object from the store when the global count reaches zero.

Round-1 scope: correct local counting + owner-side free callbacks +
borrower registration via RPC hooks the cluster runtime installs. Lineage
pinning hooks are present (``set_lineage_pinned``) for reconstruction.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Set, Tuple

from ray_tpu_torch._private import debug_locks

from ray_tpu_torch._private.ids import ObjectID


@dataclass
class _Ref:
    local_refs: int = 0
    submitted_task_refs: int = 0
    # owner side: borrower address -> epoch of its latest AddBorrower.
    # A borrower sends RemoveBorrower (carrying the highest epoch it knows)
    # once its total interest — deserialized claims + unclaimed handoffs —
    # hits zero; the owner ignores a Remove older than the stored epoch, so
    # a stale Remove racing a concurrent re-borrow cannot wipe a live
    # registration (round-2 review finding).
    borrowers: Dict[Tuple[str, int], int] = field(default_factory=dict)
    borrow_epoch: int = 0
    owned: bool = False
    lineage_pinned: bool = False
    pending_creation: bool = False


class ReferenceCounter:
    def __init__(self) -> None:
        self._lock = debug_locks.maybe_wrap(
            threading.RLock(), "reference_counter.ReferenceCounter._lock")
        self._refs: Dict[ObjectID, _Ref] = {}
        # called when an *owned* object's global count hits zero
        self._on_zero: Optional[Callable[[ObjectID], None]] = None
        # called when a *borrowed* (non-owned) ref's local count hits zero
        # (the core worker deregisters with the owner)
        self._on_borrow_released: Optional[Callable[[ObjectID], None]] = None
        self._frozen = False

    def set_on_zero_callback(self, cb: Callable[[ObjectID], None]) -> None:
        self._on_zero = cb

    def set_borrow_release_callback(self, cb: Callable[[ObjectID], None]) -> None:
        self._on_borrow_released = cb

    def freeze(self) -> None:
        """Stop issuing on-zero callbacks (during shutdown)."""
        self._frozen = True

    # -- ownership --------------------------------------------------------
    def add_owned_object(self, oid: ObjectID, pending_creation: bool = False) -> None:
        with self._lock:
            r = self._refs.setdefault(oid, _Ref())
            r.owned = True
            r.pending_creation = pending_creation

    def is_owned(self, oid: ObjectID) -> bool:
        with self._lock:
            r = self._refs.get(oid)
            return bool(r and r.owned)

    def set_lineage_pinned(self, oid: ObjectID, pinned: bool) -> None:
        with self._lock:
            r = self._refs.get(oid)
            if r:
                r.lineage_pinned = pinned

    # -- local counting ---------------------------------------------------
    def add_local_reference(self, oid: ObjectID) -> None:
        with self._lock:
            self._refs.setdefault(oid, _Ref()).local_refs += 1

    def remove_local_reference(self, oid: ObjectID) -> None:
        with self._lock:
            r = self._refs.get(oid)
            if r is None:
                return
            r.local_refs -= 1
            action = self._maybe_release(oid, r)
        self._run_release_action(action, oid)

    def add_submitted_task_ref(self, oid: ObjectID) -> None:
        with self._lock:
            self._refs.setdefault(oid, _Ref()).submitted_task_refs += 1

    def remove_submitted_task_ref(self, oid: ObjectID) -> None:
        with self._lock:
            r = self._refs.get(oid)
            if r is None:
                return
            r.submitted_task_refs -= 1
            action = self._maybe_release(oid, r)
        self._run_release_action(action, oid)

    # -- borrowers (owner side; reference: reference_counter.h:44 borrower
    # bookkeeping — a borrower process registers before it may read, the
    # owner keeps the object alive until every borrower deregisters) -----
    def add_borrower(self, oid: ObjectID, borrower_addr: Tuple[str, int]) -> Optional[int]:
        """Owner side. Returns the registration epoch, or None when the
        object's ref entry is already gone — i.e. the object was freed;
        recreating a zombie entry would make readers see 'pending' forever."""
        with self._lock:
            r = self._refs.get(oid)
            if r is None:
                return None
            r.borrow_epoch += 1
            r.borrowers[borrower_addr] = r.borrow_epoch
            return r.borrow_epoch

    def borrower_addrs(self) -> Dict[Tuple[str, int], Set[ObjectID]]:
        """Owner side: every registered borrower address -> oids it pins.
        Used by the core worker's liveness sweep to drop borrowers whose
        process died without deregistering (reference: WaitForRefRemoved,
        reference_counter.h:44)."""
        out: Dict[Tuple[str, int], Set[ObjectID]] = {}
        with self._lock:
            for oid, r in self._refs.items():
                for addr in r.borrowers:
                    out.setdefault(addr, set()).add(oid)
        return out

    def remove_borrower(
        self,
        oid: ObjectID,
        borrower_addr: Tuple[str, int],
        epoch: Optional[int] = None,
    ) -> None:
        """Owner side. ``epoch=None`` removes unconditionally (borrower
        death); otherwise the removal only applies if no newer AddBorrower
        from that address has been recorded since."""
        with self._lock:
            r = self._refs.get(oid)
            if r is None:
                return
            stored = r.borrowers.get(borrower_addr)
            if stored is None:
                return
            if epoch is not None and stored > epoch:
                return  # stale remove: a newer registration exists
            r.borrowers.pop(borrower_addr, None)
            action = self._maybe_release(oid, r)
        self._run_release_action(action, oid)

    # -- internal ---------------------------------------------------------
    def _maybe_release(self, oid: ObjectID, r: _Ref) -> Optional[Callable]:
        """Must be called with the lock held; returns the release callback
        to invoke AFTER dropping the lock (callbacks do store/network IO —
        running them under the lock would stall every ref-count op)."""
        if r.local_refs <= 0 and r.submitted_task_refs <= 0 and not r.borrowers:
            owned = r.owned
            pinned = r.lineage_pinned
            del self._refs[oid]
            if self._frozen:
                return None
            if owned and not pinned:
                return self._on_zero
            if not owned:
                return self._on_borrow_released
        return None

    @staticmethod
    def _run_release_action(action: Optional[Callable], oid: ObjectID) -> None:
        if action is not None:
            try:
                action(oid)
            except Exception:
                pass

    def num_tracked(self) -> int:
        with self._lock:
            return len(self._refs)

    def has_reference(self, oid: ObjectID) -> bool:
        with self._lock:
            return oid in self._refs
