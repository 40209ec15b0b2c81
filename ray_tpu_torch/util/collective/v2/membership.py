"""Epoch-versioned group membership (the elastic-collectives core) (copy of
ray_tpu/util/collective/v2/membership.py).

A collective group's membership is a tiny replicated state machine with
a SINGLE authority — the group's named rendezvous actor. Members never
vote: the authority observes the control plane (``NODE_DRAIN_START``
events on the cluster bus, GCS actor lifecycle state) and serializes
every membership decision, so divergent member views — the classic way
an elastic collective deadlocks its own rendezvous — cannot arise.

State machine (raycheck RC008 checks the JAX package's copy statically)::

    ACTIVE --------> DRAINING_RANK --------> RESIZED -------> ACTIVE
            ranks flagged        survivors adopted,   next op pins
            (drain event or      epoch += 1           the new epoch
             DEAD actor)

Epochs are monotone — they NEVER decrease (runtime-asserted here, and
the transition table only moves forward). Each op sequence number is
pinned to the (epoch, members) pair current when its first participant
arrived (:meth:`GroupMembership.pin`), which gives the three guarantees
the elastic protocol rests on:

- every rank executes op N against the *identical* participant set,
  even when the resize lands mid-stream between two ranks' arrivals;
- a DRAINING rank finishes every op it already pinned (in-flight ops
  complete full-strength) and is excluded from every later one — the
  drain hand-off happens exactly at an op boundary;
- after a hard death, survivors re-align their internal sequence
  counters by adopting the bumped epoch (the group resets its per-key
  counters inside the new epoch's key namespace), so a half-completed
  op can never splice into a later one.

``fence()`` bumps the epoch *without* removing anyone — the recovery
path for a timeout where nobody is provably dead: every member adopts
the new epoch at its next op and the group's internal counters
re-align even if the wedged op left them skewed.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Optional, Tuple

ACTIVE = "ACTIVE"
DRAINING_RANK = "DRAINING_RANK"
RESIZED = "RESIZED"


class GroupMembership:
    """Authority-side membership ledger for ONE group incarnation.

    Not thread-safe on purpose: it lives inside the rendezvous actor,
    whose single-threaded message loop is the serialization point.
    """

    def __init__(self, world_size: int):
        self.world_size = int(world_size)
        self.state = ACTIVE
        self.epoch = 0
        self.members: Tuple[int, ...] = tuple(range(self.world_size))
        self.draining: set = set()          # flagged, leave at next resize
        self.dead: set = set()              # ever observed DEAD (this inc.)
        # rank -> control-plane identity (filled by member registration)
        self.actor_of: Dict[int, Optional[str]] = {}
        self.node_of: Dict[int, Optional[str]] = {}
        # op seq -> (epoch, members) decided at first arrival
        self._pins: Dict[int, Tuple[int, Tuple[int, ...]]] = {}
        # rank -> highest op seq it pinned (drives pin GC; a rank going
        # BACKWARDS here is a new group incarnation reusing the actor)
        self.rank_at: Dict[int, int] = {}
        self.resized_at: float = 0.0        # wall time of last epoch bump

    # -- registration ---------------------------------------------------
    def register(self, rank: int, actor_id: Optional[str],
                 node_id: Optional[str]) -> None:
        if actor_id:
            self.actor_of[rank] = actor_id
        if node_id:
            self.node_of[rank] = node_id

    # -- transitions (RC008-checked; see module docstring) --------------
    def flag(self, ranks: Iterable[int]) -> bool:
        """Flag ranks for removal. ACTIVE -> DRAINING_RANK."""
        ranks = [r for r in ranks
                 if r in self.members and r not in self.draining]
        if not ranks:
            return False
        if self.state == ACTIVE:
            self.state = DRAINING_RANK
        self.draining.update(ranks)
        return True

    def commit(self) -> int:
        """DRAINING_RANK -> RESIZED: adopt the survivor set and bump the
        epoch (monotone — asserted)."""
        if self.state != DRAINING_RANK:
            return self.epoch
        survivors = tuple(r for r in self.members if r not in self.draining)
        new_epoch = self.epoch + 1
        assert new_epoch > self.epoch, "membership epochs never decrease"
        self.epoch = new_epoch
        self.members = survivors
        for r in list(self.rank_at):
            if r not in survivors:
                self.rank_at.pop(r, None)
        self.draining.clear()
        self.resized_at = time.time()
        self.state = RESIZED
        return self.epoch

    def reactivate(self) -> None:
        """RESIZED -> ACTIVE: open for the next resize cycle."""
        if self.state == RESIZED:
            self.state = ACTIVE

    def resize(self, ranks: Iterable[int]) -> bool:
        """Full removal cycle for ``ranks`` (may be empty — see
        :meth:`fence`). Returns True when the epoch bumped."""
        before = self.epoch
        self.flag(ranks)
        if self.state == DRAINING_RANK:
            self.commit()
        self.reactivate()
        return self.epoch != before

    def fence(self) -> int:
        """Epoch bump with no membership change — the post-timeout
        counter-realignment barrier (module docstring)."""
        if self.state == ACTIVE:
            self.state = DRAINING_RANK
        self.commit()
        self.reactivate()
        return self.epoch

    def mark_dead(self, ranks: Iterable[int]) -> None:
        self.dead.update(ranks)

    # -- per-op pinning -------------------------------------------------
    def pin(self, op_seq: int, rank: int) -> Tuple[int, Tuple[int, ...]]:
        """The (epoch, members) op ``op_seq`` runs under — decided by
        its FIRST arriving participant, immutable afterwards."""
        d = self._pins.get(op_seq)
        if d is None:
            d = (self.epoch, self.members)
            self._pins[op_seq] = d
        self.rank_at[rank] = max(self.rank_at.get(rank, -1), op_seq)
        # pins below every member's progress can never be asked again
        if self.rank_at and len(self._pins) > 4 * self.world_size + 16:
            floor = min(self.rank_at.get(r, -1) for r in self.members) \
                if self.members else op_seq
            for s in [s for s in self._pins if s < floor]:
                self._pins.pop(s, None)
        return d

    def went_backwards(self, rank: int, op_seq: int) -> bool:
        """A rank re-pinning an op seq it already passed means a NEW
        group incarnation reuses this (named, persistent) authority."""
        return self.rank_at.get(rank, -1) > op_seq

    # -- views ----------------------------------------------------------
    def view(self) -> dict:
        return {
            "epoch": self.epoch,
            "state": self.state,
            "members": list(self.members),
            "draining": sorted(self.draining),
            "dead": sorted(self.dead),
            "world_size": self.world_size,
        }
