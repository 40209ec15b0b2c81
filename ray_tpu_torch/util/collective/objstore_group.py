"""Object-store collective group — the gloo-equivalent CPU fallback
(copy of ray_tpu/util/collective/objstore_group.py).

A host collective: every op takes a numpy array or a torch tensor and
returns numpy, as the JAX package's group does. A torch tensor is
detached and, when it lies on the card, copied to the host once,
explicitly (``_host``); the result stays on the host. numpy has no
bfloat16, so a bf16 tensor raises TypeError.

Reference: torch-gloo group (util/collective/collective_group/
torch_gloo_collective_group.py:290) rendezvoused via a TCP store. Here
the rendezvous is a **named actor** (the same named-actor pattern the
reference uses for the NCCL unique-id store, nccl_collective_group.py:37)
and the data plane is chosen per op by the v2 selection table
(`util/collective/v2/policy.py`): seqlock shm channels and chunked ring
pipes for 2-rank groups, the hierarchical shm-arena + cross-host
rendezvous composition for everything bigger, and the object store as
the universal fallback.

Fault model (the elastic/fail-fast layer; README "Collectives"
documents the caller-visible contract):

- The rendezvous actor doubles as the group's **membership authority**
  (:mod:`..v2.membership`): it watches ``NODE_DRAIN_START`` events and
  GCS actor state, and every public op pins an (epoch, members) pair
  before touching any transport. A DRAINING rank finishes the ops it
  already pinned and is excluded from every later one; survivors adopt
  the bumped epoch at their next op and complete **degraded** —
  reductions and gathers are over the survivor set.
- Every wait is budgeted by the group-agreed op deadline
  (``RAY_TPU_COLLECTIVE_OP_TIMEOUT_S``) and sliced so peer liveness is
  cross-checked against the authority every ~0.5 s: a provably DEAD
  peer raises :class:`CollectiveRankFailure` (naming the rank and
  epoch) within the detection window instead of hanging; deadline
  exhaustion raises :class:`CollectiveTimeoutError` carrying
  op/phase/suspects. Both are retriable one epoch later — adoption
  resets the internal sequence counters inside the new epoch's key
  namespace, so a half-finished op can never splice into a later one.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.experimental.channel import ChannelTimeoutError
from ray_tpu_torch.observability import collective as obs_col
from ray_tpu_torch.observability import events as obs_events
from ray_tpu_torch.util.collective.types import (
    CollectiveRankFailure,
    CollectiveTimeoutError,
    ReduceOp,
)
from ray_tpu_torch.util.collective.v2.membership import GroupMembership

def _host(tensor: Any) -> np.ndarray:
    """An op's input as a C-contiguous numpy array: a torch tensor is
    detached and copied to the host (``.cpu()``; no copy for one already
    there), anything else goes through ``np.ascontiguousarray``."""
    if isinstance(tensor, torch.Tensor):
        tensor = tensor.detach().cpu().numpy()
    return np.ascontiguousarray(tensor)


_NUMPY_REDUCERS = {
    ReduceOp.SUM: lambda xs: np.sum(xs, axis=0),
    ReduceOp.PRODUCT: lambda xs: np.prod(xs, axis=0),
    ReduceOp.MAX: lambda xs: np.max(xs, axis=0),
    ReduceOp.MIN: lambda xs: np.min(xs, axis=0),
    ReduceOp.MEAN: lambda xs: np.mean(xs, axis=0),
}


@ray_tpu_torch.remote
class _Rendezvous:
    """Collects one ObjectRef per participating rank per (key, op
    sequence number), releases the full set once every expected rank
    contributed — and serializes the group's MEMBERSHIP decisions
    (:class:`GroupMembership`): every public op pins its (epoch,
    members) here before touching a transport, and the authority scans
    the drain bus + GCS actor state (rate-limited) so a dying rank is
    resized out instead of wedging the group.

    GC contract (the pre-v2 version leaked per-seq
    refs in >2-rank groups whenever a rank abandoned a sequence):

    - a (key, seq) slot is dropped once every participant collected it;
    - per-key WATERMARK gc: when every participant of a key has
      collected some seq >= S, every slot of that key with seq <= S is
      dropped — a rank that timed out of seq S and rejoined at S+1 (a
      "late collector") can no longer strand S's refs forever;
    - a bounded-directory assert on `put` turns any future leak into a
      loud failure instead of silent actor-memory growth: with the
      watermark gc, a key can only carry a couple of live sequences
      (ranks are at most one collect apart, plus the bounded backlog of
      abandoned seqs awaiting the watermark).
    """

    def __init__(self, world_size: int):
        self.world_size = world_size
        self._slots: Dict[Tuple[str, int], Dict[int, Any]] = {}
        # key -> {rank: highest seq that rank successfully collected}
        self._wm: Dict[str, Dict[int, int]] = {}
        self._max_live_per_key = 2 * world_size + 8
        self._mem = GroupMembership(world_size)
        self._last_scan = 0.0
        self._drain_seen = 0

    # -- membership authority ------------------------------------------
    def _reset_incarnation(self, world_size: int):
        """A new group incarnation reuses this (named, persistent)
        actor: fresh membership ledger, fresh directory (p2p slots
        excepted — undelivered old messages surviving a re-init is the
        v1 in-flight-message semantics)."""
        self.world_size = world_size
        self._max_live_per_key = 2 * world_size + 8
        self._mem = GroupMembership(world_size)
        self._drain_seen = 0
        self._wm.clear()
        for ks in [ks for ks in self._slots
                   if not ks[0].startswith("p2p_")]:
            self._slots.pop(ks, None)

    def _scan(self, force: bool = False):
        """Observe the control plane: drain events flag members whose
        node is leaving (graceful — they finish pinned ops), DEAD
        actors are resized out immediately. Rate-limited: this actor's
        message loop is the group's hot path."""
        now = time.monotonic()
        if now - self._last_scan < (0.2 if force else 0.4):
            return
        self._last_scan = now
        from ray_tpu_torch._private.drain import EVENT_DRAIN_START
        from ray_tpu_torch.util import state as rstate

        leaving: set = set()
        try:
            events = rstate.list_events(etype=EVENT_DRAIN_START)
            for ev in events[self._drain_seen:]:
                nid = ev.get("node_id", "")
                if nid:
                    leaving.update(
                        r for r in self._mem.members
                        if self._mem.node_of.get(r) == nid)
            self._drain_seen = len(events)
        except Exception:  # noqa: BLE001 — bus unreachable: no event
            pass
        dead: set = set()
        for r in self._mem.members:
            aid = self._mem.actor_of.get(r)
            if not aid:
                continue
            try:
                info = rstate.get_actor(aid)
            except Exception:  # noqa: BLE001
                continue
            if info and info.get("state") == "DEAD":
                dead.add(r)
        if dead:
            self._mem.mark_dead(dead)
        if leaving | dead:
            self._mem.resize(leaving | dead)

    def begin_op(self, op_seq: int, rank: int, world_size: int,
                 actor_id: Optional[str] = None,
                 node_id: Optional[str] = None) -> Tuple[int, List[int]]:
        """Pin (epoch, members) for ``op_seq`` — decided by the first
        arriving participant, immutable afterwards (membership.py has
        the full protocol argument)."""
        if world_size != self.world_size \
                or self._mem.went_backwards(rank, op_seq):
            self._reset_incarnation(world_size)
        self._mem.register(rank, actor_id, node_id)
        self._scan()
        epoch, members = self._mem.pin(op_seq, rank)
        return epoch, list(members)

    def liveness(self, ranks: Optional[List[int]] = None) -> dict:
        """Force a control-plane scan and report confirmed-dead ranks
        (all-time for this incarnation, intersected with ``ranks``)."""
        self._scan(force=True)
        dead = self._mem.dead if ranks is None \
            else self._mem.dead & set(ranks)
        return {"dead": sorted(dead), "epoch": self._mem.epoch,
                "members": list(self._mem.members)}

    def fence(self) -> int:
        """Epoch bump with no membership change — the post-timeout
        counter-realignment barrier."""
        return self._mem.fence()

    def membership_view(self) -> dict:
        return self._mem.view()

    def missing(self, key: str, seq: int, ranks: List[int]) -> List[int]:
        """Expected participants that have not put (key, seq) yet —
        the suspect list for timeout diagnostics and liveness probes."""
        slot = self._slots.get((key, seq), {})
        return [r for r in ranks if r not in slot]

    # -- directory ------------------------------------------------------
    def put(self, key: str, seq: int, rank: int, ref: Any,
            world_size: Optional[int] = None):
        if world_size is not None and world_size != self.world_size:
            # the named actor outlives groups: a put from a group sized
            # differently than the incarnation that created this actor
            # IS a new incarnation — adopt the new world (collect()'s
            # expected set must match it) and reset the directory
            self._reset_incarnation(world_size)
        if self._wm.get(key, {}).get(rank, -1) >= seq:
            # a rank re-putting a sequence it already collected means a
            # NEW group incarnation reuses this (named, persistent)
            # rendezvous with reset counters. The old incarnation is
            # dead GROUP-WIDE, so reset the whole directory: drop every
            # watermark (a stale one would gc the fresh exchange out
            # from under the new group's slower ranks) and every
            # stranded slot — including partial slots on keys that
            # never saw a collect, which could otherwise merge with the
            # new incarnation's puts at the same seq and release stale
            # refs. Only the FIRST new-incarnation put lands here (the
            # reset clears the watermarks that trigger it), so fresh
            # puts racing in behind it are never purged. p2p slots are
            # NOT purged: they carry no watermark (so a fresh send made
            # before the group's first collective would be wiped, not
            # protected by the first-put-wins argument), and an
            # undelivered old message surviving a re-init is the v1
            # in-flight-message semantics.
            # KNOWN LIMIT: a group that crashed before ANY collect
            # completed leaves no watermark, so a same-name same-size
            # re-incarnation cannot be distinguished from it — full
            # fencing needs incarnation ids in the put protocol.
            self._wm.clear()
            for ks in [ks for ks in self._slots
                       if not ks[0].startswith("p2p_")]:
                self._slots.pop(ks, None)
        slot = self._slots.setdefault((key, seq), {})
        slot[rank] = ref
        # the bounded-directory assert applies to collect/watermark-gc'd
        # keys only: p2p slots are freed by collect_from, and a sender
        # legitimately pipelines unboundedly ahead of its receiver
        if not key.startswith("p2p_"):
            live = sum(1 for k, _s in self._slots if k == key)
            assert live <= self._max_live_per_key, (
                f"rendezvous directory for key {key!r} grew to {live} "
                f"live sequences (> {self._max_live_per_key}) — per-seq "
                f"GC is leaking")
        return len(slot)

    def collect(self, key: str, seq: int, rank: int = -1,
                ranks: Optional[List[int]] = None) -> Optional[List[Any]]:
        """Full set for (key, seq) in participant order, or None while
        incomplete. ``ranks`` names the expected participants (default:
        the whole group) — the hier cross-host phase exchanges among
        counterpart subsets, degraded epochs among survivors."""
        expected = tuple(ranks) if ranks is not None \
            else tuple(range(self.world_size))
        slot = self._slots.get((key, seq), {})
        if any(r not in slot for r in expected):
            return None
        out = [slot[r] for r in expected]
        if rank >= 0:
            wm = self._wm.setdefault(key, {})
            wm[rank] = max(wm.get(rank, -1), seq)
            floor = min(wm.get(r, -1) for r in expected)
            if floor >= 0:
                dead = [ks for ks in self._slots
                        if ks[0] == key and ks[1] <= floor]
                for ks in dead:
                    self._slots.pop(ks, None)
        return out

    def collect_from(self, key: str, seq: int, rank: int) -> Optional[Any]:
        """P2P: fetch a single rank's contribution (and clear it)."""
        slot = self._slots.get((key, seq), {})
        if rank not in slot:
            return None
        ref = slot.pop(rank)
        if not slot:
            self._slots.pop((key, seq), None)
        return ref

    def collect_scatter(self, key: str, seq: int,
                        senders: List[int]) -> Optional[List[Any]]:
        """Single-collector variant: the full sender set for (key, seq)
        in ``senders`` order, popped immediately (exactly one rank ever
        collects a scatter key, so eager gc is safe — no watermark
        needed)."""
        slot = self._slots.get((key, seq), {})
        if any(r not in slot for r in senders):
            return None
        self._slots.pop((key, seq), None)
        return [slot[r] for r in senders]

    def gc(self, key: str, seq: int):
        self._slots.pop((key, seq), None)
        return True

    def directory_stats(self) -> dict:
        """Live-slot accounting for the GC tests."""
        per_key: Dict[str, int] = {}
        for k, _s in self._slots:
            per_key[k] = per_key.get(k, 0) + 1
        return {"live_slots": len(self._slots), "per_key": per_key}


class ObjStoreGroup:
    """One instance per participating process/actor.

    Data plane, chosen PER OP by the v2 selection table (policy.py has
    the full table; README "Collectives" documents it):

    - SMALL tensors on one host ride seqlock shared-memory tensor
      channels (all-to-all, zero actor round-trips in steady state).
    - LARGE tensors in 2-rank groups ride the chunked pipelined ring
      over shm pipes (v1 plane, 0.81 GB/s on the CI box).
    - Everything bigger — >2 ranks and/or multiple hosts — rides the
      hierarchical executor (v2): intra-host reduce-scatter over a shm
      arena, cross-host counterpart exchange over the object path,
      intra-host allgather fan-back, optionally with block-scaled int8
      wire quantization (``RAY_TPU_COLLECTIVE_QUANT=int8``).
    - The object path (rendezvous actor + object store) remains the
      universal fallback and the cross-host transport.

    The policy (knobs + topology) is agreed across the group at first
    use so per-rank env differences can never diverge the per-op
    rendezvous keys, and each op's routing is re-agreed over a
    fixed-shape meta channel (same host) or the object path (cross
    host) — divergent shapes degrade to the object path, never
    deadlock.

    Elasticity: ``rank``/``world_size`` are the group's BIRTH
    coordinates and never change; ``members`` is the current epoch's
    survivor tuple and ``_eff_rank``/``_eff_world`` this rank's dense
    position in it. Transports, topology, policy and sequence counters
    are all per-epoch: :meth:`_adopt` tears them down and the next op
    lazily rebuilds them among the survivors, inside the new epoch's
    rendezvous key namespace (``e{epoch}:...``).
    """

    def __init__(self, world_size: int, rank: int, group_name: str = "default"):
        from ray_tpu_torch._private import worker as worker_mod

        # every rank needs the runtime: without it, fail here at once
        # instead of polling for the rendezvous actor until its timeout
        worker_mod._require_connected()
        self.world_size = world_size
        self.rank = rank
        self.group_name = group_name
        self._seq = 0
        self._op_seq = 0
        self._epoch = 0
        self._members: Tuple[int, ...] = tuple(range(world_size))
        self._eff_rank = rank
        self._eff_world = world_size
        self._p2p_seqs: Dict[str, int] = {}
        self._sub_seqs: Dict[str, int] = {}
        # (shape, dtype) -> (my_channel, [(eff_rank, reader), ...]) or
        # None (None = cross-host group: stay on the object path)
        self._channels: Dict[Tuple, Optional[Tuple[Any, List]]] = {}
        # fixed-shape metadata channels for the per-op routing agreement
        # (() = not yet set up, None = cross-host: channel plane off)
        self._meta: Any = ()
        # ring pipes for LARGE tensors: my pipe feeds my successor, I
        # read my predecessor's (() = unset, None = cross-host)
        self._pipes: Any = ()
        # group-agreed GroupPolicy + Topology (policy_v2 exchange)
        self._policy2 = None
        self._topology = None
        # size-bucketed host-local ShmArenas (v2 intra-host transport)
        self._arenas: Dict[int, Any] = {}
        self._exec = None
        # simulated-WAN link state: when the sender's next byte may
        # start crossing (serializes the capped cross-host leg)
        self._wan_free_t = 0.0
        # resolved lazily (_identity): groups are built in actor
        # __init__, where the creation task's context has NO actor id
        # yet — capturing here would register None with the authority
        # and blind its GCS liveness cross-check for the whole group
        self._my_actor_id: Optional[str] = None
        self._my_node_id: Optional[str] = None
        name = f"__collective_rdv_{group_name}"
        if rank == 0:
            try:
                self._rdv = _Rendezvous.options(
                    name=name, get_if_exists=True
                ).remote(world_size)
            except TypeError:
                self._rdv = _Rendezvous.options(name=name).remote(world_size)
        else:
            self._rdv = self._wait_for_actor(name)

    def _identity(self) -> Tuple[Optional[str], Optional[str]]:
        """(actor_id, node_id) of this rank, resolved on first use from
        a METHOD-call context — the ids the authority cross-checks
        against GCS when deciding a suspect is confirmed dead."""
        if self._my_actor_id is None or self._my_node_id is None:
            try:
                ctx = ray_tpu_torch.get_runtime_context()
                if self._my_actor_id is None:
                    self._my_actor_id = ctx.get_actor_id()
                if self._my_node_id is None:
                    self._my_node_id = ctx.get_node_id()
            except Exception:  # noqa: BLE001 — driver-side groups
                pass
        return self._my_actor_id, self._my_node_id

    @staticmethod
    def _wait_for_actor(name: str, timeout: float = 30.0):
        deadline = time.time() + timeout
        while time.time() < deadline:
            try:
                return ray_tpu_torch.get_actor(name)
            except Exception:
                time.sleep(0.05)
        raise TimeoutError(f"collective rendezvous actor {name} not found")

    # -- membership / epochs -------------------------------------------
    @property
    def members(self) -> Tuple[int, ...]:
        """Global ranks alive at the adopted epoch."""
        return self._members

    @property
    def epoch(self) -> int:
        return self._epoch

    def _op_timeout_s(self) -> float:
        """The deadline budget for any single op leg: group-agreed once
        the policy exchange ran (min across ranks — whoever wants to
        fail fastest wins), this rank's env before that."""
        if self._policy2 is not None:
            return self._policy2.op_timeout_s
        try:
            return max(0.1, float(os.environ.get(
                "RAY_TPU_COLLECTIVE_OP_TIMEOUT_S", "120") or 120.0))
        except ValueError:
            return 120.0

    def _key(self, key: str) -> str:
        """Epoch-namespaced rendezvous key. Epoch 0 keeps the bare key:
        the non-degraded wire format is unchanged."""
        return f"e{self._epoch}:{key}" if self._epoch else key

    def _probe_dead(self, ranks=None) -> Tuple[int, ...]:
        """Confirmed-dead ranks among ``ranks`` (authority cross-checks
        GCS actor state). Best-effort: an unreachable authority means
        no verdict, never an exception out of a wait loop."""
        if self.world_size <= 1:
            return ()
        try:
            res = ray_tpu_torch.get(self._rdv.liveness.remote(
                list(ranks) if ranks is not None else None))
        except Exception:  # noqa: BLE001
            return ()
        return tuple(res.get("dead", ()))

    def _rank_failure(self, dead, epoch: int, op: str,
                      phase: str) -> "CollectiveRankFailure":
        """Build the typed failure AND leave a black box behind: a
        ``collective_failure`` bus event plus a cluster-wide
        flight-recorder dump, so the postmortem names the dead rank and
        the op phase it died in without reproducing the run. The dead
        rank itself can't dump (it's gone) — every survivor's shard
        carries the attribution instead."""
        dead = tuple(dead)
        try:
            obs_events.record_event(
                "collective_failure", group=self.group_name,
                epoch=int(epoch), rank=self.rank,
                dead_ranks=list(dead), op=op, phase=phase)
            from ray_tpu_torch.observability import dump as obs_dump
            obs_dump.trigger_cluster_dump(
                "collective_rank_failure", group=self.group_name,
                epoch=int(epoch), rank=self.rank,
                dead_ranks=list(dead), op=op, phase=phase)
        except Exception:  # noqa: BLE001 — diagnostics never mask failure
            pass
        return CollectiveRankFailure(dead, epoch, self.group_name,
                                     op=op, phase=phase)

    def _op_timeout_failure(self, op: str, phase: str, timeout: float,
                            suspects) -> "CollectiveTimeoutError":
        """Deadline exhaustion leaves the same black box as a confirmed
        death, with the MISSING ranks tagged as suspects (the probe
        couldn't confirm them dead) — a postmortem still opens on "who
        was absent, in which phase" even when the authority never
        resolved it."""
        suspects = tuple(suspects)
        try:
            obs_events.record_event(
                "collective_failure", group=self.group_name,
                epoch=int(self._epoch), rank=self.rank,
                suspect_ranks=list(suspects), op=op, phase=phase,
                confirmed=False)
            from ray_tpu_torch.observability import dump as obs_dump
            obs_dump.trigger_cluster_dump(
                "collective_op_timeout", group=self.group_name,
                epoch=int(self._epoch), rank=self.rank,
                suspect_ranks=list(suspects), op=op, phase=phase)
        except Exception:  # noqa: BLE001 — diagnostics never mask failure
            pass
        return CollectiveTimeoutError(op, phase, timeout, suspects,
                                      self.group_name)

    def _fence(self) -> None:
        """Ask the authority for an epoch bump with no membership
        change: after a timeout the group's internal counters may be
        skewed mid-op, and adoption at the next op resets them."""
        try:
            ray_tpu_torch.get(self._rdv.fence.remote())
        except Exception:  # noqa: BLE001
            pass

    def _adopt(self, epoch: int, members) -> None:
        """Adopt a new membership epoch: tear down every per-epoch
        transport and counter; the next op lazily rebuilds them among
        the survivors inside the new key namespace. This is also the
        re-alignment point after failures — survivors may have left a
        wedged op with skewed `_seq`/`_sub_seqs`, and resetting them
        inside a FRESH namespace makes the skew unobservable."""
        members = tuple(members)
        if epoch == self._epoch and members == self._members:
            return
        self.close()
        self._policy2 = None
        self._topology = None
        self._exec = None
        self._seq = 0
        self._sub_seqs.clear()
        self._epoch = int(epoch)
        self._members = members
        self._eff_rank = members.index(self.rank) \
            if self.rank in members else -1
        self._eff_world = len(members)
        try:
            obs_events.record_event(
                "collective_epoch", group=self.group_name,
                epoch=self._epoch, rank=self.rank,
                members=list(members))
        except Exception:  # noqa: BLE001 — observability must not fail ops
            pass

    def _begin_op(self) -> None:
        """Pin this op's (epoch, members) at the authority and adopt
        any resize. Raises :class:`CollectiveRankFailure` naming THIS
        rank when it has been drained/removed — the signal that it left
        the group and must stop issuing collective ops."""
        if self.world_size <= 1:
            return
        seq = self._op_seq
        self._op_seq += 1
        aid, nid = self._identity()
        try:
            epoch, members = ray_tpu_torch.get(self._rdv.begin_op.remote(
                seq, self.rank, self.world_size, aid, nid))
        except Exception:  # noqa: BLE001 — authority unreachable: keep
            return         # the current view; waits still budget out
        members = tuple(members)
        if self.rank not in members:
            raise self._rank_failure(
                (self.rank,), epoch, op="membership", phase="begin_op")
        if (epoch, members) != (self._epoch, self._members):
            self._adopt(epoch, members)

    def _eff_to_global(self, eff_ranks) -> List[int]:
        return [self._members[i] for i in eff_ranks]

    # ------------------------------------------------------------------
    def _poll_collect(self, what: str, fn, *, op: str = "",
                      phase: str = "", ranks=None,
                      missing_fn=None) -> List[Any]:
        """Poll ``fn`` (a collect RPC returning the ref set or None)
        with progressive backoff: each poll is a full RPC round trip
        that costs CPU on both ends — on oversubscribed hosts a fixed
        2 ms cadence steals the very cycles the slow peer needs to
        reach its put (measured 2x+ on the hier xh phase).

        Deadline-budgeted and liveness-checked: every ~0.5 s the ranks
        still missing (``missing_fn``, falling back to ``ranks``) are
        cross-checked against GCS actor state via the authority — a
        confirmed death raises :class:`CollectiveRankFailure` within
        the detection window; deadline exhaustion fences the epoch and
        raises :class:`CollectiveTimeoutError` with the suspects."""
        timeout = self._op_timeout_s()
        deadline = time.monotonic() + timeout
        probe_at = time.monotonic() + min(0.5, timeout / 4)
        nap = 0.002
        while time.monotonic() < deadline:
            refs = fn()
            if refs is not None:
                # the value fetch stays under the op deadline too: a
                # dangling ref (owner died between put and fetch) must
                # surface as the typed timeout, not an unbounded get
                left = max(0.1, deadline - time.monotonic())
                try:
                    return [ray_tpu_torch.get(r[0], timeout=left) for r in refs]
                except Exception:  # noqa: BLE001 — GetTimeoutError et al.
                    break
            if time.monotonic() >= probe_at:
                probe_at = time.monotonic() + 0.5
                waiting = None
                if missing_fn is not None:
                    try:
                        waiting = missing_fn()
                    except Exception:  # noqa: BLE001
                        waiting = None
                if waiting is None and ranks is not None:
                    waiting = [r for r in ranks if r != self.rank]
                dead = self._probe_dead(waiting)
                if dead:
                    raise self._rank_failure(
                        dead, self._epoch, op=op or what, phase=phase)
            time.sleep(nap)
            nap = min(nap * 1.5, 0.008)
        suspects: Tuple[int, ...] = ()
        if missing_fn is not None:
            try:
                suspects = tuple(missing_fn())
            except Exception:  # noqa: BLE001
                pass
        self._fence()
        raise self._op_timeout_failure(op or what, phase or "collect",
                                       timeout, suspects)

    def _guarded_wait(self, fn, op: str, phase: str, ranks=None):
        """Run a blocking shm wait (``fn(slice_timeout)``) under the op
        deadline, slicing it so peer liveness is probed between slices.
        Every wrapped wait fails BEFORE mutating its endpoint (asserted
        by reading channel.py/arena.py), so re-issuing after a slice
        timeout is safe."""
        timeout = self._op_timeout_s()
        deadline = time.monotonic() + timeout
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                self._fence()
                raise self._op_timeout_failure(
                    op, phase, timeout, tuple(ranks or ()))
            try:
                return fn(min(0.6, max(0.05, left)))
            except ChannelTimeoutError:
                dead = self._probe_dead(ranks)
                if dead:
                    raise self._rank_failure(
                        dead, self._epoch, op=op, phase=phase)

    # -- simulated WAN (bandwidth-capped cross-host leg) ----------------
    def _wan_stamp(self, value: Any) -> Any:
        """With ``RAY_TPU_COLLECTIVE_WAN_GBPS`` agreed on, stamp a
        cross-host payload with the wall time its last byte clears the
        simulated link (one serialized link per sending rank). The
        receiver sleeps until the stamp — so wire time that a sender
        overlapped with compute is genuinely hidden, and a codec that
        sends fewer bytes genuinely finishes earlier. Applied ONLY to
        the hier cross-host leg; intra-host shm is never capped."""
        bw = self._policy2.wan_gbps if self._policy2 is not None else 0.0
        if bw <= 0:
            return value
        nbytes = int(getattr(value, "nbytes", 0) or 0)
        now = time.time()
        start = now if now > self._wan_free_t else self._wan_free_t
        ready = start + nbytes / (bw * 1e9 / 8.0)
        self._wan_free_t = ready
        return ("__wan__", ready, value)

    def _wan_unwrap(self, vals: List[Any], senders: List[int]) -> List[Any]:
        out: List[Any] = []
        ready = 0.0
        for r, v in zip(senders, vals):
            if isinstance(v, tuple) and len(v) == 3 and v[0] == "__wan__":
                if r != self.rank and v[1] > ready:
                    ready = v[1]
                v = v[2]
            out.append(v)
        delay = ready - time.time()
        if delay > 0:
            time.sleep(delay)
        return out

    # ------------------------------------------------------------------
    def _rdv_exchange(self, key: str, seq: int, value: Any,
                      ranks: Optional[List[int]] = None, op: str = "",
                      phase: str = "") -> List[Any]:
        """Put my value for (key, seq) and poll-collect every expected
        participant's (default: the current epoch's members)."""
        expected = list(ranks) if ranks is not None else list(self._members)
        pkey = self._key(key)
        ref = ray_tpu_torch.put(value)
        ray_tpu_torch.get(self._rdv.put.remote(pkey, seq, self.rank, [ref],
                                         world_size=self.world_size))
        return self._poll_collect(
            f"{key} (seq={seq})",
            lambda: ray_tpu_torch.get(
                self._rdv.collect.remote(pkey, seq, self.rank, expected)),
            op=op or key, phase=phase, ranks=expected,
            missing_fn=lambda: ray_tpu_torch.get(
                self._rdv.missing.remote(pkey, seq, expected)))

    def _exchange(self, key: str, value: Any, op: str = "",
                  phase: str = "") -> List[Any]:
        seq = self._seq
        self._seq += 1
        return self._rdv_exchange(key, seq, value, op=op, phase=phase)

    def _sub_put(self, key: str, value: Any, eff_ranks: List[int],
                 op: str = "", phase: str = "") -> tuple:
        """Async half of :meth:`_sub_exchange`: publish my value for
        this key's next sequence and return a handle for
        :meth:`_sub_collect`. The split is what the overlapped chunked
        path pipelines on — block k's wire time hides behind block
        k+1's reduction."""
        ranks = self._eff_to_global(eff_ranks)
        assert self.rank in ranks
        seq = self._sub_seqs.get(key, 0)
        self._sub_seqs[key] = seq + 1
        pkey = self._key(key)
        ref = ray_tpu_torch.put(self._wan_stamp(value))
        fut = self._rdv.put.remote(pkey, seq, self.rank, [ref],
                                   world_size=self.world_size)
        # ref MUST ride in the handle: until the rendezvous actor has
        # processed the put (and pinned the object as a borrower),
        # this local reference is the only thing keeping the object
        # alive — dropping it early races the borrower registration
        # and a collector can hang on a dangling ref
        return (pkey, key, seq, ranks, fut, ref, op, phase)

    def _sub_collect(self, handle: tuple) -> List[Any]:
        pkey, key, seq, ranks, fut, _ref, op, phase = handle
        ray_tpu_torch.get(fut)  # surface put-side failures (directory assert)
        vals = self._poll_collect(
            f"{key} (seq={seq})",
            lambda: ray_tpu_torch.get(
                self._rdv.collect.remote(pkey, seq, self.rank, ranks)),
            op=op or key, phase=phase or "xh", ranks=ranks,
            missing_fn=lambda: ray_tpu_torch.get(
                self._rdv.missing.remote(pkey, seq, ranks)))
        return self._wan_unwrap(vals, ranks)

    def _sub_exchange(self, key: str, value: Any, eff_ranks: List[int],
                      op: str = "", phase: str = "") -> List[Any]:
        """Object-path exchange among ``eff_ranks`` (EFFECTIVE indices
        into the current members — the hier cross-host phase): every
        participant's value, in that order. Participants must all call
        with identical (key, eff_ranks); per-key sequence counters keep
        repeated phases aligned without touching the group-wide
        counter."""
        return self._sub_collect(
            self._sub_put(key, value, eff_ranks, op=op, phase=phase))

    def _scatter_exchange(self, key: str, per_dest: Dict[int, Any],
                          eff_ranks: List[int], op: str = "",
                          phase: str = "") -> List[Any]:
        """Pairwise scatter among ``eff_ranks`` (effective indices):
        each participant publishes one value PER destination and
        receives one value from every other participant (sender order:
        ``eff_ranks`` minus self). O(k) bytes per rank where a dict
        over ``_sub_exchange`` would ship O(k^2) — every peer would
        pull every other pair's shards just to read its own entry."""
        ranks = self._eff_to_global(eff_ranks)
        assert self.rank in ranks
        seq = self._sub_seqs.get(key, 0)
        self._sub_seqs[key] = seq + 1
        for dest_eff, val in per_dest.items():
            dest = self._members[dest_eff]
            ref = ray_tpu_torch.put(self._wan_stamp(val))
            ray_tpu_torch.get(self._rdv.put.remote(
                self._key(f"{key}>{dest}"), seq, self.rank, [ref],
                world_size=self.world_size))
        senders = [r for r in ranks if r != self.rank]
        mykey = self._key(f"{key}>{self.rank}")
        vals = self._poll_collect(
            f"scatter {key} (seq={seq})",
            lambda: ray_tpu_torch.get(self._rdv.collect_scatter.remote(
                mykey, seq, senders)),
            op=op or key, phase=phase or "xh", ranks=senders,
            missing_fn=lambda: ray_tpu_torch.get(
                self._rdv.missing.remote(mykey, seq, senders)))
        return self._wan_unwrap(vals, senders)

    # -- group policy + topology (v2) ----------------------------------
    def _ensure_policy(self):
        """Agree the v2 policy AND topology across the group, once per
        epoch: every member contributes its env knobs plus its host
        key, the merge is deterministic and conservative (see
        policy.py), and the per-op routing decision is then identical
        on all members by construction — divergent env vars degrade
        throughput, never deadlock the rendezvous."""
        if self._policy2 is not None:
            return self._policy2
        from ray_tpu_torch.util.collective.v2 import policy as policy_mod
        from ray_tpu_torch.util.collective.v2 import topology as topo_mod

        mine = tuple(policy_mod.local_knobs()) + (topo_mod.node_key(),)
        if self._eff_world > 1:
            infos = [tuple(i) for i in self._exchange(
                "policy_v2", mine, op="setup", phase="policy")]
        else:
            infos = [mine]
        self._policy2 = policy_mod.merge_knobs([i[:-1] for i in infos])
        self._topology = topo_mod.Topology(self._eff_rank,
                                           [i[-1] for i in infos])
        return self._policy2

    def _executor(self):
        if self._exec is None:
            from ray_tpu_torch.util.collective.v2.executor import (
                HierarchicalExecutor,
            )
            self._exec = HierarchicalExecutor(self)
        return self._exec

    def _ensure_arena(self, nbytes: int):
        """Host-local ShmArena with slots and region each >= nbytes,
        bucketed to powers of two so every message size maps to a small
        set of arenas. The local leader creates; names travel through
        one member-wide exchange (every member reaches the same
        rendezvous key regardless of host), then each member keeps its
        host leader's arena."""
        bucket = 1 << max(12, int(nbytes - 1).bit_length()) \
            if nbytes > 1 else 4096
        ar = self._arenas.get(bucket)
        if ar is not None:
            return ar
        from ray_tpu_torch.util.collective.v2.arena import ShmArena

        topo = self._topology
        name = None
        if topo.is_local_leader:
            ar = ShmArena(topo.local_world, topo.local_rank, bucket,
                          bucket, create=True)
            name = ar.name
        infos = self._exchange(f"arenasetup_{bucket}", name,
                               op="setup", phase="arena")
        if not topo.is_local_leader:
            leader_name = infos[topo.leader(topo.my_host)]
            ar = ShmArena(topo.local_world, topo.local_rank, bucket,
                          bucket, name=leader_name, create=False)
        self._arenas[bucket] = ar
        return ar

    # -- shared-memory channel data plane ------------------------------
    def _peer_globals(self) -> List[int]:
        return [r for r in self._members if r != self.rank]

    def _make_channel_set(self, shape, dtype, rdv_key: str):
        """One object-path exchange advertises every member's channel;
        returns (my_channel, [(eff_rank, reader), ...]) or None when
        the members span hosts or the advertised (shape, dtype)
        disagree."""
        import socket

        from ray_tpu_torch.experimental.channel import (
            TensorChannel,
            TensorChannelReader,
        )

        key = (tuple(shape), str(dtype))
        host = socket.gethostname()
        mine = TensorChannel(shape, str(dtype),
                             num_readers=self._eff_world - 1)
        infos = self._exchange(rdv_key, (host, key, mine.name),
                               op="setup", phase="channels")
        if any(h != host or k != key for h, k, _ in infos):
            mine.close()
            return None
        readers: List[Tuple[int, Any]] = []
        for r, (_h, _k, nm) in enumerate(infos):
            if r == self._eff_rank:
                continue
            # reader slot within member r's channel: peers in member
            # order, skipping r itself
            ridx = self._eff_rank if self._eff_rank < r \
                else self._eff_rank - 1
            readers.append((r, TensorChannelReader(
                nm, shape, str(dtype), self._eff_world - 1, ridx)))
        return (mine, readers)

    def _ensure_meta_channels(self):
        """Fixed-shape (int64[2]) channels for the PER-OP routing
        agreement. Set up through one shape-INDEPENDENT rendezvous
        ("metasetup") the first time any member tries the channel plane
        — every member reaches it regardless of tensor shapes, so setup
        itself can't split across keys. None = the members span real
        hosts: the channel plane is off and per-op agreement falls back
        to the object path."""
        if self._meta == ():
            self._meta = self._make_channel_set((2,), "int64", "metasetup")
        return self._meta

    def _ensure_channels(self, shape, dtype) -> Optional[Tuple[Any, List]]:
        key = (tuple(shape), str(dtype))
        st = self._channels.get(key, ())
        if st != ():
            return st
        st = self._make_channel_set(shape, dtype, "chsetup")
        if st is None and self._meta is not None:
            # shape-signature collision let mismatched members through
            # the meta agreement (same host, or this would be the
            # cross-host branch): don't cache — caching None per-rank
            # under DIFFERENT keys would desync the next chsetup
            # rendezvous
            return None
        self._channels[key] = st
        return st

    def _shape_sig(self, arr: np.ndarray) -> int:
        import zlib

        return zlib.crc32(repr((arr.shape, str(arr.dtype))).encode())

    def _op_route(self, arr: np.ndarray, op_kind: str = "allreduce") -> str:
        """Decide THIS op's data plane — "channel" (small, per-shape
        all-to-all seqlock channels), "pipe" (large 2-rank chunked
        pipelined ring), "hier" (v2 hierarchical arena + cross-host
        composition) or "object" (rendezvous actor + object store).

        The routing must be decided IDENTICALLY on every member, but it
        depends on per-rank state — the tensor's shape/size. So every
        op first exchanges (shape-sig, nbytes): over a fixed-shape meta
        channel when the members share a host (a couple of seqlock shm
        reads, no actor round-trips), over the object path when they
        don't (the cross-host phases dwarf one actor round-trip). Every
        member then applies the same selection table to the same
        vector: all metas equal → policy.select_algorithm decides;
        anything else → everyone takes the object path. Without the
        per-op agreement, mismatched-shape ops after a matching
        warm-up, or ops straddling a size threshold, would deadlock
        both sides for the full op deadline and desync the exchange
        seq."""
        from ray_tpu_torch.util.collective.v2 import policy as policy_mod

        pol = self._ensure_policy()
        topo = self._topology
        if self._eff_world <= 1 or not pol.channels_enabled:
            return "object"  # group-agreed constants: identical everywhere
        # NOTE: no per-rank early returns below this line — dtype rides
        # in the shape signature and select_algorithm's non-numeric
        # check, so even a member holding a different/non-numeric dtype
        # participates in the agreement and degrades WITH the group
        meta = self._ensure_meta_channels()
        sig = np.array([self._shape_sig(arr), arr.nbytes], np.int64)
        if meta is not None:
            meta_ch, meta_readers = meta
            peers = self._peer_globals()
            self._guarded_wait(
                lambda t: meta_ch.write(sig, timeout=t),
                op_kind, "route_write", ranks=peers)
            agree = True
            for r, rd in meta_readers:
                peer = self._guarded_wait(
                    lambda t, rd=rd: rd.read(timeout=t),
                    op_kind, "route_read", ranks=[self._members[r]])
                if peer[0] != sig[0] or peer[1] != sig[1]:
                    agree = False  # keep reading: drain every peer's slot
            if not agree:
                return "object"  # same decision everywhere, by construction
        else:
            # members span real hosts: only the hier plane is on the
            # table. Short-circuit every SIZE-INDEPENDENT "object"
            # answer (op kind, flat override, non-uniform topology)
            # before paying the agreement round trip — size-dependent
            # decisions must exchange first or members straddling a
            # threshold would split
            if topo.single_host or not topo.uniform \
                    or pol.algo == "flat" or op_kind == "allgather":
                return "object"
            infos = self._exchange("hiermeta", (int(sig[0]), int(sig[1])),
                                   op=op_kind, phase="route")
            if any(tuple(i) != (int(sig[0]), int(sig[1])) for i in infos):
                return "object"
        return policy_mod.select_algorithm(arr.nbytes, arr.dtype, topo, pol,
                                           op_kind)

    def _channel_parts(self, arr: np.ndarray) -> Optional[List[np.ndarray]]:
        """Small-tensor plane: write mine once, read every peer's.
        None = channel setup detected a shape-signature collision —
        symmetric on all members (the chsetup exchange shows everyone
        the same mismatch), so every member falls back together.
        Parts come back in MEMBER order (length = effective world)."""
        st = self._ensure_channels(arr.shape, arr.dtype)
        if st is None:
            return None
        mine, readers = st
        self._guarded_wait(
            lambda t: mine.write(arr, timeout=t),
            "channel", "write", ranks=self._peer_globals())
        parts: List[Any] = [None] * self._eff_world
        # own part is a COPY: the object path returned independent
        # buffers, and callers may mutate the gathered list in place —
        # aliasing the caller's live tensor would corrupt it
        parts[self._eff_rank] = arr.copy()
        for r, rd in readers:
            parts[r] = self._guarded_wait(
                lambda t, rd=rd: rd.read(timeout=t),
                "channel", "read", ranks=[self._members[r]])
        return parts

    # -- pipelined ring plane (large tensors) ---------------------------
    _PIPE_SLOTS = 4

    def _ensure_pipes(self):
        """Ring pipes, one per edge: my ChunkPipe feeds my successor
        (next member), I read my predecessor's. Established through one
        object-path exchange the first time any op routes "pipe" (the
        routing agreement guarantees every member arrives); None = the
        members span hosts — cached, all members fall back together."""
        if self._pipes != ():
            return self._pipes
        import socket

        from ray_tpu_torch.experimental.channel import ChunkPipe, ChunkPipeReader

        pipe_chunk = self._ensure_policy().pipe_chunk_bytes
        host = socket.gethostname()
        # four slots: enough in-flight chunks to ride out scheduler
        # jitter on oversubscribed hosts; identical constant on every
        # member, so writer/reader slot grids always match
        mine = ChunkPipe(pipe_chunk, num_slots=self._PIPE_SLOTS)
        infos = self._exchange("pipesetup", (host, mine.name),
                               op="setup", phase="pipes")
        if any(h != host for h, _ in infos):
            mine.close()
            self._pipes = None
            return None
        pred = (self._eff_rank - 1) % self._eff_world
        reader = ChunkPipeReader(infos[pred][1], pipe_chunk,
                                 num_slots=self._PIPE_SLOTS)
        self._pipes = (mine, reader)
        return self._pipes

    def _ring_step(self, mine, pred, send: np.ndarray, recv: np.ndarray,
                   consume, chunk_elems: int) -> None:
        """One ring step, chunk-pipelined: transport of chunk k+1
        overlaps the consume (in-place reduce / copy) of chunk k, and
        the consume reads straight out of the predecessor's shm slot —
        zero reader-side copies. ``consume(dst, incoming, lo)`` receives
        the chunk's element offset so fused reducers can address the
        matching slice of a sibling buffer."""
        succ_rank = self._members[(self._eff_rank + 1) % self._eff_world]
        pred_rank = self._members[(self._eff_rank - 1) % self._eff_world]
        n_send = -(-send.size // chunk_elems) if send.size else 0
        n_recv = -(-recv.size // chunk_elems) if recv.size else 0
        for ci in range(max(n_send, n_recv)):
            lo = ci * chunk_elems
            if ci < n_send:
                chunk = memoryview(send[lo: lo + chunk_elems])
                self._guarded_wait(
                    lambda t, c=chunk: mine.write_chunk(c, timeout=t),
                    "pipe", "ring_write", ranks=[succ_rank])
            if ci < n_recv:
                dst = recv[lo: lo + chunk_elems]
                view = self._guarded_wait(
                    lambda t: pred.next_chunk(timeout=t),
                    "pipe", "ring_read", ranks=[pred_rank])
                consume(dst, np.frombuffer(view, dtype=recv.dtype), lo)
                pred.release_chunk()

    _INPLACE_REDUCERS = {
        ReduceOp.SUM: np.add,
        ReduceOp.MEAN: np.add,  # divided by the member count at the end
        ReduceOp.PRODUCT: np.multiply,
        ReduceOp.MAX: np.maximum,
        ReduceOp.MIN: np.minimum,
    }

    def _pipe_chunk_elems(self, nbytes: int, itemsize: int) -> int:
        """Adaptive ring chunk (policy.chunk_bytes_for): pure function
        of meta-agreed inputs, so every member's chunk grid matches."""
        from ray_tpu_torch.util.collective.v2 import policy as policy_mod

        chunk_bytes = policy_mod.chunk_bytes_for(
            nbytes, self._eff_world, self._ensure_policy())
        return max(1, chunk_bytes // max(1, itemsize))

    def _pipeline_allreduce(self, arr: np.ndarray,
                            op: ReduceOp) -> Optional[np.ndarray]:
        """Chunked ring allreduce (reduce-scatter + allgather) over the
        double-buffered pipes; None = no pipe plane (cross-host).

        The accumulator starts UNINITIALIZED: in the reduce-scatter
        phase each rank receives every segment exactly once, so the
        local contribution is fused into the first (only) touch —
        ``red(arr_seg, incoming, out=acc_seg)`` reads the input and the
        shm slot and writes the accumulator in ONE pass, which also
        removes the full-tensor ``arr.copy()`` from the critical path.
        Step 0 therefore sends from ``arr`` (original values); later
        steps send the partially-reduced ``acc`` segments."""
        pipes = self._ensure_pipes()
        if pipes is None:
            return None
        mine, pred = pipes
        N = self._eff_world
        me = self._eff_rank
        op = ReduceOp(op)
        red = self._INPLACE_REDUCERS[op]
        flat = arr.reshape(-1)
        if op in (ReduceOp.SUM, ReduceOp.MEAN, ReduceOp.PRODUCT) \
                and flat.dtype.kind in "bui":
            # match the object/channel paths: np.sum/np.prod promote
            # bool/small-int accumulation to 64-bit — an in-place int8
            # ring sum would overflow where np.sum does not. Same
            # promotion on every member (dtype is meta-agreed), so the
            # wire dtype stays consistent.
            flat = flat.astype(
                np.uint64 if flat.dtype.kind == "u" else np.int64)
        acc = np.empty_like(flat)
        chunk_elems = self._pipe_chunk_elems(arr.nbytes, acc.itemsize)
        bounds = [(acc.size * i) // N for i in range(N + 1)]

        def seg(buf: np.ndarray, i: int) -> np.ndarray:
            return buf[bounds[i]: bounds[i + 1]]

        # reduce-scatter: after N-1 steps rank r owns the fully-reduced
        # segment (r+1) % N
        for s in range(N - 1):
            send_idx = (me - s) % N
            recv_idx = (me - s - 1) % N
            local = seg(flat, recv_idx)

            def fused(dst, incoming, lo, _local=local):
                # fold the matching slice of the ORIGINAL input into the
                # accumulator in the same pass as the incoming chunk
                red(_local[lo: lo + dst.size], incoming, out=dst)

            self._ring_step(
                mine, pred,
                seg(flat if s == 0 else acc, send_idx),
                seg(acc, recv_idx), fused, chunk_elems)
        # allgather of the reduced segments
        for s in range(N - 1):
            self._ring_step(mine, pred,
                            seg(acc, (me + 1 - s) % N),
                            seg(acc, (me - s) % N),
                            lambda dst, incoming, _lo: np.copyto(dst, incoming),
                            chunk_elems)
        if op == ReduceOp.MEAN:
            acc = acc / N  # true divide: ints promote like np.mean
        return acc.reshape(arr.shape)

    def _pipeline_allgather(self, arr: np.ndarray) -> Optional[List[np.ndarray]]:
        """Chunked ring allgather: each member's tensor circles the
        ring once, forwarded chunk by chunk."""
        pipes = self._ensure_pipes()
        if pipes is None:
            return None
        mine, pred = pipes
        N = self._eff_world
        me = self._eff_rank
        flat = arr.reshape(-1)
        chunk_elems = self._pipe_chunk_elems(arr.nbytes, flat.itemsize)
        parts: List[Any] = [None] * N
        parts[me] = flat.copy()  # own part stays an independent copy
        for s in range(N - 1):
            send_idx = (me - s) % N
            recv_idx = (me - s - 1) % N
            parts[recv_idx] = np.empty_like(flat)
            self._ring_step(mine, pred, parts[send_idx], parts[recv_idx],
                            lambda dst, incoming, _lo: np.copyto(dst, incoming),
                            chunk_elems)
        return [p.reshape(arr.shape) for p in parts]

    def allreduce(self, tensor: Any, op: ReduceOp = ReduceOp.SUM) -> np.ndarray:
        self._begin_op()
        arr = _host(tensor)
        with obs_col.op_span("allreduce", arr.nbytes, self._eff_world,
                             self.rank) as rec:
            route = self._op_route(arr)
            if route == "hier":
                return self._executor().allreduce(arr, ReduceOp(op), rec)
            if route == "pipe":
                out = self._pipeline_allreduce(arr, ReduceOp(op))
                if out is not None:
                    rec["algo"] = "pipe"
                    return out
            elif route == "channel":
                parts = self._channel_parts(arr)
                if parts is not None:
                    rec["algo"] = "channel"
                    return _NUMPY_REDUCERS[ReduceOp(op)](np.stack(parts))
            rec["algo"] = "object"
            parts = self._exchange("allreduce", arr, op="allreduce",
                                   phase="object")
            return _NUMPY_REDUCERS[ReduceOp(op)](np.stack(parts))

    def allgather(self, tensor: Any) -> List[np.ndarray]:
        """Gather every member's tensor, in member order. At a degraded
        epoch the list is over the SURVIVORS (length = effective
        world), matching the reduction semantics."""
        self._begin_op()
        arr = _host(tensor)
        with obs_col.op_span("allgather", arr.nbytes, self._eff_world,
                             self.rank) as rec:
            route = self._op_route(arr, "allgather")
            if route == "hier":
                return self._executor().allgather(arr, rec)
            if route == "pipe":
                parts = self._pipeline_allgather(arr)
                if parts is not None:
                    rec["algo"] = "pipe"
                    return parts
            elif route == "channel":
                parts = self._channel_parts(arr)
                if parts is not None:
                    rec["algo"] = "channel"
                    return parts
            rec["algo"] = "object"
            return self._exchange("allgather", arr, op="allgather",
                                  phase="object")

    def reducescatter(self, tensor: Any, op: ReduceOp = ReduceOp.SUM) -> np.ndarray:
        """True reduce-scatter: each member leaves with ONLY its shard
        of the reduction (np.array_split axis-0 semantics over the
        CURRENT members — values are identical to the historical
        allreduce-then-slice, without materializing or fanning back the
        full tensor)."""
        from ray_tpu_torch.util.collective.v2.executor import shard_bounds

        self._begin_op()
        arr = _host(tensor)
        with obs_col.op_span("reducescatter", arr.nbytes, self._eff_world,
                             self.rank) as rec:
            route = self._op_route(arr, "reducescatter")
            if route == "hier" and arr.ndim >= 1:
                # ndim is shape-agreed, so the branch is identical on
                # every member; 0-d tensors raise in both paths
                return self._executor().reducescatter(arr, ReduceOp(op), rec)
            rec["algo"] = "object"
            parts = self._exchange("reducescatter", arr,
                                   op="reducescatter", phase="object")
            offs, shapes = shard_bounds(arr.shape, self._eff_world)
            lo, hi = offs[self._eff_rank], offs[self._eff_rank + 1]
            segs = [np.asarray(p).reshape(-1)[lo:hi] for p in parts]
            red = _NUMPY_REDUCERS[ReduceOp(op)](np.stack(segs))
            return red.reshape(shapes[self._eff_rank])

    def broadcast(self, tensor: Any, src_rank: int = 0) -> np.ndarray:
        self._begin_op()
        if self.world_size > 1 and src_rank not in self._members:
            raise self._rank_failure(
                (src_rank,), self._epoch, op="broadcast",
                phase="membership")
        arr = _host(tensor)
        with obs_col.op_span("broadcast", arr.nbytes, self._eff_world,
                             self.rank) as rec:
            route = self._op_route(arr, "broadcast")
            if route == "hier":
                return self._executor().broadcast(
                    arr, self._members.index(src_rank), rec)
            rec["algo"] = "object"
            parts = self._exchange("broadcast", arr, op="broadcast",
                                   phase="object")
            return np.asarray(parts[self._members.index(src_rank)]) \
                if self.world_size > 1 else np.asarray(parts[src_rank])

    def barrier(self) -> None:
        self._begin_op()
        with obs_col.op_span("barrier", 0, self._eff_world, self.rank):
            self._exchange("barrier", np.zeros(()), op="barrier")

    # -- p2p: per-pair sequence counters, single-rank collect -----------
    def send(self, tensor: Any, dst_rank: int) -> None:
        key = f"p2p_{self.rank}_{dst_rank}"
        seq = self._p2p_seqs.get(key, 0)
        self._p2p_seqs[key] = seq + 1
        ref = ray_tpu_torch.put(_host(tensor))
        ray_tpu_torch.get(self._rdv.put.remote(key, seq, self.rank, [ref],
                                         world_size=self.world_size))

    def recv(self, src_rank: int) -> np.ndarray:
        key = f"p2p_{src_rank}_{self.rank}"
        seq = self._p2p_seqs.get(key, 0)
        self._p2p_seqs[key] = seq + 1

        def once():
            ref = ray_tpu_torch.get(
                self._rdv.collect_from.remote(key, seq, src_rank))
            return None if ref is None else [ref]

        return self._poll_collect(
            f"recv from {src_rank} (seq={seq})", once,
            op="recv", phase="p2p", ranks=[src_rank])[0]

    # ------------------------------------------------------------------
    def close(self) -> None:
        """Release every shm endpoint this group holds (channels, meta
        channels, ring pipes, arenas). Called by
        destroy_collective_group AND by epoch adoption (the survivors
        rebuild fresh planes); safe to call more than once."""
        for st in list(self._channels.values()):
            if st:
                st[0].close()
                for _r, rd in st[1]:
                    rd.close()
        self._channels.clear()
        if self._meta not in ((), None):
            self._meta[0].close()
            for _r, rd in self._meta[1]:
                rd.close()
        self._meta = ()
        if self._pipes not in ((), None):
            self._pipes[0].close()
            self._pipes[1].close()
        self._pipes = ()
        for ar in list(self._arenas.values()):
            ar.close()
        self._arenas.clear()
