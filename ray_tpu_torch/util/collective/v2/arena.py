"""ShmArena — the intra-host transport of the v2 collective stack (copy of
ray_tpu/util/collective/v2/arena.py).

One arena joins the ranks of ONE host (the topology's local group) for
one message-size bucket. Unlike the ring pipes (per-edge, per-chunk
lockstep — 2(L-1) synchronized steps per op), an arena op has exactly
three synchronization points regardless of message size, which is what
keeps L oversubscribed processes on few cores from ping-ponging the
scheduler:

Layout::

    [header][L input slots of slot_bytes][segment region of region_bytes]

Header: three u64 counters per local rank — ``wrote[r]``, ``posted[r]``,
``done[r]`` — each a monotonically increasing op sequence number,
written only by rank r (single-writer cells: the seqlock torn-read
hazards of the generic channels cannot arise; cross-core visibility
relies on x86-TSO like the rest of the shm plane — honesty note in
experimental/channel.py).

Per-op protocol (every local rank executes every arena op in the same
order — the group-wide per-op routing agreement guarantees it)::

    q = arena.begin(timeout)       # waits all done >= q-1 (slot reuse safe)
    ... write my contribution into arena.slot(local_rank) ...
    arena.mark_wrote(); arena.wait_wrote(timeout)
    ... reduce straight out of peers' slots (zero copies) ...
    ... optionally publish a segment into the region ...
    arena.mark_posted(); arena.wait_posted(timeout)
    ... read final segments out of the region ...
    arena.mark_done()

Ranks that have nothing to write in a phase (e.g. non-source ranks of a
broadcast) still mark it — counters stay in lockstep so the next op's
waits never stall on a rank that legitimately skipped a phase.
"""

from __future__ import annotations

import time
import uuid
from multiprocessing import shared_memory
from typing import Optional

from ray_tpu_torch.experimental.channel import ChannelTimeoutError, _attach_shm


def _arena_wait(cond, deadline, what: str) -> None:
    """Arena waits bracket WHOLE phases (a peer's multi-ms encode or
    reduce), not single-chunk memcpys — so unlike the pipe spin, burn
    almost no cycles: a short spin for the already-done case, then
    yield, then naps backing off to 1 ms. On the 1-core CI host every
    cycle spent spinning is a cycle the working peer doesn't get."""
    spins = 0
    nap = 0.00005
    while not cond():
        spins += 1
        if spins <= 20:
            continue
        if spins <= 60:
            time.sleep(0)  # sched_yield: hand the core to the peer
        else:
            if deadline is not None and time.monotonic() > deadline:
                raise ChannelTimeoutError(what)
            time.sleep(nap)
            nap = min(nap * 2, 0.001)


class ShmArena:
    def __init__(self, local_world: int, local_rank: int, slot_bytes: int,
                 region_bytes: int, name: Optional[str] = None,
                 create: bool = False):
        self.local_world = int(local_world)
        self.local_rank = int(local_rank)
        self.slot_bytes = int(slot_bytes)
        self.region_bytes = int(region_bytes)
        self.name = name or f"rtarena_{uuid.uuid4().hex[:12]}"
        self._hdr = 8 * 3 * self.local_world
        size = self._hdr + self.local_world * self.slot_bytes \
            + self.region_bytes
        if create:
            self._shm = shared_memory.SharedMemory(
                name=self.name, create=True, size=size)
            self._shm.buf[: self._hdr] = b"\x00" * self._hdr
        else:
            # not tracker-registered: only the leader unlinks the arena
            # (the JAX package's copy attaches plainly, so a member's
            # exit unlinks it and warns of a leak)
            self._shm = _attach_shm(self.name)
        self._owner = create
        self._hu = self._shm.buf[: self._hdr].cast("Q")
        self._slots = [
            self._shm.buf[self._hdr + r * self.slot_bytes:
                          self._hdr + (r + 1) * self.slot_bytes]
            for r in range(self.local_world)
        ]
        roff = self._hdr + self.local_world * self.slot_bytes
        self._region = self._shm.buf[roff: roff + self.region_bytes]
        self._q = 0  # local mirror of the op sequence

    # -- counter cells: [wrote_0..wrote_{L-1}, posted_*, done_*] --------
    def _get(self, row: int, r: int) -> int:
        return self._hu[row * self.local_world + r]

    def _set(self, row: int, r: int, v: int) -> None:
        self._hu[row * self.local_world + r] = v

    def _wait_row(self, row: int, q: int, timeout: Optional[float],
                  what: str, only: Optional[int] = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        if only is not None:
            _arena_wait(lambda: self._get(row, only) >= q, deadline, what)
            return
        for r in range(self.local_world):
            _arena_wait(lambda r=r: self._get(row, r) >= q, deadline, what)

    # -- protocol -------------------------------------------------------
    def begin(self, timeout: Optional[float] = 120.0) -> int:
        """Open the next op: waits until every local rank finished the
        previous one, so slot/region reuse cannot tear a late reader."""
        q = self._q + 1
        self._wait_row(2, q - 1, timeout,
                       f"arena {self.name}: a local rank never finished "
                       f"op {q - 1} within {timeout}s")
        self._q = q
        return q

    def mark_wrote(self) -> None:
        self._set(0, self.local_rank, self._q)

    def wait_wrote(self, timeout: Optional[float] = 120.0,
                   only: Optional[int] = None) -> None:
        self._wait_row(0, self._q, timeout,
                       f"arena {self.name}: input slots incomplete for op "
                       f"{self._q} within {timeout}s", only=only)

    def mark_posted(self) -> None:
        self._set(1, self.local_rank, self._q)

    def wait_posted(self, timeout: Optional[float] = 120.0) -> None:
        self._wait_row(1, self._q, timeout,
                       f"arena {self.name}: region segments incomplete for "
                       f"op {self._q} within {timeout}s")

    def mark_done(self) -> None:
        self._set(2, self.local_rank, self._q)

    # -- data views -----------------------------------------------------
    def slot(self, local_rank: int) -> memoryview:
        return self._slots[local_rank]

    def region(self) -> memoryview:
        return self._region

    # ------------------------------------------------------------------
    def close(self) -> None:
        try:
            views = ([self._hu] if self._hu is not None else []) \
                + (self._slots or []) \
                + ([self._region] if self._region is not None else [])
            self._hu, self._slots, self._region = None, None, None
            for v in views:
                try:
                    v.release()
                except Exception:  # noqa: BLE001
                    pass
            self._shm.close()
            if self._owner:
                self._shm.unlink()
        except Exception:  # noqa: BLE001
            pass

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass
