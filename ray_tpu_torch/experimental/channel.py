"""Mutable-object channels — fixed shared-memory slots rewritten in
place for repeated host-side transfers (copy of
ray_tpu/experimental/channel.py; ``TensorChannel.write`` also takes a
CPU ``torch.Tensor``).

Reference: src/ray/core_worker/experimental_mutable_object_manager.h:44
and python/ray/experimental/channel/shared_memory_channel.py — the
compiled-DAG transport. A channel is ONE shm buffer with a seqlock
header; the writer overwrites the slot each iteration and readers
acquire/release by sequence number, so steady-state transfer does no
allocation, no socket round-trip, and no object-store bookkeeping.

Layout: [seq u64][len u64][ack_0 u64 ... ack_{R-1} u64][payload].
Classic seqlock shape: seq is EVEN when the slot is stable, ODD while
a write is in progress; each write advances it by 2. Write protocol:
wait until every reader's ack == seq (previous value consumed) →
seq+1 (odd) → write len + payload → seq+2 (even). Read protocol: wait
until an even seq > last seen → copy payload → re-read seq; if it
moved, the copy may be torn — retry → store ack = seq.

Honesty note on memory ordering: CPython exposes no fences, so the
re-check narrows but cannot fully close the weak-ordering window (a
reader could in principle observe the even seq before the payload
stores on e.g. ARM). On x86-TSO the store order plus the re-check make
torn reads impossible; full portability would need real atomics in a
C extension.

Endpoints pickle by shm name, so channels pass through task args to
actors on the same node (host-local, like the reference's shm channels;
cross-node channels go through the object store instead).
"""

from __future__ import annotations

import pickle
import struct
import time
from multiprocessing import shared_memory
from typing import Any, Optional

_U64 = struct.Struct("<Q")


class ChannelTimeoutError(TimeoutError):
    pass


# segments created by THIS process (tracker-registered on purpose)
_created_here: set = set()


def _attach_shm(name: str) -> shared_memory.SharedMemory:
    """Attach (not create) a named segment. Attaching registers the
    segment with THIS process's resource_tracker, which unlinks it when
    the process exits (cpython#82300) — a killed reader would destroy a
    segment the writer and other readers still use. Only the creating
    endpoint may unlink, so deregister the attach (unless this process
    IS the creator — e.g. a driver opening readers on its own channel —
    where deregistering would orphan the creator's registration)."""
    shm = shared_memory.SharedMemory(name=name)
    if shm._name not in _created_here:
        try:
            from multiprocessing import resource_tracker

            resource_tracker.unregister(shm._name, "shared_memory")
        except Exception:  # noqa: BLE001
            pass
    return shm


class _Endpoint:
    def __init__(self, name: str, capacity: int, num_readers: int,
                 create: bool):
        self.name = name
        self.capacity = capacity
        self.num_readers = num_readers
        self._hdr = 16 + 8 * num_readers
        if create:
            self._shm = shared_memory.SharedMemory(
                name=name, create=True, size=self._hdr + capacity)
            _created_here.add(self._shm._name)
            self._shm.buf[: self._hdr] = b"\x00" * self._hdr
        else:
            self._shm = _attach_shm(name)
        self._owner = create
        # u64 view over the header: ~3x faster than struct.unpack_from
        # per access, and the seqlock protocol reads the header in every
        # spin iteration
        self._hu = self._shm.buf[: self._hdr].cast("Q")

    # -- header accessors (word-indexed) --------------------------------
    def _get(self, off: int) -> int:
        return self._hu[off >> 3]

    def _put(self, off: int, v: int) -> None:
        self._hu[off >> 3] = v

    @property
    def _seq(self) -> int:
        return self._hu[0]

    def _release_views(self) -> None:
        """Drop cached views of the mapping so shm.close() can succeed
        (exported pointers block the munmap)."""
        hu, self._hu = self._hu, None
        if hu is not None:
            try:
                hu.release()
            except Exception:  # noqa: BLE001
                pass

    def close(self) -> None:
        try:
            self._release_views()
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


def _tensor_nbytes(shape, dtype) -> int:
    import numpy as np

    return int(np.dtype(dtype).itemsize * max(1, int(np.prod(tuple(shape)))))


class ChannelReader(_Endpoint):
    """One reader endpoint (index < num_readers)."""

    def __init__(self, name: str, capacity: int, num_readers: int,
                 reader_index: int, _create: bool = False):
        super().__init__(name, capacity, num_readers, create=_create)
        self.reader_index = reader_index
        self._last = self._get(16 + 8 * reader_index)

    def _await_next(self, deadline: Optional[float],
                    timeout: Optional[float]) -> int:
        """Spin until a stable (even) sequence newer than the last-read
        one exists. Pure spins first (sub-transfer latency), then
        progressive naps capped at 0.4 ms — on CPU-starved hosts an
        unbounded busy-poll steals the very cycles the writer needs,
        while a high nap cap overshoots fast writers."""
        spins = 0
        nap = 0.0001
        while True:
            seq = self._seq
            if seq > self._last and seq % 2 == 0:
                return seq
            if deadline is not None and time.monotonic() > deadline:
                raise ChannelTimeoutError(
                    f"no write within {timeout}s (seq={seq})")
            spins += 1
            if spins > 50:
                time.sleep(nap)
                nap = min(nap * 2, 0.0004)

    def read(self, timeout: Optional[float] = 10.0) -> Any:
        """Block until the NEXT value is written; acknowledge it."""
        # one deadline for the whole call: the seqlock retry loop must
        # not restart the clock each time a concurrent write invalidates
        # a copy, or the declared timeout stops being an upper bound
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            seq = self._await_next(deadline, timeout)
            n = self._get(8)
            data = bytes(self._shm.buf[self._hdr: self._hdr + n])
            if self._seq == seq:  # seqlock re-check: no concurrent write
                break
        value = pickle.loads(data)
        self._last = seq
        self._put(16 + 8 * self.reader_index, seq)  # release
        return value

    def __reduce__(self):
        return (ChannelReader, (self.name, self.capacity, self.num_readers,
                                self.reader_index))


class Channel(_Endpoint):
    """Writer endpoint; create once, ``write()`` per iteration.

    num_readers readers must each ``read()`` every value before the next
    write proceeds (the reference's acquire/release backpressure).
    """

    def __init__(self, capacity: int = 1 << 20, num_readers: int = 1,
                 name: Optional[str] = None, _attach: bool = False):
        import uuid

        name = name or f"rtch_{uuid.uuid4().hex[:12]}"
        super().__init__(name, capacity, num_readers,
                         create=not _attach)

    def _await_acks(self, seq: int, timeout: Optional[float]) -> None:
        """Spin until every reader consumed the previous value (same
        spin-then-nap rationale as ChannelReader._await_next)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        spins = 0
        nap = 0.0001
        while any(self._get(16 + 8 * i) < seq
                  for i in range(self.num_readers)):
            if deadline is not None and time.monotonic() > deadline:
                raise ChannelTimeoutError(
                    f"readers did not consume value {seq} within {timeout}s")
            spins += 1
            if spins > 50:
                time.sleep(nap)
                nap = min(nap * 2, 0.0004)

    def write(self, value: Any, timeout: Optional[float] = 10.0) -> None:
        data = pickle.dumps(value, protocol=5)
        if len(data) > self.capacity:
            raise ValueError(
                f"value of {len(data)}B exceeds channel capacity "
                f"{self.capacity}B")
        seq = self._seq
        self._await_acks(seq, timeout)
        self._put(0, seq + 1)  # odd: write in progress
        self._shm.buf[self._hdr: self._hdr + len(data)] = data
        self._put(8, len(data))
        self._put(0, seq + 2)  # even: release

    def reader(self, reader_index: int = 0) -> ChannelReader:
        if not 0 <= reader_index < self.num_readers:
            raise ValueError(
                f"reader_index {reader_index} out of range "
                f"(num_readers={self.num_readers})")
        return ChannelReader(self.name, self.capacity, self.num_readers,
                             reader_index)

    def __reduce__(self):
        # an unpickled writer endpoint attaches (does not re-create/own)
        return (Channel, (self.capacity, self.num_readers, self.name, True))


# ---------------------------------------------------------------------------
# Typed tensor channels — the RDT host path (reference:
# python/ray/experimental/rdt/ — tensor transports bypassing the object
# store). Fixed shape+dtype means the payload is written as raw array
# bytes straight into shared memory: no pickling, no allocation per
# transfer. CUDA tensors go through experimental/rdt.py, which stages
# them on the host first.
# ---------------------------------------------------------------------------
class TensorChannelReader(ChannelReader):
    def __init__(self, name: str, shape, dtype: str, num_readers: int,
                 reader_index: int):
        import numpy as np

        self.shape = tuple(shape)
        self.dtype = dtype
        super().__init__(name, _tensor_nbytes(shape, dtype), num_readers,
                         reader_index)
        # the slot view is position-independent: build it once, not per read
        self._slot = np.ndarray(self.shape, self.dtype,
                                buffer=self._shm.buf, offset=self._hdr)
        self._borrowed = False

    def read(self, timeout: Optional[float] = 10.0):
        """Returns a fresh ndarray (copied out of the slot — the writer
        reuses it immediately after the ack)."""
        import numpy as np

        self._end_borrow()
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            seq = self._await_next(deadline, timeout)
            out = np.copy(self._slot)
            if self._seq == seq:  # seqlock re-check: no concurrent write
                break
        self._last = seq
        self._put(16 + 8 * self.reader_index, seq)
        return out

    def read_view(self, timeout: Optional[float] = 10.0):
        """Zero-copy borrowed read: returns a READ-ONLY view of the slot
        itself. The view is valid until ``release()`` (or the next
        read/read_view, which releases implicitly); the writer cannot
        overwrite the slot while the borrow is outstanding because the
        ack is withheld. This is the copy-free consumption path the
        pipelined collectives use (reduce directly out of shared memory);
        ``read()`` remains the safe owning-copy default."""
        self._end_borrow()
        deadline = None if timeout is None else time.monotonic() + timeout
        seq = self._await_next(deadline, timeout)
        # no re-check needed: the writer blocks on our ack before the
        # next write, so the slot is stable until release()
        self._last = seq
        self._borrowed = True
        view = self._slot.view()
        view.flags.writeable = False
        return view

    def release(self) -> None:
        """Ack the borrowed slot from read_view(), letting the writer
        reuse it. The borrowed view must no longer be read."""
        self._end_borrow()

    def _end_borrow(self) -> None:
        if self._borrowed:
            self._borrowed = False
            self._put(16 + 8 * self.reader_index, self._last)

    def close(self) -> None:
        self._end_borrow()  # ack an outstanding read_view borrow
        self._slot = None
        super().close()

    def __reduce__(self):
        return (TensorChannelReader, (self.name, self.shape, self.dtype,
                                      self.num_readers, self.reader_index))


def _host_array(arr):
    """A CPU torch.Tensor as its numpy view (same memory); anything else
    as it is. torch is looked up, not imported: a process that never
    made a tensor has none to pass."""
    import sys

    torch = sys.modules.get("torch")
    if torch is None or not isinstance(arr, torch.Tensor):
        return arr
    if arr.device.type != "cpu" or arr.dtype == torch.bfloat16:
        # numpy has no bfloat16: rdt carries its bits as uint16
        raise ValueError(
            f"TensorChannel.write takes a CPU tensor of a numpy dtype, got "
            f"{arr.dtype} on {arr.device}; experimental.rdt.DeviceTensorChannel "
            "carries CUDA and bfloat16 tensors")
    return arr.detach().numpy()


class TensorChannel(Channel):
    """Zero-copy fixed-shape tensor slot: ``write`` copies array bytes
    directly into shared memory (no pickle)."""

    def __init__(self, shape, dtype: str = "float32", num_readers: int = 1,
                 name: Optional[str] = None, _attach: bool = False):
        import numpy as np

        self.shape = tuple(shape)
        self.dtype = str(np.dtype(dtype))
        super().__init__(_tensor_nbytes(shape, dtype), num_readers, name,
                         _attach)
        self._slot = np.ndarray(self.shape, self.dtype,
                                buffer=self._shm.buf, offset=self._hdr)

    def write(self, arr, timeout: Optional[float] = 10.0) -> None:
        """``arr``: an ndarray, or a CPU ``torch.Tensor`` (read through its
        numpy view, no copy), of the channel's shape and dtype."""
        import numpy as np

        arr = _host_array(arr)
        if getattr(arr, "shape", None) != self.shape \
                or str(getattr(arr, "dtype", "")) != self.dtype:
            arr = np.asarray(arr)
            if arr.shape != self.shape or str(arr.dtype) != self.dtype:
                raise ValueError(
                    f"expected {self.shape} {self.dtype}, got "
                    f"{arr.shape} {arr.dtype}")
        seq = self._seq
        self._await_acks(seq, timeout)
        self._put(0, seq + 1)  # odd: write in progress
        # copyto handles non-contiguous sources directly: exactly one
        # payload copy, source array → shared memory
        np.copyto(self._slot, arr)
        self._put(8, self._slot.nbytes)
        self._put(0, seq + 2)  # even: release

    def close(self) -> None:
        self._slot = None
        super().close()

    def reader(self, reader_index: int = 0) -> TensorChannelReader:
        if not 0 <= reader_index < self.num_readers:
            raise ValueError(
                f"reader_index {reader_index} out of range "
                f"(num_readers={self.num_readers})")
        return TensorChannelReader(self.name, self.shape, self.dtype,
                                   self.num_readers, reader_index)

    def __reduce__(self):
        return (TensorChannel, (self.shape, self.dtype, self.num_readers,
                                self.name, True))


# ---------------------------------------------------------------------------
# ChunkPipe — double-buffered byte-chunk transport for PIPELINED
# collectives. A pipe is ``num_slots`` independent seqlock slots of
# ``chunk_bytes`` each in one shm segment; the writer round-robins the
# slots, so chunk k+1 is in flight while the consumer still reduces
# chunk k straight out of slot k (transport/compute overlap with zero
# reader-side copies). Shape-independent: one pipe per ring edge serves
# every tensor the group ever reduces.
# ---------------------------------------------------------------------------
_SLOT_HDR = 24  # [seq u64][len u64][ack u64] — single reader per pipe


class _PipeBase:
    def __init__(self, name: str, chunk_bytes: int, num_slots: int,
                 create: bool):
        self.name = name
        self.chunk_bytes = chunk_bytes
        self.num_slots = num_slots
        self._stride = _SLOT_HDR + chunk_bytes
        size = self._stride * num_slots
        if create:
            self._shm = shared_memory.SharedMemory(
                name=name, create=True, size=size)
            _created_here.add(self._shm._name)
            # fresh POSIX shm is zero-filled by ftruncate; zero only the
            # slot headers defensively (multi-MiB payload memset wasted)
            for i in range(num_slots):
                off = i * self._stride
                self._shm.buf[off: off + _SLOT_HDR] = b"\x00" * _SLOT_HDR
        else:
            self._shm = _attach_shm(name)
        self._owner = create
        # one u64 header view per slot (cast views beat struct.unpack
        # in the spin loops), plus one payload view per slot
        self._hu = [
            self._shm.buf[i * self._stride: i * self._stride + _SLOT_HDR
                          ].cast("Q")
            for i in range(num_slots)
        ]
        self._payload = [
            self._shm.buf[i * self._stride + _SLOT_HDR:
                          (i + 1) * self._stride]
            for i in range(num_slots)
        ]
        self._count = 0  # monotonically increasing chunk counter

    @staticmethod
    def _spin(cond, deadline: Optional[float], what: str):
        """Pipe waits are SHORT (a peer's chunk memcpy, tens to hundreds
        of µs): spin, then yield the core (sched_yield keeps the peer
        process fed on oversubscribed hosts), then short capped naps —
        the 0.4 ms naps of the generic channels overshoot every chunk
        and halve delivered pipeline bandwidth."""
        spins = 0
        nap = 0.00005
        while not cond():
            spins += 1
            if spins > 4000:
                if deadline is not None and time.monotonic() > deadline:
                    raise ChannelTimeoutError(what)
                time.sleep(nap)
                nap = min(nap * 2, 0.0002)
            elif spins % 200 == 0:
                time.sleep(0)  # yield to the peer on a saturated host
                if deadline is not None and time.monotonic() > deadline:
                    raise ChannelTimeoutError(what)

    def close(self) -> None:
        try:
            views, self._hu, self._payload = \
                (self._hu or []) + (self._payload or []), None, None
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


class ChunkPipe(_PipeBase):
    """Writer endpoint. ``write_chunk`` blocks only when every slot is
    still un-acked — with the default two slots the transport of one
    chunk overlaps the consumer's reduce of the previous one."""

    def __init__(self, chunk_bytes: int, num_slots: int = 2,
                 name: Optional[str] = None, _attach: bool = False):
        import uuid

        name = name or f"rtpipe_{uuid.uuid4().hex[:12]}"
        super().__init__(name, chunk_bytes, num_slots, create=not _attach)

    def write_chunk(self, data, timeout: Optional[float] = 10.0) -> None:
        """Copy ``data`` (buffer-protocol, <= chunk_bytes) into the next
        slot; exactly one payload copy, source → shared memory."""
        mv = data if isinstance(data, memoryview) else memoryview(data)
        if mv.nbytes > self.chunk_bytes:
            raise ValueError(
                f"chunk of {mv.nbytes}B exceeds pipe chunk size "
                f"{self.chunk_bytes}B")
        slot = self._count % self.num_slots
        h = self._hu[slot]
        seq = h[0]
        deadline = None if timeout is None else time.monotonic() + timeout
        # previous value in this slot must be consumed (ack == seq)
        self._spin(lambda: h[2] >= seq, deadline,
                   f"pipe reader did not consume slot {slot} "
                   f"within {timeout}s")
        h[0] = seq + 1  # odd: write in progress
        if mv.format != "B" or mv.ndim != 1:
            mv = mv.cast("B")
        self._payload[slot][: mv.nbytes] = mv
        h[1] = mv.nbytes
        h[0] = seq + 2  # even: release
        self._count += 1

    def __reduce__(self):
        return (ChunkPipe, (self.chunk_bytes, self.num_slots, self.name,
                            True))


class ChunkPipeReader(_PipeBase):
    """Reader endpoint; strict borrow discipline:

        view = r.next_chunk()   # zero-copy view of the slot payload
        ... consume (reduce/copy out of shared memory) ...
        r.release_chunk()       # ack — the writer may now reuse the slot
    """

    def __init__(self, name: str, chunk_bytes: int, num_slots: int = 2):
        super().__init__(name, chunk_bytes, num_slots, create=False)
        self._borrowed: Optional[int] = None

    def next_chunk(self, timeout: Optional[float] = 10.0) -> memoryview:
        assert self._borrowed is None, "previous chunk not released"
        slot = self._count % self.num_slots
        h = self._hu[slot]
        last = self._last_seq(slot)
        deadline = None if timeout is None else time.monotonic() + timeout
        self._spin(lambda: h[0] > last and h[0] % 2 == 0, deadline,
                   f"no chunk in slot {slot} within {timeout}s")
        self._borrowed = slot
        return self._payload[slot][: h[1]]

    def _last_seq(self, slot: int) -> int:
        # the ack we last published for this slot IS the last seq consumed
        return self._hu[slot][2]

    def release_chunk(self) -> None:
        slot, self._borrowed = self._borrowed, None
        if slot is not None:
            h = self._hu[slot]
            h[2] = h[0]  # ack the seq we just consumed
            self._count += 1

    def __reduce__(self):
        return (ChunkPipeReader, (self.name, self.chunk_bytes,
                                  self.num_slots))
