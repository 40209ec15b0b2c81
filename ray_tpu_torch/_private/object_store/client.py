"""Python client for the native shared-memory object store (copy of
ray_tpu/_private/object_store/client.py; the daemon's source is the port's
own copy, built at first use).

Reference analogue: src/ray/object_manager/plasma/client.h (PlasmaClient::
Get/CreateAndSpillIfNeeded/Seal). The C++ daemon (csrc/store.cc) owns the
pool, a memfd (so /dev/shm's size does not bound it); this client receives the pool fd once at connect (SCM_RIGHTS,
like plasma's fling.cc) and mmaps it, so Get() returns zero-copy memoryviews
into shared memory.

Thread-safe: one socket, one lock; calls are request/response.
"""

from __future__ import annotations

import array
import mmap
import os
import socket
import struct
import subprocess
import threading
import time
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch.exceptions import ObjectStoreFullError

(MSG_CONNECT, MSG_CREATE, MSG_SEAL, MSG_GET, MSG_RELEASE, MSG_CONTAINS,
 MSG_DELETE, MSG_METRICS, MSG_ABORT, MSG_LIST) = range(1, 11)
ST_OK, ST_FULL, ST_EXISTS, ST_NOT_FOUND, ST_NOT_SEALED, ST_TIMEOUT, ST_IN_USE = 0, -1, -2, -3, -4, -5, -6

_ID_SIZE = 28


_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC_DIR = os.path.join(_HERE, "csrc")
_BUILD_DIR = os.path.join(_HERE, "_build")


def store_binary_path() -> str:
    return os.path.join(_BUILD_DIR, "ray_tpu_store")


def _stale(path: str, src: str) -> bool:
    return not os.path.exists(path) or os.path.getmtime(path) < os.path.getmtime(src)


def ensure_store_built() -> str:
    """Build the C++ store daemon from csrc/ into _build/ on first use
    (``make``, with g++), under an flock: several raylets may start at
    once. A failed build raises with the compiler's output."""
    import fcntl

    path = store_binary_path()
    src = os.path.join(_SRC_DIR, "store.cc")
    if not _stale(path, src):
        return path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _stale(path, src):  # another process built it meanwhile
            return path
        cmd = ["make", "-C", _SRC_DIR, f"BUILD_DIR={_BUILD_DIR}"]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0 or not os.path.exists(path):
            raise RuntimeError(
                f"building the object store daemon failed ({' '.join(cmd)}, "
                f"exit {r.returncode}):\n{r.stdout}{r.stderr}")
    return path


def start_store_process(
    socket_path: str, capacity: int, no_evict: bool = False
) -> subprocess.Popen:
    binary = ensure_store_built()
    cmd = [binary, socket_path, str(capacity)]
    if no_evict:
        # FULL instead of silent LRU drop; the raylet spills to disk
        cmd.append("no-evict")
    proc = subprocess.Popen(
        cmd,
        stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL,
    )
    deadline = time.monotonic() + 10
    while not os.path.exists(socket_path):
        if proc.poll() is not None:
            raise RuntimeError(f"object store daemon exited with {proc.returncode}")
        if time.monotonic() > deadline:
            proc.kill()
            raise RuntimeError("object store daemon failed to start")
        time.sleep(0.005)
    return proc


class PlasmaBuffer:
    """A created-but-unsealed object: write into .data then seal()."""

    def __init__(self, client: "StoreClient", oid: ObjectID, offset: int, size: int):
        self._client = client
        self.object_id = oid
        self.data = memoryview(client._pool)[offset : offset + size]
        self._sealed = False

    def seal(self) -> None:
        self._client.seal(self.object_id)
        self._sealed = True

    def abort(self) -> None:
        if not self._sealed:
            self._client.abort(self.object_id)


class StoreClient:
    def __init__(self, socket_path: str):
        self._lock = threading.Lock()
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        deadline = time.monotonic() + 10
        while True:
            try:
                self._sock.connect(socket_path)
                break
            except (FileNotFoundError, ConnectionRefusedError):
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.01)
        self._send(MSG_CONNECT, b"")
        # reply carries the pool fd via SCM_RIGHTS
        fds = array.array("i")
        msg, ancdata, _, _ = self._sock.recvmsg(13, socket.CMSG_SPACE(4))
        while len(msg) < 13:
            chunk, anc2, _, _ = self._sock.recvmsg(13 - len(msg), socket.CMSG_SPACE(4))
            msg += chunk
            ancdata.extend(anc2)
        for level, ctype, data in ancdata:
            if level == socket.SOL_SOCKET and ctype == socket.SCM_RIGHTS:
                fds.frombytes(data[: len(data) - (len(data) % 4)])
        (payload_len,) = struct.unpack_from("<I", msg, 0)
        assert msg[4] == MSG_CONNECT and payload_len == 8
        (self.pool_size,) = struct.unpack_from("<Q", msg, 5)
        if not fds:
            raise RuntimeError("store did not pass pool fd")
        self._pool_fd = fds[0]
        self._pool = mmap.mmap(self._pool_fd, self.pool_size)

    # -- low-level framing -------------------------------------------------
    def _send(self, msg_type: int, payload: bytes) -> None:
        frame = struct.pack("<IB", len(payload), msg_type) + payload
        self._sock.sendall(frame)

    def _recv_reply(self, expect_type: int) -> bytes:
        header = self._recv_exact(5)
        (length,) = struct.unpack_from("<I", header, 0)
        mtype = header[4]
        payload = self._recv_exact(length)
        assert mtype == expect_type, f"expected msg {expect_type}, got {mtype}"
        return payload

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("object store connection closed")
            buf += chunk
        return buf

    def _call(self, msg_type: int, payload: bytes) -> bytes:
        with self._lock:
            self._send(msg_type, payload)
            return self._recv_reply(msg_type)

    # -- API ---------------------------------------------------------------
    def create(self, oid: ObjectID, size: int) -> PlasmaBuffer:
        reply = self._call(MSG_CREATE, oid.binary() + struct.pack("<Q", size))
        status, offset = struct.unpack("<iQ", reply)
        if status == ST_FULL:
            raise ObjectStoreFullError(
                f"Object store is full (requested {size} bytes, capacity {self.pool_size})"
            )
        if status == ST_EXISTS:
            raise FileExistsError(f"Object {oid.hex()} already exists in the store")
        return PlasmaBuffer(self, oid, offset, size)

    def put_bytes(self, oid: ObjectID, data: "bytes | memoryview") -> None:
        buf = self.create(oid, len(data))
        buf.data[:] = data
        buf.seal()

    def seal(self, oid: ObjectID) -> None:
        reply = self._call(MSG_SEAL, oid.binary())
        (status,) = struct.unpack("<i", reply)
        if status != ST_OK:
            raise KeyError(f"seal: object {oid.hex()} not found")

    def abort(self, oid: ObjectID) -> None:
        self._call(MSG_ABORT, oid.binary())

    def get(
        self, oids: List[ObjectID], timeout_ms: int = -1
    ) -> List[Optional[memoryview]]:
        """Fetch sealed objects; returns zero-copy views (None on timeout).

        Each returned view holds a server-side pin; call release() when done.
        """
        payload = struct.pack("<I", len(oids))
        for oid in oids:
            payload += oid.binary()
        payload += struct.pack("<q", timeout_ms)
        reply = self._call(MSG_GET, payload)
        (n,) = struct.unpack_from("<I", reply, 0)
        out: List[Optional[memoryview]] = []
        off = 4
        pool_view = memoryview(self._pool)
        for _ in range(n):
            status, offset, size = struct.unpack_from("<iQQ", reply, off)
            off += 20
            if status == ST_OK:
                out.append(pool_view[offset : offset + size])
            else:
                out.append(None)
        return out

    def release(self, oid: ObjectID) -> None:
        self._call(MSG_RELEASE, oid.binary())

    def contains(self, oid: ObjectID) -> bool:
        return self.contains_state(oid) == 0

    def contains_state(self, oid: ObjectID) -> int:
        """0 = sealed, 1 = created-but-unsealed, 2 = absent."""
        reply = self._call(MSG_CONTAINS, oid.binary())
        (status,) = struct.unpack("<i", reply)
        return status

    def delete(self, oid: ObjectID) -> int:
        """Returns the store status (ST_OK, ST_NOT_FOUND, or ST_IN_USE —
        the latter defers the delete to the last pin release)."""
        reply = self._call(MSG_DELETE, oid.binary())
        (status,) = struct.unpack("<i", reply)
        return status

    def list_objects(self) -> List[Tuple[bytes, int, bool, bool]]:
        """All objects, LRU-oldest first: (id_bytes, size, sealed, pinned).
        Feeds the raylet's spill-candidate selection."""
        reply = self._call(MSG_LIST, b"")
        (n,) = struct.unpack_from("<I", reply, 0)
        out: List[Tuple[bytes, int, bool, bool]] = []
        off = 4
        for _ in range(n):
            oid = bytes(reply[off : off + _ID_SIZE])
            size, sealed, pinned = struct.unpack_from("<QBB", reply, off + _ID_SIZE)
            off += _ID_SIZE + 10
            out.append((oid, size, bool(sealed), bool(pinned)))
        return out

    def metrics(self) -> Dict[str, int]:
        reply = self._call(MSG_METRICS, b"")
        cap, alloc, nobj, nevict, bevict = struct.unpack("<QQQQQ", reply)
        return {
            "capacity": cap,
            "allocated": alloc,
            "num_objects": nobj,
            "num_evictions": nevict,
            "bytes_evicted": bevict,
        }

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
        try:
            self._pool.close()
        except (BufferError, ValueError):
            pass  # outstanding memoryviews keep the map alive
        try:
            os.close(self._pool_fd)
        except OSError:
            pass
