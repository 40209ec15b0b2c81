"""Serialization of task args / return values / put objects (copy of
ray_tpu/_private/serialization.py, over the vendored cloudpickle, with a
reduction of ``torch.Tensor``).

Reference: python/ray/_private/serialization.py. Uses cloudpickle with
pickle-protocol-5 out-of-band buffers so large numpy arrays and torch
tensors are captured as contiguous buffers (zero-copy into/out of the
shared-memory object store), plus a per-job custom-serializer registry.

Tensors: a strided CPU tensor goes out of band as its dtype, shape and
bytes (bf16 as its 16-bit patterns); a CUDA tensor is pulled to the host
first (``_device_to_host``) and arrives as a CPU tensor, as a
``jax.Array`` arrives as a numpy array in the JAX package. A tensor read
from the store is a zero-copy view of it (through numpy, whose array holds
the store's pin for as long as the tensor's storage lives), and can be
written, as JAX's numpy array over the same view can: the write lands in
the sealed object that other readers share, so ``.clone()`` before writing
in place. Where JAX's array is read-only (it arrived inline, as bytes), the
tensor is a copy of its own, since torch has no read-only tensors.

Wire format of a serialized object:
    [u32 meta_len][meta pickle][u32 nbuffers][u64 len, bytes]...
where meta is the cloudpickle payload with PickleBuffer placeholders.

Zero-copy data plane: ``serialize_prepare`` pickles the value ONCE into a
small meta blob plus borrowed views of the out-of-band payload buffers,
and ``SerializedValue.write_into`` lays the wire format straight into a
caller-provided mapping (the plasma Create→write-in-place→Seal path) —
payload bytes move exactly once, source array → shared memory.  Every
INTERMEDIATE payload materialization (the legacy bytes-joining
``serialize``, the pre-3.12 copy-out in ``deserialize``) is recorded in a
process-local copy counter exported on the metrics scrape
(``ray_tpu_payload_copies``), so "0 payload copies on the put path" is a
testable invariant, not a code-review claim.
"""

from __future__ import annotations

import io
import pickle
import struct
import sys
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch._private import cloudpickle, fastpath

_custom_serializers: Dict[type, Tuple[Callable, Callable]] = {}
_lock = threading.Lock()

# ---------------------------------------------------------------------------
# Payload-copy accounting. Counts INTERMEDIATE materializations of
# out-of-band payload bytes (joins into temporary bytes objects, copy-outs
# of shared-memory views) — NOT the single unavoidable write into the
# destination mapping/socket. The zero-copy put path must keep the "put"
# series at zero; tests assert on deltas of ``copy_stats()``.
# ---------------------------------------------------------------------------
_copy_lock = threading.Lock()
# "put" = the plasma zero-copy path (must stay 0); "inline" = joins of
# sub-threshold values bound for the in-memory store (expected, small);
# "get" = deserialize copy-outs; "rpc" = RPC body materializations
_copy_counts: Dict[str, int] = {"put": 0, "inline": 0, "get": 0, "rpc": 0}
_copy_bytes: Dict[str, int] = {"put": 0, "inline": 0, "get": 0, "rpc": 0}
_copy_metrics_registered = False


def record_payload_copy(path: str, nbytes: int, n: int = 1) -> None:
    """Record ``n`` intermediate payload copies totalling ``nbytes`` on a
    data-plane path ("put" | "get" | "rpc")."""
    with _copy_lock:
        _copy_counts[path] = _copy_counts.get(path, 0) + n
        _copy_bytes[path] = _copy_bytes.get(path, 0) + nbytes


def copy_stats() -> Dict[str, Dict[str, int]]:
    """Snapshot of the process-local payload-copy counters."""
    with _copy_lock:
        return {
            "copies": dict(_copy_counts),
            "bytes": dict(_copy_bytes),
        }


def _ensure_copy_metrics() -> None:
    """Register the copy counters on the metrics scrape, once. Lazy (first
    data-plane use) so importing this module never spawns the pusher."""
    global _copy_metrics_registered
    if _copy_metrics_registered:
        return
    _copy_metrics_registered = True
    try:
        from ray_tpu_torch.util.metrics import Metric

        class _CopyCounter(Metric):
            """Live view over the module counters: zero hot-path cost —
            the registry reads the dicts only at snapshot time."""

            def __init__(self, name: str, values: Dict[str, int],
                         description: str):
                super().__init__(name, description, tag_keys=("path",))
                self._live = values

            def _snapshot(self) -> dict:
                with _copy_lock:
                    series = [{"tags": {"path": k}, "value": float(v)}
                              for k, v in self._live.items()]
                return {"name": self._name, "type": "counter",
                        "description": self._description, "series": series}

        _CopyCounter(
            "ray_tpu_payload_copies", _copy_counts,
            "Intermediate payload-byte copies on the data plane")
        _CopyCounter(
            "ray_tpu_payload_copy_bytes", _copy_bytes,
            "Intermediate payload bytes copied on the data plane")
    except Exception:  # noqa: BLE001 — metrics must never break the data plane
        pass

# Thread-local collector: while active, every ObjectRef pickled through
# serialize() is recorded so callers can pin/borrow-register contained
# refs (reference: nested-ref tracking in reference_counter.h:44).
_collect_ctx = threading.local()


class collect_object_refs:
    """Context manager; exposes `.refs` — the list of ObjectRefs that were
    serialized (nested at any depth) while active on this thread."""

    def __enter__(self):
        self._prev = getattr(_collect_ctx, "refs", None)
        _collect_ctx.refs = self.refs = []
        return self

    def __exit__(self, *exc):
        _collect_ctx.refs = self._prev
        return False


def register_serializer(cls: type, *, serializer: Callable, deserializer: Callable) -> None:
    """Register a custom (de)serializer pair (reference:
    ray.util.register_serializer)."""
    with _lock:
        _custom_serializers[cls] = (serializer, deserializer)


def deregister_serializer(cls: type) -> None:
    with _lock:
        _custom_serializers.pop(cls, None)


class _CustomPickler(cloudpickle.Pickler):
    def __init__(self, file, protocol=5, buffer_callback=None):
        super().__init__(file, protocol=protocol, buffer_callback=buffer_callback)

    def reducer_override(self, obj):
        from ray_tpu_torch._private.object_ref import ObjectRef

        if isinstance(obj, ObjectRef):
            refs = getattr(_collect_ctx, "refs", None)
            if refs is not None:
                refs.append(obj)
            return obj.__reduce__()
        s = _custom_serializers.get(type(obj))
        if s is not None:
            ser, deser = s
            return (_reconstruct_custom, (type(obj).__module__, type(obj).__qualname__, ser(obj)))
        torch = sys.modules.get("torch")  # no tensor exists before its import
        if torch is not None and type(obj) in (torch.Tensor, torch.nn.Parameter) \
                and obj.layout == torch.strided and obj.device.type in ("cpu", "cuda"):
            return _reduce_tensor(obj)
        # Delegate to cloudpickle's reducer_override — that is where its
        # pickle-functions/classes-by-value logic lives; returning
        # NotImplemented here would silently downgrade to plain pickle.
        return super().reducer_override(obj)


def _reconstruct_custom(module: str, qualname: str, payload: Any):
    import importlib

    mod = importlib.import_module(module)
    cls = mod
    for part in qualname.split("."):
        cls = getattr(cls, part)
    _, deser = _custom_serializers[cls]
    return deser(payload)


def _device_to_host(obj: "torch.Tensor") -> "torch.Tensor":
    """A CUDA tensor is pulled to the host before pickling (the JAX
    package's jax.Array pickles to host by itself)."""
    return obj.detach().cpu() if obj.is_cuda else obj.detach()


def _reduce_tensor(obj: "torch.Tensor"):
    """(rebuild, (dtype name, shape, requires_grad, raw bytes)): the
    bytes go out of band as one PickleBuffer over the contiguous host
    tensor's storage, viewed as uint8 (any dtype, bf16 included). A
    Parameter arrives as a plain tensor; other subclasses, sparse and
    quantized tensors keep torch's own pickling."""
    import torch

    host = _device_to_host(obj).contiguous()
    raw = host.reshape(-1).view(torch.uint8).numpy()
    return (_rebuild_tensor, (str(host.dtype).removeprefix("torch."),
                              tuple(host.shape), obj.requires_grad,
                              pickle.PickleBuffer(raw)))


def _rebuild_tensor(dtype: str, shape, requires_grad: bool, buf) -> "torch.Tensor":
    import numpy as np
    import torch

    dt = getattr(torch, dtype)
    if not (isinstance(buf, _TrackedBuffer) or
            (isinstance(buf, memoryview) and not buf.readonly)):
        # in band (bytes, a bytearray) or a read-only view: a tensor of
        # its own, since torch cannot mark one read-only
        buf = bytearray(buf)
    # through numpy: the array holds the buffer's exporter (and so a
    # store view's pin) for as long as the tensor's storage lives, which
    # torch.frombuffer does not
    t = torch.from_numpy(np.frombuffer(buf, dtype=np.uint8)).view(dt).reshape(shape)
    return t.requires_grad_() if requires_grad else t


class SerializedValue:
    """The two-phase serialization handle: pickled meta plus BORROWED
    zero-copy views of the out-of-band payload buffers (they alias the
    caller's live arrays — write/consume before mutating the source).

    ``write_into`` lays the wire format into a destination mapping in one
    pass (the plasma write-in-place path); ``segments`` exposes the frame
    as a list of buffer segments for vectored socket writes; ``to_bytes``
    is the counted legacy join."""

    __slots__ = ("meta", "_pickle_buffers", "buffers", "total")

    def __init__(self, meta: bytes, pickle_buffers: List[pickle.PickleBuffer]):
        self.meta = meta
        self._pickle_buffers = pickle_buffers
        self.buffers: List[memoryview] = []
        total = 8 + len(meta)
        for b in pickle_buffers:
            raw = b.raw()
            if raw.ndim != 1 or raw.format != "B":
                raw = raw.cast("B")
            self.buffers.append(raw)
            total += 8 + raw.nbytes
        self.total = total

    @property
    def payload_nbytes(self) -> int:
        return sum(b.nbytes for b in self.buffers)

    def segments(self) -> List["bytes | memoryview"]:
        """The wire frame as an ordered list of buffer segments (no
        payload concatenation)."""
        segs: List[Any] = [
            struct.pack("<I", len(self.meta)),
            self.meta,
            struct.pack("<I", len(self.buffers)),
        ]
        for b in self.buffers:
            segs.append(struct.pack("<Q", b.nbytes))
            segs.append(b)
        return segs

    def write_into(self, dest: memoryview) -> int:
        """Single-pass copy-free layout into ``dest`` (length >= .total):
        payload bytes move exactly once, source buffer → dest. Runs on the
        fastpath codec — the C backend releases the GIL around the payload
        memcpy, so a multi-MB put no longer stalls sibling threads.
        Returns the number of bytes written."""
        return fastpath.write_body_into(dest, self.meta, self.buffers)

    def to_bytes(self, copy_path: Optional[str] = "put") -> bytes:
        """Materialize the frame as one bytes object (the legacy join) —
        counted as an intermediate payload copy when out-of-band buffers
        exist."""
        payload = self.payload_nbytes
        if payload and copy_path:
            record_payload_copy(copy_path, payload, n=len(self.buffers))
        out = bytearray(self.total)
        self.write_into(memoryview(out))
        return bytes(out)

    def release(self) -> None:
        """Release the borrowed buffer views (call after the frame has
        been written; the handle must not be used afterwards)."""
        for mv in self.buffers:
            try:
                mv.release()
            except Exception:  # noqa: BLE001
                pass
        self.buffers = []
        for b in self._pickle_buffers:
            try:
                b.release()
            except Exception:  # noqa: BLE001
                pass
        self._pickle_buffers = []


def serialize_prepare(value: Any) -> SerializedValue:
    """Phase one of the zero-copy put path: pickle once, keep the payload
    as borrowed views instead of joining bytes."""
    _ensure_copy_metrics()
    buffers: List[pickle.PickleBuffer] = []
    bio = io.BytesIO()
    pickler = _CustomPickler(bio, protocol=5, buffer_callback=buffers.append)
    pickler.dump(value)
    return SerializedValue(bio.getvalue(), buffers)


def serialize(value: Any) -> bytes:
    """Serialize a Python value into the wire/object-store format as one
    bytes object (joins out-of-band payload — counted; prefer
    ``serialize_prepare`` + ``write_into`` on hot paths)."""
    sv = serialize_prepare(value)
    try:
        return sv.to_bytes()
    finally:
        sv.release()


def serialize_into(value: Any, alloc: Callable[[int], memoryview]) -> memoryview:
    """Serialize directly into store-provided memory: the allocation is
    sized AFTER pickling (phase one), then payload bytes move exactly once
    into the provided mapping."""
    sv = serialize_prepare(value)
    try:
        mv = alloc(sv.total)
        sv.write_into(mv)
        return mv
    finally:
        sv.release()


# Python-level buffer protocol (PEP 688 ``__buffer__``) only exists on
# 3.12+. Earlier interpreters can't hand consumers like np.frombuffer a
# trackable zero-copy wrapper, so they copy out-of-band buffers and
# release the store pin immediately (deserialize() below).
_HAS_PEP688 = sys.version_info >= (3, 12)


class _TrackedBuffer:
    """Buffer-protocol wrapper (PEP 688) around a shared-memory slice.

    Zero-copy deserialized arrays keep their exporter alive through the
    buffer protocol; when the LAST tracked buffer of a deserialize() call
    is garbage-collected, the shared release callback fires — that is how
    a store get-pin lives exactly as long as the values viewing it
    (reference: plasma client buffer lifetime, plasma/client.h:261)."""

    __slots__ = ("_mv", "_shared")

    def __init__(self, mv: memoryview, shared: list):
        self._mv = mv
        self._shared = shared
        with shared[2]:
            shared[0] += 1

    def __buffer__(self, flags):
        return memoryview(self._mv)

    def __del__(self):
        s = self._shared
        cb = None
        with s[2]:  # __del__ may run concurrently on different threads
            s[0] -= 1
            if s[0] == 0 and s[1] is not None:
                cb, s[1] = s[1], None
        if cb is not None:
            try:
                cb()
            except Exception:  # noqa: BLE001 — GC context
                pass


def deserialize(data: "bytes | memoryview", release_cb: Optional[Callable] = None) -> Any:
    """Deserialize the wire format. With ``release_cb``, out-of-band buffers
    are zero-copy views and the callback fires once every reconstructed
    value viewing them has been collected (pin-for-value-lifetime)."""
    shared = [0, release_cb, threading.Lock()]
    try:
        meta, raw_buffers = fastpath.decode_body(data)
        buffers = []
        for sl in raw_buffers:
            if release_cb is None:
                buffers.append(sl)  # zero-copy view
            elif _HAS_PEP688:
                buffers.append(_TrackedBuffer(sl, shared))
            else:
                # pre-3.12: no Python-visible buffer protocol, so a
                # tracked zero-copy wrapper is invisible to consumers
                # (np.frombuffer raises). Copy the slice; the pin then
                # releases in the finally below instead of at value GC.
                record_payload_copy("get", sl.nbytes)
                buffers.append(bytes(sl))
        return pickle.loads(
            bytes(meta) if isinstance(meta, memoryview) else meta, buffers=buffers
        )
    finally:
        # no tracked buffer exists (none created, or creation failed):
        # nothing views the region, release now. Otherwise the buffers'
        # GC fires the shared callback.
        if release_cb is not None:
            fire = None
            with shared[2]:
                if shared[0] == 0 and shared[1] is not None:
                    fire, shared[1] = shared[1], None
            if fire is not None:
                try:
                    fire()
                except Exception:  # noqa: BLE001
                    pass


def dumps_function(fn: Any) -> bytes:
    return cloudpickle.dumps(fn, protocol=5)


def loads_function(data: bytes) -> Any:
    return cloudpickle.loads(data)
