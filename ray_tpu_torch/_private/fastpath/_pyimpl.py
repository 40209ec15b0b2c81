"""Pure-Python fallback for the native control-plane codec (copy of
ray_tpu/_private/fastpath/_pyimpl.py).

Byte-identical to the port's C backend (csrc/fastpath.c), to the JAX
package's and to its ``_pyimpl``: tests/test_torch_fastpath.py holds
them against each other. Change the wire layout in every place or not
at all.

Layouts:
    frame header:  [u32 total][u64 call_id][u8 kind]   (little-endian)
    OOB body:      [u32 meta_len][meta][u32 nbuf]([u64 blen][payload])*
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple

BACKEND = "python"
# mirror of FASTPATH_NOGIL_THRESHOLD — meaningless here (the fallback
# cannot drop the GIL) but kept so both backends expose the same surface
NOGIL_THRESHOLD = 64 * 1024

_HDR = struct.Struct("<IQB")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")


def pack_header(total: int, call_id: int, kind: int) -> bytes:
    if not 0 <= kind <= 255:
        raise ValueError("kind must be 0..255")
    return _HDR.pack(total, call_id, kind)


def unpack_header(buf) -> Tuple[int, int, int]:
    if len(buf) < 13:
        raise ValueError("frame header needs 13 bytes")
    total, call_id, kind = _HDR.unpack_from(buf, 0)
    return total, call_id, kind


def encode_body(meta, bufs) -> bytes:
    out = bytearray(8 + len(meta) + sum(8 + b.nbytes if hasattr(b, "nbytes")
                                        else 8 + len(b) for b in bufs))
    write_body_into(out, meta, bufs)
    return bytes(out)


def write_body_into(dest, meta, bufs) -> int:
    mv = memoryview(dest)
    off = 0
    _U32.pack_into(mv, off, len(meta))
    off += 4
    mv[off: off + len(meta)] = meta
    off += len(meta)
    _U32.pack_into(mv, off, len(bufs))
    off += 4
    for b in bufs:
        blen = b.nbytes if hasattr(b, "nbytes") else len(b)
        _U64.pack_into(mv, off, blen)
        off += 8
        mv[off: off + blen] = b
        off += blen
    return off


def decode_body(body) -> Tuple[Any, List[Any]]:
    mv = memoryview(body)
    if len(mv) < 8:
        raise ValueError("truncated out-of-band body")
    (meta_len,) = _U32.unpack_from(mv, 0)
    off = 4
    if off + meta_len + 4 > len(mv):
        raise ValueError("truncated out-of-band body")
    meta = mv[off: off + meta_len]
    off += meta_len
    (nbuf,) = _U32.unpack_from(mv, off)
    off += 4
    buffers = []
    for _ in range(nbuf):
        if off + 8 > len(mv):
            raise ValueError("truncated out-of-band body")
        (blen,) = _U64.unpack_from(mv, off)
        off += 8
        if off + blen > len(mv):
            raise ValueError("truncated out-of-band body")
        buffers.append(mv[off: off + blen])
        off += blen
    return meta, buffers


def build_frame(call_id: int, kind: int, body) -> bytes:
    if not 0 <= kind <= 255:
        raise ValueError("kind must be 0..255")
    blen = body.nbytes if hasattr(body, "nbytes") else len(body)
    return _HDR.pack(blen, call_id, kind) + bytes(body)


def id_from_index(prefix, index: int) -> bytes:
    return bytes(prefix) + _U32.pack(index)
