"""``id_from_index``, the one function of ray_tpu/_private/fastpath that the
IDs call (a copy of ``_pyimpl.id_from_index``): ObjectID::FromIndex
derivation, the task id's bytes followed by the little-endian u32 index.

The frame codec beside it in the JAX package serves the RPC layer of the
cluster runtime and comes with it (ROADMAP.md Queue A item 10b)."""

from __future__ import annotations

import struct

_U32 = struct.Struct("<I")


def id_from_index(prefix, index: int) -> bytes:
    return bytes(prefix) + _U32.pack(index)
