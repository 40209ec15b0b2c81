"""Control-plane codec (copy of ray_tpu/_private/fastpath, the Python
backend only).

The JAX package selects between a native C extension
(src/fastpath/fastpath.c) and the byte-identical pure-Python fallback
``_pyimpl``. The port has the Python backend alone, so it selects
nothing: ``RAY_TPU_FASTPATH`` may be unset, "auto", "1", "0" or
"python"; "require" (or "c") asks for the C extension and raises, since
the port has none (ROADMAP.md Queue A item 10b-ii). Consumers import
the module-level functions:

    pack_header / unpack_header     RPC frame header ([u32][u64][u8])
    encode_body / decode_body       out-of-band body framing
    write_body_into                 single-pass frame layout into a mapping
    build_frame                     header + small body in one allocation
    id_from_index                   ObjectID::FromIndex derivation
"""

from __future__ import annotations

import os

from ray_tpu_torch._private.fastpath import _pyimpl

_MODES = ("", "auto", "1", "0", "false", "off", "python")


def _select():
    mode = os.environ.get("RAY_TPU_FASTPATH", "auto").strip().lower()
    if mode not in _MODES:
        raise ImportError(
            f"RAY_TPU_FASTPATH={mode!r} asks for a backend ray_tpu_torch does "
            f"not have: the fastpath C codec waits for ROADMAP.md Queue A item "
            f"10b-ii, 'multi-node joins, fault paths and the fastpath C codec'; "
            f"only the Python backend exists")
    return _pyimpl


_impl = _select()

BACKEND: str = _impl.BACKEND
NOGIL_THRESHOLD: int = _impl.NOGIL_THRESHOLD
pack_header = _impl.pack_header
unpack_header = _impl.unpack_header
encode_body = _impl.encode_body
decode_body = _impl.decode_body
write_body_into = _impl.write_body_into
build_frame = _impl.build_frame
id_from_index = _impl.id_from_index


def backend() -> str:
    """Always "python": the port has no native extension."""
    return BACKEND


def available_backends() -> dict:
    """name -> impl module: the Python backend only."""
    return {"python": _pyimpl}
