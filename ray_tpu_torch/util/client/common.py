"""Shared client/server marshalling (copy of
ray_tpu/util/client/common.py): ObjectRefs cross the wire as
markers that the server resolves against the ACTIVE client's ref table
at unpickle time (so refs nested anywhere inside args work).

The table is bound per-request via a contextvar — there is no global
registry, so one client can never name (or guess) another client's
refs and have the server resolve them.
"""

from __future__ import annotations

import contextlib
import contextvars
import io
import pickle
import sys
from typing import Any, Dict

# server-side: the active client's {ref_hex: ObjectRef} table, bound for
# the duration of each argument unpickle
_active_table: contextvars.ContextVar[Dict[str, Any]] = \
    contextvars.ContextVar("ray_tpu_torch_client_ref_table")


@contextlib.contextmanager
def resolver_scope(table: Dict[str, Any]):
    token = _active_table.set(table)
    try:
        yield
    finally:
        _active_table.reset(token)


def _resolve_marker(ref_hex: str):
    try:
        table = _active_table.get()
    except LookupError:
        raise RuntimeError("client ref marker unpickled outside a "
                           "resolver_scope") from None
    ref = table.get(ref_hex)
    if ref is None:
        raise KeyError(f"client ref {ref_hex} is not registered for this "
                       f"client (already released?)")
    return ref


class _ClientPickler(pickle.Pickler):
    def reducer_override(self, obj):
        from ray_tpu_torch._private.object_ref import ObjectRef

        if isinstance(obj, ObjectRef):
            return (_resolve_marker, (obj.hex(),))
        torch = sys.modules.get("torch")  # no tensor exists before its import
        if torch is not None and type(obj) in (torch.Tensor, torch.nn.Parameter) \
                and obj.layout == torch.strided and obj.device.type in ("cpu", "cuda"):
            # the cluster's own tensor reduction: a CUDA tensor goes as a
            # host tensor, so the server never touches a card
            from ray_tpu_torch._private.serialization import _reduce_tensor

            return _reduce_tensor(obj)
        return NotImplemented


def dumps_with_refs(value: Any) -> bytes:
    buf = io.BytesIO()
    _ClientPickler(buf, protocol=5).dump(value)
    return buf.getvalue()
