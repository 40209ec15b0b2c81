"""Bridging ObjectRefs into asyncio (reference: python/ray/_private/async_compat.py)."""

from __future__ import annotations

import asyncio
import inspect

ASYNC_ACTOR_DEFAULT_CONCURRENCY = 100


def has_async_methods(obj) -> bool:
    """True if a class/instance defines any ``async def`` method — the
    actor then runs an event loop and EVERY method executes on it (sync
    ones included, serialized), matching the reference's async actors.
    Shared by the cluster worker and local mode so they can't drift."""
    for m in dir(obj):
        if m.startswith("__"):
            continue
        fn = getattr(obj, m, None)
        if inspect.iscoroutinefunction(fn):
            return True
        if inspect.isasyncgenfunction(fn):
            raise TypeError(
                f"async generator method {m!r} is not supported yet; use a "
                "sync generator (streams) or an async method returning a list"
            )
    return False


def as_asyncio_future(ref) -> "asyncio.Future":
    loop = asyncio.get_event_loop()
    aio_fut: asyncio.Future = loop.create_future()

    from ray_tpu_torch._private import worker as _worker_mod

    cf = _worker_mod.global_worker.core.as_future(ref)

    def _done(f):
        if aio_fut.cancelled():
            return
        exc = f.exception()
        if exc is not None:
            loop.call_soon_threadsafe(aio_fut.set_exception, exc)
        else:
            loop.call_soon_threadsafe(aio_fut.set_result, f.result())

    cf.add_done_callback(_done)
    return aio_fut
