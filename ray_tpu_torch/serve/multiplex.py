"""Model multiplexing (copy of ray_tpu/serve/multiplex.py; reference:
python/ray/serve/multiplex.py:22 @serve.multiplexed +
serve.get_multiplexed_model_id).

One deployment serves MANY models: each replica lazily loads models
through the decorated loader and keeps an LRU of at most
``max_num_models_per_replica``; requests carry a model id
(``handle.options(multiplexed_model_id=...)``, or gRPC metadata), and
the router prefers a replica that already has the model loaded
(cache-aware routing — the handle learns model->replica affinity from
its own routing decisions and sticks to it while the replica set is
stable)."""

from __future__ import annotations

import asyncio
import contextvars
import functools
import inspect
import threading
from collections import OrderedDict
from typing import Any, Callable, Optional

_current_model_id: contextvars.ContextVar[str] = contextvars.ContextVar(
    "ray_tpu_serve_multiplexed_model_id", default="")


def get_multiplexed_model_id() -> str:
    """Inside a replica handler: the request's multiplexed model id
    (reference: serve.get_multiplexed_model_id)."""
    return _current_model_id.get()


class _MuxState:
    """Per-replica-instance LRU of loaded models."""

    def __init__(self, max_models: int):
        self.max_models = max_models
        self.cache: "OrderedDict[str, Any]" = OrderedDict()
        self.lock = threading.Lock()
        self.loads = 0  # observable: how many cold loads happened

    def get(self, model_id: str):
        with self.lock:
            if model_id in self.cache:
                self.cache.move_to_end(model_id)
                return True, self.cache[model_id]
            return False, None

    def put(self, model_id: str, model: Any):
        evicted = []
        with self.lock:
            self.cache[model_id] = model
            self.cache.move_to_end(model_id)
            self.loads += 1
            while len(self.cache) > self.max_models:
                evicted.append(self.cache.popitem(last=False))
        for _mid, m in evicted:
            # reference: calls the model's __del__/cleanup if provided
            cb = getattr(m, "__serve_multiplex_unload__", None)
            if callable(cb):
                try:
                    cb()
                except Exception:  # noqa: BLE001
                    pass

    def ids(self):
        with self.lock:
            return list(self.cache)


def _state_of(instance, attr: str, max_models: int) -> _MuxState:
    st = instance.__dict__.get(attr)
    if st is None:
        st = _MuxState(max_models)
        instance.__dict__[attr] = st
    return st


def multiplexed(func: Optional[Callable] = None, *,
                max_num_models_per_replica: int = 3):
    """Decorator for a replica's model-loader method:

        @serve.multiplexed(max_num_models_per_replica=4)
        def get_model(self, model_id): return load(model_id)

    The wrapped method returns the cached model, loading (and LRU-
    evicting) as needed. Works on sync and async loaders."""

    def deco(fn):
        attr = f"__mux_state_{fn.__name__}__"
        is_async = inspect.iscoroutinefunction(fn)

        if is_async:
            @functools.wraps(fn)
            async def awrapper(self, model_id: Optional[str] = None):
                model_id = model_id or get_multiplexed_model_id()
                st = _state_of(self, attr, max_num_models_per_replica)
                hit, model = st.get(model_id)
                if hit:
                    return model
                model = await fn(self, model_id)
                st.put(model_id, model)
                return model

            awrapper.__serve_multiplexed__ = True
            return awrapper

        @functools.wraps(fn)
        def wrapper(self, model_id: Optional[str] = None):
            model_id = model_id or get_multiplexed_model_id()
            st = _state_of(self, attr, max_num_models_per_replica)
            hit, model = st.get(model_id)
            if hit:
                return model
            model = fn(self, model_id)
            if inspect.iscoroutine(model):
                model = asyncio.get_event_loop().run_until_complete(model)
            st.put(model_id, model)
            return model

        wrapper.__serve_multiplexed__ = True
        return wrapper

    return deco(func) if func is not None else deco


def replica_multiplexed_model_ids(callable_obj) -> list:
    """All model ids currently cached by any multiplexed loader of this
    replica instance (observability / routing feedback)."""
    out = []
    for attr, val in list(getattr(callable_obj, "__dict__", {}).items()):
        if attr.startswith("__mux_state_") and isinstance(val, _MuxState):
            out.extend(val.ids())
    return out
