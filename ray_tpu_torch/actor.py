"""ActorClass / ActorHandle / ActorMethod — ``@ray_tpu_torch.remote`` on
classes (copy of ray_tpu/actor.py).

Reference: python/ray/actor.py (ActorClass :1543, _remote :1873,
ActorMethod :848, ActorHandle :2252, _actor_method_call :2456).
"""

from __future__ import annotations

import functools
import inspect
from typing import Any, Dict, Optional

from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private.core import ActorOptions, TaskOptions, normalize_resources
from ray_tpu_torch._private.ids import ActorID
from ray_tpu_torch.remote_function import _strategy_from_option


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str, num_returns: int = 1):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor method '{self._method_name}' cannot be called directly; "
            f"use '.{self._method_name}.remote()'."
        )

    def options(self, **opts) -> "ActorMethod":
        m = ActorMethod(self._handle, self._method_name, opts.get("num_returns", self._num_returns))
        m._extra_opts = opts
        return m

    def remote(self, *args, **kwargs):
        opts = getattr(self, "_extra_opts", {})
        return self._handle._actor_method_call(
            self._method_name,
            args,
            kwargs,
            num_returns=opts.get("num_returns", self._num_returns),
        )

    def bind(self, *args, **kwargs):
        from ray_tpu_torch.dag import ActorMethodNode

        return ActorMethodNode(self._handle, self._method_name, args, kwargs)


class ActorHandle:
    def __init__(
        self,
        actor_id: ActorID,
        method_names=None,
        actor_class_name: str = "",
        method_opts: Optional[Dict[str, Dict[str, Any]]] = None,
    ):
        self._actor_id = actor_id
        self._method_names = list(method_names or [])
        self._actor_class_name = actor_class_name
        self._method_opts = dict(method_opts or {})

    @classmethod
    def _from_actor_id(cls, actor_id: ActorID) -> "ActorHandle":
        return cls(actor_id)

    def __getattr__(self, item: str) -> ActorMethod:
        if item == "__ray_call__":
            # run an arbitrary function against the actor instance
            # (reference: the injected __ray_call__ actor method):
            # handle.__ray_call__.remote(fn, *args) executes
            # fn(instance, *args) on the actor
            return ActorMethod(self, "__ray_call__", num_returns=1)
        if item.startswith("_"):
            raise AttributeError(item)
        opts = self._method_opts.get(item, {})
        return ActorMethod(self, item, num_returns=opts.get("num_returns", 1))

    def _actor_method_call(self, method_name: str, args, kwargs, num_returns=1):
        w = worker_mod._require_connected()
        opts = TaskOptions(num_returns=num_returns)
        out = w.core.submit_actor_task(self, method_name, args, kwargs, opts)
        if num_returns == "streaming":
            return out  # ObjectRefGenerator
        if num_returns == 1:
            return out[0]
        return out

    def __reduce__(self):
        return (
            ActorHandle,
            (self._actor_id, self._method_names, self._actor_class_name, self._method_opts),
        )

    def __repr__(self) -> str:
        return f"ActorHandle({self._actor_class_name}, {self._actor_id.hex()[:16]})"


class ActorClass:
    def __init__(self, cls: type, actor_options: Dict[str, Any]):
        self._cls = cls
        self._name = cls.__name__
        self._module = cls.__module__ or "__main__"
        self._default_options = dict(actor_options)
        self.__doc__ = cls.__doc__

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class '{self._name}' cannot be instantiated directly; "
            f"use '{self._name}.remote()'."
        )

    def options(self, **actor_options) -> "_ActorClassProxy":
        merged = dict(self._default_options)
        merged.update(actor_options)
        return _ActorClassProxy(self, merged)

    def remote(self, *args, **kwargs) -> ActorHandle:
        return self._remote(args, kwargs, self._default_options)

    def _build_opts(self, o: Dict[str, Any]) -> ActorOptions:
        resources = normalize_resources(
            o.get("num_cpus"),
            o.get("num_gpus"),
            o.get("num_tpus"),
            o.get("resources"),
            o.get("memory"),
            default_cpus=o.get("num_cpus", 1.0) if o.get("num_cpus") is not None else 1.0,
        )
        return ActorOptions(
            resources=resources,
            max_restarts=int(o.get("max_restarts", 0)),
            max_task_retries=int(o.get("max_task_retries", 0)),
            max_concurrency=int(o.get("max_concurrency", 1)),
            max_pending_calls=int(o.get("max_pending_calls", -1)),
            name=o.get("name"),
            namespace=o.get("namespace"),
            lifetime=o.get("lifetime"),
            get_if_exists=bool(o.get("get_if_exists", False)),
            scheduling_strategy=_strategy_from_option(o.get("scheduling_strategy")),
            runtime_env=o.get("runtime_env") or {},
            cpu_scheduling_only=o.get("num_cpus") is None,
        )

    def _remote(self, args, kwargs, actor_options: Dict[str, Any]) -> ActorHandle:
        w = worker_mod._require_connected()
        opts = self._build_opts(actor_options)
        actor_id = w.core.create_actor(self, args, kwargs, opts)
        methods = []
        method_opts: Dict[str, Dict[str, Any]] = {}
        for m in dir(self._cls):
            if m.startswith("_"):
                continue
            fn = getattr(self._cls, m, None)
            if callable(fn):
                methods.append(m)
                mo = dict(getattr(fn, "__ray_tpu_method_opts__", None) or {})
                if inspect.isgeneratorfunction(fn):
                    # generator methods stream their yields
                    mo.setdefault("num_returns", "streaming")
                if mo:
                    method_opts[m] = mo
        return ActorHandle(actor_id, methods, self._name, method_opts)

    def bind(self, *args, **kwargs):
        from ray_tpu_torch.dag import ClassNode

        return ClassNode(self, args, kwargs, self._default_options)


class _ActorClassProxy:
    def __init__(self, ac: ActorClass, options: Dict[str, Any]):
        self._ac = ac
        self._options = options

    def remote(self, *args, **kwargs) -> ActorHandle:
        return self._ac._remote(args, kwargs, self._options)

    def bind(self, *args, **kwargs):
        from ray_tpu_torch.dag import ClassNode

        return ClassNode(self._ac, args, kwargs, self._options)


def method(**opts):
    """``@ray_tpu_torch.method(num_returns=n)`` decorator on actor methods
    (reference: python/ray/actor.py method decorator)."""

    def decorator(f):
        f.__ray_tpu_method_opts__ = opts
        return f

    return decorator
