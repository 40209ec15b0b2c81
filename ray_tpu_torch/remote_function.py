"""RemoteFunction — the object behind ``@ray_tpu_torch.remote`` on functions
(copy of ray_tpu/remote_function.py).

Reference: python/ray/remote_function.py (RemoteFunction, _remote :342).
"""

from __future__ import annotations

import hashlib
import inspect
from typing import Any, Dict, Optional

from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private.core import TaskOptions, normalize_resources
from ray_tpu_torch._private.task_spec import FunctionDescriptor, SchedulingStrategy


def _strategy_from_option(opt) -> SchedulingStrategy:
    if opt is None:
        return SchedulingStrategy()
    if isinstance(opt, SchedulingStrategy):
        return opt
    if isinstance(opt, str):
        return SchedulingStrategy(kind=opt.upper())
    # duck-typed public strategy classes from util.scheduling_strategies
    return opt.to_internal()


class RemoteFunction:
    def __init__(self, function, task_options: Dict[str, Any]):
        self._function = function
        self._name = function.__qualname__
        self._module = getattr(function, "__module__", "__main__") or "__main__"
        try:
            src = inspect.getsource(function)
        except (OSError, TypeError):
            src = self._name
        self._function_hash = hashlib.sha1(src.encode()).hexdigest()[:16]
        # cloudpickled once here, like the reference's export-once function
        # table (python/ray/_private/function_manager.py): re-pickling per
        # submit was the dominant driver-side cost for small tasks
        self._pickled_function: Optional[bytes] = None
        self._default_options = dict(task_options)
        self._descriptor = FunctionDescriptor(
            module_name=self._module,
            function_name=self._name,
            function_hash=self._function_hash,
        )
        self.__doc__ = function.__doc__

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function '{self._name}' cannot be called directly. "
            f"Use '{self._name}.remote()' instead."
        )

    def options(self, **task_options) -> "_RemoteFunctionProxy":
        merged = dict(self._default_options)
        merged.update(task_options)
        return _RemoteFunctionProxy(self, merged)

    def remote(self, *args, **kwargs):
        return self._remote(args, kwargs, self._default_options)

    def _build_opts(self, o: Dict[str, Any]) -> TaskOptions:
        from ray_tpu_torch._private.config import config

        resources = normalize_resources(
            o.get("num_cpus"),
            o.get("num_gpus"),
            o.get("num_tpus"),
            o.get("resources"),
            o.get("memory"),
            default_cpus=1.0,
        )
        max_retries = o.get("max_retries")
        if max_retries is None:
            max_retries = config.task_max_retries_default
        num_returns = o.get("num_returns")
        if num_returns is None:
            # generator functions stream their yields by default
            # (reference: generators return ObjectRefGenerator)
            num_returns = (
                "streaming" if inspect.isgeneratorfunction(self._function) else 1
            )
        return TaskOptions(
            num_returns=num_returns,
            resources=resources,
            max_retries=max_retries,
            retry_exceptions=bool(o.get("retry_exceptions", False)),
            scheduling_strategy=_strategy_from_option(o.get("scheduling_strategy")),
            runtime_env=o.get("runtime_env") or {},
            name=o.get("name", ""),
        )

    def _remote(self, args, kwargs, task_options: Dict[str, Any]):
        w = worker_mod._require_connected()
        opts = self._build_opts(task_options)
        out = w.core.submit_task(self, args, kwargs, opts)
        if opts.num_returns == "streaming":
            return out  # ObjectRefGenerator
        if opts.num_returns == 1:
            return out[0]
        return out

    def bind(self, *args, **kwargs):
        """DAG-building entry (reference: python/ray/dag) — deferred node."""
        from ray_tpu_torch.dag import FunctionNode

        return FunctionNode(self, args, kwargs, self._default_options)


class _RemoteFunctionProxy:
    def __init__(self, rf: RemoteFunction, options: Dict[str, Any]):
        self._rf = rf
        self._options = options

    def remote(self, *args, **kwargs):
        return self._rf._remote(args, kwargs, self._options)

    def bind(self, *args, **kwargs):
        from ray_tpu_torch.dag import FunctionNode

        return FunctionNode(self._rf, args, kwargs, self._options)
