"""Lazy task/actor DAG building + execution (copy of ray_tpu/dag.py).

Reference: python/ray/dag/ (DAGNode, FunctionNode, ClassNode, InputNode;
compiled DAGs in compiled_dag_node.py). ``f.bind(x).execute()`` submits the
underlying tasks with dependencies expressed as ObjectRefs;
``.experimental_compile()`` returns a CompiledDAG (ray_tpu_torch/dag_compiled.py)
whose schedule and actors are fixed once and reused across executions.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple


class DAGNode:
    """Base: a deferred computation with upstream deps."""

    def __init__(self, args: tuple, kwargs: dict):
        self._bound_args = args
        self._bound_kwargs = kwargs
        self._cache: Optional[Any] = None

    # -- traversal -----------------------------------------------------
    def _resolve_arg(self, v, input_value):
        if isinstance(v, DAGNode):
            return v._execute_impl(input_value)
        return v

    def _resolved(self, input_value) -> Tuple[tuple, dict]:
        args = tuple(self._resolve_arg(a, input_value) for a in self._bound_args)
        kwargs = {k: self._resolve_arg(v, input_value) for k, v in self._bound_kwargs.items()}
        return args, kwargs

    def _execute_impl(self, input_value):
        raise NotImplementedError

    def execute(self, *input_values):
        """Execute the DAG; returns ObjectRef(s) for the terminal node."""
        input_value = input_values[0] if input_values else None
        self._clear_cache()
        return self._execute_impl(input_value)

    def _clear_cache(self):
        self._cache = None
        for v in list(self._bound_args) + list(self._bound_kwargs.values()):
            if isinstance(v, DAGNode):
                v._clear_cache()

    def experimental_compile(self, **kwargs):
        from ray_tpu_torch.dag_compiled import CompiledDAG

        return CompiledDAG(self, **kwargs)


class InputNode(DAGNode):
    """Placeholder for the runtime input (reference: ray.dag.InputNode)."""

    def __init__(self):
        super().__init__((), {})

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def _execute_impl(self, input_value):
        return input_value


class FunctionNode(DAGNode):
    def __init__(self, remote_fn, args, kwargs, options: Dict[str, Any]):
        super().__init__(args, kwargs)
        self._remote_fn = remote_fn
        self._options = options

    def _execute_impl(self, input_value):
        if self._cache is None:
            args, kwargs = self._resolved(input_value)
            self._cache = self._remote_fn._remote(args, kwargs, self._options)
        return self._cache


class ClassNode(DAGNode):
    """A bound actor-class instantiation."""

    def __init__(self, actor_cls, args, kwargs, options: Dict[str, Any]):
        super().__init__(args, kwargs)
        self._actor_cls = actor_cls
        self._options = options
        self._handle = None

    def _execute_impl(self, input_value):
        if self._handle is None:
            args, kwargs = self._resolved(input_value)
            self._handle = self._actor_cls._remote(args, kwargs, self._options)
        return self._handle

    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)
        return _ClassMethodBinder(self, item)


class _ClassMethodBinder:
    def __init__(self, class_node: ClassNode, method_name: str):
        self._class_node = class_node
        self._method_name = method_name

    def bind(self, *args, **kwargs):
        return ClassMethodNode(self._class_node, self._method_name, args, kwargs)


class ClassMethodNode(DAGNode):
    def __init__(self, class_node: ClassNode, method_name: str, args, kwargs):
        super().__init__(args, kwargs)
        self._class_node = class_node
        self._method_name = method_name

    def _execute_impl(self, input_value):
        if self._cache is None:
            handle = self._class_node._execute_impl(input_value)
            args, kwargs = self._resolved(input_value)
            self._cache = handle._actor_method_call(self._method_name, args, kwargs)
        return self._cache


class ActorMethodNode(DAGNode):
    """bind() on a live ActorHandle's method."""

    def __init__(self, handle, method_name: str, args, kwargs):
        super().__init__(args, kwargs)
        self._handle = handle
        self._method_name = method_name

    def _execute_impl(self, input_value):
        if self._cache is None:
            args, kwargs = self._resolved(input_value)
            self._cache = self._handle._actor_method_call(self._method_name, args, kwargs)
        return self._cache


class MultiOutputNode(DAGNode):
    """Terminal wrapper returning every member's result
    (reference: ray.dag.MultiOutputNode)."""

    def __init__(self, nodes):
        super().__init__(tuple(nodes), {})

    def __iter__(self):
        return iter(self._bound_args)

    def __len__(self):
        return len(self._bound_args)

    def _execute_impl(self, input_value):
        return [n._execute_impl(input_value) for n in self._bound_args]

    def experimental_compile(self, **kwargs):
        from ray_tpu_torch.dag_compiled import CompiledDAG

        return CompiledDAG(list(self._bound_args), **kwargs)
