"""serve local testing mode (copy of ray_tpu/serve/local_mode.py;
reference: serve/_private/local_testing_mode.py): run a deployment IN-PROCESS —
no cluster, no controller, no replica actors — for fast unit tests of
deployment logic.

``serve.run(app, local_testing_mode=True)`` returns a
``LocalDeploymentHandle``: calls execute synchronously on a thread
pool, ``.remote()`` returns a future-like with ``.result()``, and
generator methods return a plain iterator of values."""

from __future__ import annotations

import inspect
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any


class _LocalResponse:
    def __init__(self, fut: Future):
        self._fut = fut

    def result(self, timeout=None):
        return self._fut.result(timeout)


class _LocalMethod:
    def __init__(self, handle: "LocalDeploymentHandle", method: str,
                 model_id: str = ""):
        self._handle = handle
        self._method = method
        self._model_id = model_id

    def remote(self, *args, **kwargs):
        return self._handle._call(self._method, args, kwargs,
                                  self._model_id)


class LocalDeploymentHandle:
    """In-process stand-in for DeploymentHandle."""

    def __init__(self, target, init_args, init_kwargs):
        if isinstance(target, type):
            self._callable = target(*init_args, **init_kwargs)
        else:
            self._callable = target
        self._pool = ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="serve-local")
        self._loop = None
        self._loop_lock = threading.Lock()

    def __getattr__(self, method: str) -> _LocalMethod:
        if method.startswith("_"):
            raise AttributeError(method)
        return _LocalMethod(self, method)

    def options(self, *, multiplexed_model_id: str = "", **_ignored):
        outer = self

        class _Opts:
            def __getattr__(self, method):
                if method.startswith("_"):
                    raise AttributeError(method)
                return _LocalMethod(outer, method, multiplexed_model_id)

            def remote(self, *args, **kwargs):
                return _LocalMethod(outer, "__call__",
                                    multiplexed_model_id).remote(
                    *args, **kwargs)

        return _Opts()

    def remote(self, *args, **kwargs):
        return self._call("__call__", args, kwargs, "")

    def _run_awaitable(self, coro):
        import asyncio

        with self._loop_lock:
            if self._loop is None:
                self._loop = asyncio.new_event_loop()
                threading.Thread(target=self._loop.run_forever,
                                 daemon=True,
                                 name="serve-local-loop").start()
        from ray_tpu_torch.serve import slo

        return slo.result_within_deadline(
            asyncio.run_coroutine_threadsafe(coro, self._loop))

    def _invoke(self, method: str, args, kwargs, model_id: str) -> Any:
        from ray_tpu_torch.serve.multiplex import _current_model_id

        token = _current_model_id.set(model_id)
        try:
            fn = self._callable if method == "__call__" \
                else getattr(self._callable, method)
            out = fn(*args, **kwargs)
            if inspect.iscoroutine(out):
                out = self._run_awaitable(out)
            return out
        finally:
            _current_model_id.reset(token)

    def _invoke_gen(self, method: str, args, kwargs, model_id: str):
        """Generator path: the contextvar must be LIVE while the body
        executes (which happens at iteration, not at call), matching the
        cluster replica's behavior."""
        from ray_tpu_torch.serve.multiplex import _current_model_id

        token = _current_model_id.set(model_id)
        try:
            fn = self._callable if method == "__call__" \
                else getattr(self._callable, method)
            yield from fn(*args, **kwargs)
        finally:
            _current_model_id.reset(token)

    def _call(self, method: str, args, kwargs, model_id: str):
        target_fn = getattr(self._callable, method, None) \
            if method != "__call__" else self._callable
        if target_fn is not None and inspect.isgeneratorfunction(
                inspect.unwrap(target_fn)):
            return self._invoke_gen(method, args, kwargs, model_id)
        return _LocalResponse(self._pool.submit(
            self._invoke, method, args, kwargs, model_id))


def run_local(app) -> LocalDeploymentHandle:
    dep = app.deployment
    return LocalDeploymentHandle(dep._target, app.init_args,
                                 app.init_kwargs)
