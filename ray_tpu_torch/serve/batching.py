"""@serve.batch — dynamic request batching (copy of
ray_tpu/serve/batching.py; reference: serve/batching.py).

Inference throughput comes from batching requests into one device
launch (tensor-core utilization scales with batch). The
decorator queues concurrent callers and invokes the wrapped function
once per batch window with a list of inputs; each caller gets its row.
"""

from __future__ import annotations

import functools
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Optional


class _Batcher:
    def __init__(self, fn: Callable, max_batch_size: int, batch_wait_timeout_s: float):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.timeout = batch_wait_timeout_s
        self.queue: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, item: Any) -> Future:
        fut: Future = Future()
        self.queue.put((item, fut))
        return fut

    def _loop(self) -> None:
        while True:
            item, fut = self.queue.get()
            batch = [(item, fut)]
            deadline = time.monotonic() + self.timeout
            while len(batch) < self.max_batch_size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self.queue.get(timeout=remaining))
                except queue.Empty:
                    break
            inputs = [b[0] for b in batch]
            try:
                outputs = self.fn(inputs)
                if len(outputs) != len(inputs):
                    raise ValueError(
                        f"@serve.batch function returned {len(outputs)} results "
                        f"for {len(inputs)} inputs"
                    )
                for (_, f), out in zip(batch, outputs):
                    f.set_result(out)
            except BaseException as e:  # noqa: BLE001
                for _, f in batch:
                    if not f.done():
                        f.set_exception(e)


# Per-process batcher registry. Module-level state pickles BY REFERENCE
# (this module is importable), so decorated deployment classes stay
# cloudpickle-able — a closure-held lock would not be.
_registry_lock = threading.Lock()
_free_batchers: dict = {}


def batch(_fn: Optional[Callable] = None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """Decorator: the wrapped fn must accept a LIST of inputs and return a
    list of outputs; concurrent callers are transparently batched."""

    def deco(fn: Callable):
        @functools.wraps(fn)
        def wrapper(self_or_item, *rest):
            # registry accessed via module import: the wrapper is often
            # cloudpickled BY VALUE (deployment classes defined in user
            # scripts), and module references survive that where a
            # captured lock would not
            from ray_tpu_torch.serve import batching as _registry

            # support both methods (self, item) and free functions (item)
            if rest:
                inst, item = self_or_item, rest[0]
                store = inst.__dict__.setdefault("__serve_batchers__", {})
                key = fn.__name__
                call = lambda items: fn(inst, items)
            else:
                inst, item = None, self_or_item
                store = _registry._free_batchers
                key = (fn.__module__, fn.__qualname__)
                call = fn
            with _registry._registry_lock:
                b = store.get(key)
                if b is None:
                    b = store[key] = _Batcher(call, max_batch_size, batch_wait_timeout_s)
            from ray_tpu_torch.serve import slo

            # inside a replica the active request's deadline bounds the
            # batch wait (expiry surfaces as DeadlineExceededError → 504
            # at the front door); outside one (plain function batching)
            # the serve-wide cap applies — never unbounded
            return slo.result_within_deadline(b.submit(item))

        wrapper._is_serve_batch = True
        return wrapper

    return deco(_fn) if _fn is not None else deco
