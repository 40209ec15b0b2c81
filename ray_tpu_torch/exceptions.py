"""Public exception types (copy of ray_tpu/exceptions.py; reference:
python/ray/exceptions.py). The class names and messages are JAX's."""

from __future__ import annotations


class RayTpuError(Exception):
    """Base class for all ray_tpu_torch runtime errors."""


class RayTaskError(RayTpuError):
    """A task raised an exception during execution.

    Wraps the original traceback so it surfaces at the ``get()`` callsite,
    like the reference's RayTaskError (python/ray/exceptions.py).
    """

    def __init__(self, function_name: str, traceback_str: str, cause: Exception | None = None):
        self.function_name = function_name
        self.traceback_str = traceback_str
        self.cause = cause
        super().__init__(f"Task '{function_name}' failed:\n{traceback_str}")

    def __reduce__(self):
        return (RayTaskError, (self.function_name, self.traceback_str, self.cause))

    def as_instanceof_cause(self) -> Exception:
        """Return an exception that is an instance of the cause's class."""
        if self.cause is None:
            return self
        cause_cls = type(self.cause)
        if cause_cls is RayTaskError:
            return self
        try:
            class _cls(RayTaskError, cause_cls):  # type: ignore[misc, valid-type]
                def __init__(self, inner: "RayTaskError"):
                    # cause attributes first so callers can read the
                    # typed payload (e.g. CollectiveRankFailure
                    # .dead_ranks) off the wrapper; the wrapper's own
                    # fields win on collision
                    self.__dict__.update(inner.cause.__dict__)
                    self.__dict__.update(inner.__dict__)
                    Exception.__init__(self, str(inner))

            _cls.__name__ = f"RayTaskError({cause_cls.__name__})"
            _cls.__qualname__ = _cls.__name__
            return _cls(self)
        except TypeError:
            return self


class RayActorError(RayTpuError):
    """The actor died before or during method execution."""

    def __init__(self, message: str = "The actor died unexpectedly before finishing this task."):
        super().__init__(message)


class ActorDiedError(RayActorError):
    pass


class ActorUnavailableError(RayActorError):
    """The actor is temporarily unreachable (e.g. restarting)."""


class TaskCancelledError(RayTpuError):
    pass


class ObjectLostError(RayTpuError):
    """An object was lost (all copies evicted / node died) and could not be
    reconstructed from lineage."""


class ObjectReconstructionFailedError(ObjectLostError):
    pass


class OwnerDiedError(ObjectLostError):
    pass


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


class WorkerCrashedError(RayTpuError):
    pass


class NodeDiedError(RayTpuError):
    pass


class RuntimeEnvSetupError(RayTpuError):
    pass


class OutOfMemoryError(RayTpuError):
    pass


class ObjectStoreFullError(RayTpuError):
    pass


class PlacementGroupSchedulingError(RayTpuError):
    pass
