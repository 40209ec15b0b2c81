"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu, one slice at a time.

The JAX package ``ray_tpu`` is the reference; this package keeps its
module and function names, imports nothing of it, and runs on an NVIDIA
GPU. Every entry point takes an explicit ``device``; ``None`` means the
card, and raises when there is none. The CPU is used only when a caller
asks for it (``device="cpu"``), as the tests do.

Subpackages: ``ops`` (the flash kernels), ``models`` (the transformer,
decoding, continuous batching, the paged KV cache, weights from JAX),
``llm`` (the serving engines, from a checkpoint too), ``train`` (the
train step, checkpoints through torch.distributed.checkpoint, the
trainer with retry and resume), ``parallel`` (the device mesh, sharding
rules and collectives of the sharded step, the multi-host bootstrap),
``util.collective`` (the collective API), ``rllib`` (the PPO, IMPALA,
DQN, SAC and BC learners in process, and Anakin: rollout, V-trace and
Adam on the card, its envs split over a process group's ranks), ``data``
(Datasets run in process, ``iter_torch_batches`` feeding the train step,
and ``llm.build_llm_processor``'s batch inference over them) and
``tune`` (Tuner trials as local-mode actors, its searchers and
schedulers).

The runtime's public API is ``ray_tpu``'s (reference:
python/ray/__init__.py): ``init, shutdown, remote, get, put, wait, kill,
cancel, get_actor``, in local mode so far (``init(local_mode=True)``:
tasks on a thread pool, actors on their own executors, objects in the
in-process store, the cards advertised as the "GPU" resource). The
runtime picks no device: what a task or actor runs keeps ``device=None``
→ the card.
"""

from __future__ import annotations

import inspect

import torch

__version__ = "0.1.0"


def default_device(device=None) -> torch.device:
    """``device`` as a torch.device; ``None`` means "cuda", and raises
    RuntimeError when no CUDA device is present (never falls back to
    the CPU)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "ray_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run on the CPU")
    return torch.device("cuda")



# the runtime; after default_device, which its profiling module imports
from ray_tpu_torch._private.ids import (  # noqa: E402
    ActorID,
    JobID,
    NodeID,
    ObjectID,
    PlacementGroupID,
    TaskID,
    UniqueID,
    WorkerID,
)
from ray_tpu_torch._private.object_ref import ObjectRef  # noqa: E402
from ray_tpu_torch._private.streaming import ObjectRefGenerator  # noqa: E402
from ray_tpu_torch._private.worker import (  # noqa: E402
    available_resources,
    cancel,
    cluster_resources,
    get,
    get_actor,
    init,
    is_initialized,
    kill,
    nodes,
    put,
    shutdown,
    wait,
)
from ray_tpu_torch._private.profiling import (  # noqa: E402
    gpu_profile,
    start_gpu_profile,
    stop_gpu_profile,
    timeline,
)
from ray_tpu_torch.actor import ActorClass, ActorHandle, method  # noqa: E402
from ray_tpu_torch.remote_function import RemoteFunction  # noqa: E402
from ray_tpu_torch.runtime_context import get_runtime_context  # noqa: E402
from ray_tpu_torch import exceptions  # noqa: E402,F401

_ALLOWED_TASK_OPTIONS = {
    "num_returns",
    "num_cpus",
    "num_gpus",
    "num_tpus",
    "memory",
    "resources",
    "max_retries",
    "retry_exceptions",
    "scheduling_strategy",
    "runtime_env",
    "name",
    "max_calls",
}
_ALLOWED_ACTOR_OPTIONS = {
    "num_cpus",
    "num_gpus",
    "num_tpus",
    "memory",
    "resources",
    "max_restarts",
    "max_task_retries",
    "max_concurrency",
    "max_pending_calls",
    "name",
    "namespace",
    "lifetime",
    "get_if_exists",
    "scheduling_strategy",
    "runtime_env",
}


def remote(*args, **kwargs):
    """``@ray_tpu_torch.remote`` — turn a function into a RemoteFunction or a
    class into an ActorClass (copy of ray_tpu's; reference:
    python/ray/_private/worker.py:3391)."""

    def _make(target):
        if inspect.isclass(target):
            bad = set(kwargs) - _ALLOWED_ACTOR_OPTIONS
            if bad:
                raise ValueError(f"Invalid actor options: {sorted(bad)}")
            return ActorClass(target, kwargs)
        if callable(target):
            bad = set(kwargs) - _ALLOWED_TASK_OPTIONS
            if bad:
                raise ValueError(f"Invalid task options: {sorted(bad)}")
            return RemoteFunction(target, kwargs)
        raise TypeError("@ray_tpu_torch.remote requires a function or class")

    if len(args) == 1 and not kwargs and (callable(args[0]) or inspect.isclass(args[0])):
        return _make(args[0])
    if args:
        raise TypeError("@ray_tpu_torch.remote accepts only keyword options")
    return _make


__all__ = [
    "__version__",
    "default_device",
    "init",
    "timeline",
    "gpu_profile",
    "start_gpu_profile",
    "stop_gpu_profile",
    "shutdown",
    "is_initialized",
    "remote",
    "get",
    "put",
    "wait",
    "kill",
    "cancel",
    "get_actor",
    "nodes",
    "cluster_resources",
    "available_resources",
    "get_runtime_context",
    "method",
    "ObjectRef",
    "ObjectRefGenerator",
    "ActorClass",
    "ActorHandle",
    "RemoteFunction",
    "exceptions",
    "ActorID",
    "JobID",
    "NodeID",
    "ObjectID",
    "PlacementGroupID",
    "TaskID",
    "UniqueID",
    "WorkerID",
]
