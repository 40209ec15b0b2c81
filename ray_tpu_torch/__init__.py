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
rules and collectives of the sharded step, the multi-host bootstrap) and
``util.collective`` (the collective API).
"""

from __future__ import annotations

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


__all__ = ["__version__", "default_device"]
