"""LLM batch inference over ray_tpu_torch.data (PyTorch port of
ray_tpu/llm/batch.py; reference: python/ray/llm/_internal/batch/processor/
— vLLM engine processors).

``build_llm_processor(config)`` returns ``Dataset -> Dataset``: the
engine stage is a callable class, so each pool actor (under a cluster:
a worker process that leases its card) lazily builds ONE engine, cached
per config and device, and maps prompt batches through it, block by
block; in local mode the calling process does.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional

import numpy as np

from ray_tpu_torch import default_device
from ray_tpu_torch.llm.config import LLMConfig
from ray_tpu_torch.models.decoding import SamplingParams

# one engine per (process, config identity, device) — rebuilding the
# engine per block would draw or load its weights every time
_ENGINE_CACHE: Dict[tuple, Any] = {}
# the kernels whose launch counters (ops/attention.py) the stats report
KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def _engine_for(config: LLMConfig, device=None):
    # class name alone can't distinguish two HF tokenizers, so include
    # their vocab/name attributes too
    device = default_device(device)
    tok = config.get_tokenizer()
    key = (str(config.model), config.max_len, config.params_path,
           config.seed, type(tok).__name__,
           getattr(tok, "vocab_size", None),
           str(getattr(tok, "name_or_path", None)), str(device))
    eng = _ENGINE_CACHE.get(key)
    if eng is None:
        from ray_tpu_torch.llm.engine import LLMEngine

        eng = LLMEngine(config, device=device)
        _ENGINE_CACHE[key] = eng
    return eng


def build_llm_processor(
    config: LLMConfig,
    *,
    sampling: Optional[SamplingParams] = None,
    prompt_column: str = "prompt",
    output_column: str = "generated",
    batch_size: Optional[int] = None,
    device=None,
    num_gpus: Optional[float] = None,
    concurrency: int = 1,
    _stats_column: Optional[str] = None,
) -> Callable:
    """Returns ``process(ds) -> ds`` adding ``output_column`` with the
    completion for each row's ``prompt_column``. The engine runs on
    ``device`` (None: the card). Under a cluster the stage is a pool of
    ``concurrency`` actors, each leasing ``num_gpus`` cards (default: one
    for ``device=None``, none for a named device; whole cards only, a
    fraction raises); a stage that wants a card and is given none raises,
    it never falls back to the CPU. ``_stats_column`` is for the card's
    smoke run and the tests: when named, it gets a dict a row with what
    the stage's process saw for that row's batch: pid,
    ``CUDA_VISIBLE_DEVICES``, the engine's device, the engines the process
    holds and each flash kernel's launches during the batch."""
    from ray_tpu_torch.data.dataset import _use_local_exec

    if device is not None:
        device = str(default_device(device))
    elif _use_local_exec():
        default_device(None)  # the stage runs here: no card raises now
    if num_gpus is None:
        num_gpus = 1 if device is None else 0
    if num_gpus:
        from ray_tpu_torch._private.core_worker import _check_card_quantity

        _check_card_quantity({"GPU": num_gpus})

    class LLMStage:
        def __init__(self):
            self.engine = _engine_for(config, device)
            self.batches = 0

        def __call__(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
            # this module's counters by import: the class travels by value
            # and would carry a copy of the module's globals
            from ray_tpu_torch.llm import batch as this
            from ray_tpu_torch.ops import attention as A

            before = {name: getattr(A, f"{name}_launches") for name in KERNELS}
            prompts = [str(p) for p in batch[prompt_column]]
            out = dict(batch, **{output_column: np.asarray(
                self.engine.generate(prompts, sampling), object)})
            if _stats_column is not None:
                facts = {"pid": os.getpid(), "batch": self.batches,
                         "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                         "device": str(self.engine.device),
                         "engines_built": len(this._ENGINE_CACHE),
                         "launches": {name: getattr(A, f"{name}_launches") - n
                                      for name, n in before.items()}}
                out[_stats_column] = np.asarray([dict(facts) for _ in prompts], object)
            self.batches += 1
            return out

    def process(ds):
        return ds.map_batches(LLMStage, batch_size=batch_size, concurrency=concurrency,
                              num_gpus=num_gpus)

    return process
