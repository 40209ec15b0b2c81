"""LLM serving on ray_tpu_torch.serve (PyTorch port of
ray_tpu/llm/serving.py; reference: python/ray/llm/_internal/serve/ — LLM
deployments over vLLM with batched + streamed responses).

``build_llm_deployment(config)`` returns a Serve Application whose
replica holds one engine on its device:

- ``__call__(prompt)`` — completion text; with ``continuous_batching``
  the request joins the engine's running decode batch, else concurrent
  requests are merged into one device batch by @serve.batch,
- ``generate_stream(prompt)`` — generator of text deltas, served over
  the handle's streaming path / HTTP chunked responses,
- ``engine_stats()`` — the continuous batcher's counters,
- ``replica_stats()`` — where the replica runs and what it launched: its
  process, the cards its lease pinned, the engine's device, the flash
  kernels' launch counts in its process and the sizes of its
  @serve.batch batches.

``device=None`` means the card of the replica's process: the one its
lease pinned when ``config.resources`` asks for ``{"GPU": 1}``. A replica
that finds no card fails its deploy; it does not fall back to the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ray_tpu_torch import serve
from ray_tpu_torch.llm.config import LLMConfig


def build_llm_deployment(config: LLMConfig, *, device=None):
    """Build (not deploy) the Serve application for ``config``; its
    replica's engine runs on ``device`` (None: the card)."""
    # the class below is cloudpickled by value into the replica's process:
    # it closes over the config and a device NAME, never over an engine
    # or a tensor of this process
    device = None if device is None else str(device)

    @serve.deployment(
        name=config.name,
        num_replicas=config.num_replicas,
        # concurrent handlers feed the continuous batcher's one device
        # loop — the replica must accept overlapping requests
        max_ongoing_requests=max(8, config.cache_slots * 2),
        ray_actor_options=(
            {"resources": config.resources} if config.resources else None),
    )
    class LLMServer:
        def __init__(self):
            if config.continuous_batching:
                from ray_tpu_torch.llm.engine import ContinuousLLMEngine

                self.engine = ContinuousLLMEngine(config, device=device)
            else:
                from ray_tpu_torch.llm.engine import LLMEngine

                self.engine = LLMEngine(config, device=device)
            self.tokenizer = self.engine.tokenizer
            self._batch_sizes = []

        @serve.batch(max_batch_size=config.batch_max_size,
                     batch_wait_timeout_s=config.batch_wait_timeout_s)
        def _generate_batch(self, prompts):
            self._batch_sizes.append(len(prompts))
            return self.engine.generate(prompts)

        def __call__(self, prompt: str) -> str:
            if config.continuous_batching:
                from ray_tpu_torch.serve import slo

                # iteration-level scheduling: this request joins the
                # running decode batch the moment a KV slot frees; the
                # wait is bounded by the request's deadline (expiry →
                # DeadlineExceededError → 504 at the front door), and an
                # expired request gives its slot back
                fut = self.engine.submit(prompt)
                try:
                    return slo.result_within_deadline(fut)
                except slo.DeadlineExceededError:
                    fut.cancel()
                    raise
            return self._generate_batch(prompt)

        def engine_stats(self) -> dict:
            st = getattr(getattr(self.engine, "batcher", None), "stats",
                         None)
            return dict(st) if st is not None else {}

        def replica_stats(self) -> dict:
            import os

            import ray_tpu_torch
            from ray_tpu_torch.ops import attention as A

            return {
                "pid": os.getpid(),
                "visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "gpu_ids": ray_tpu_torch.get_runtime_context()
                .get_assigned_resources().get("gpu_ids", []),
                "device": str(self.engine.device),
                "kernel_launches": {
                    "flash_fwd": A.flash_fwd_launches,
                    "flash_bwd_dq": A.flash_bwd_dq_launches,
                    "flash_bwd_dkv": A.flash_bwd_dkv_launches},
                "batch_sizes": list(self._batch_sizes),
            }

        def generate_stream(self, prompt: str,
                            max_tokens: Optional[int] = None):
            """Yields text deltas for one prompt (token-level streaming)."""
            sampling = self.engine.config.sampling
            if max_tokens is not None:
                sampling = dataclasses.replace(sampling,
                                               max_tokens=max_tokens)
            eos = getattr(self.tokenizer, "eos_token_id", None)
            if sampling.stop_token_id is None and eos is not None:
                sampling = dataclasses.replace(sampling, stop_token_id=eos)
            ids = self.tokenizer.encode(prompt)
            if config.continuous_batching:
                stream = self.engine.submit_stream(ids, sampling)
            else:
                stream = self.engine.generator.generate_stream(
                    ids, sampling, seed=self.engine.next_seed())
            out_ids = []
            prev_text = ""
            for t in stream:
                out_ids.append(t)
                text = self.tokenizer.decode(out_ids)
                delta, prev_text = text[len(prev_text):], text
                if delta:
                    yield delta

    return LLMServer.bind()


def serve_llm(config: LLMConfig, *, device=None):
    """Deploy and return the live handle (reference: ray.llm serve
    entrypoints); the replica's engine runs on ``device`` (None: the
    card)."""
    return serve.run(build_llm_deployment(config, device=device),
                     name=config.name)
