"""In-process LLM engine: tokenizer + generator (PyTorch port of
ray_tpu/llm/engine.py)."""

from __future__ import annotations

import dataclasses
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Union

import torch

from ray_tpu_torch import default_device
from ray_tpu_torch.llm.config import LLMConfig
from ray_tpu_torch.models import transformer as T
from ray_tpu_torch.models.continuous_batching import ContinuousBatcher
from ray_tpu_torch.models.decoding import Generator, SamplingParams
from ray_tpu_torch.train.checkpoint import restore_state


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


class LLMEngine:
    """``params``: converted weights (models/convert.py) already on
    ``device``; or ``config.params_path``, a params tree saved by
    ``ray_tpu_torch.train.save_state`` (a fine-tune's), restored onto
    ``device``; without either the engine draws a seeded
    ``init_params``."""

    def __init__(self, config: LLMConfig, params: Optional[Dict] = None,
                 device=None):
        self.device = default_device(device)
        self.config = config
        self.tokenizer = config.get_tokenizer()
        cfg = T.config(config.model)
        vocab = getattr(self.tokenizer, "vocab_size", None)
        if vocab and vocab > cfg.vocab_size:
            # model must cover the tokenizer's id space
            cfg = T.config(cfg, vocab_size=int(vocab))
        self.model_config = cfg
        if config.params_path:
            if params is not None:
                raise ValueError("pass params= or LLMConfig.params_path, not both")
            # the target's shapes from param_shapes, jax.eval_shape's
            # counterpart: nothing is drawn to learn them
            shapes = T.param_shapes(cfg)
            target = _map(lambda sf: torch.empty(sf[0], dtype=cfg.param_dtype,
                                                 device="meta"), shapes)
            params = restore_state(config.params_path, target=target, device=self.device)
        elif params is None:
            gen = torch.Generator(device=self.device).manual_seed(config.seed)
            params = T.init_params(cfg, gen, self.device)
        self.generator = Generator(cfg, params, max_len=config.max_len,
                                   device=self.device)
        self._call_count = 0

    def next_seed(self) -> int:
        """Fresh seed per call: temperature sampling must differ across
        requests for the same prompt (deterministic given config.seed
        and call order, so tests stay reproducible)."""
        self._call_count += 1
        return self.config.seed + self._call_count

    def generate_tokens(self, prompts: Sequence[Sequence[int]],
                        sampling: Optional[SamplingParams] = None
                        ) -> List[List[int]]:
        sampling = sampling or self.config.sampling
        return self.generator.generate(
            [list(p) for p in prompts], sampling, seed=self.next_seed())

    def _with_eos(self, sampling: SamplingParams) -> SamplingParams:
        tok = self.tokenizer
        if sampling.stop_token_id is None and \
                getattr(tok, "eos_token_id", None) is not None:
            sampling = dataclasses.replace(
                sampling, stop_token_id=tok.eos_token_id)
        return sampling

    def generate(self, prompts: Sequence[Union[str, Sequence[int]]],
                 sampling: Optional[SamplingParams] = None) -> List[str]:
        """Text in → text out (token-id prompts pass through encode)."""
        tok = self.tokenizer
        sampling = self._with_eos(sampling or self.config.sampling)
        ids = [tok.encode(p) if isinstance(p, str) else list(p)
               for p in prompts]
        # empty prompts would index position -1 at prefill; give them BOS=0
        ids = [p if p else [0] for p in ids]
        outs = self.generate_tokens(ids, sampling)
        return [tok.decode(o) for o in outs]


class ContinuousLLMEngine(LLMEngine):
    """Engine whose device loop is a ContinuousBatcher: concurrent
    callers share decode steps, new requests join the running batch the
    moment a slot frees."""

    def __init__(self, config: LLMConfig, params: Optional[Dict] = None,
                 device=None):
        super().__init__(config, params, device)
        self.batcher = ContinuousBatcher(
            self.model_config, self.generator.params,
            max_len=config.max_len, slots=config.cache_slots,
            seed=config.seed, device=self.device)

    def _ids(self, prompt: Union[str, Sequence[int]]) -> List[int]:
        ids = self.tokenizer.encode(prompt) if isinstance(prompt, str) \
            else list(prompt)
        return ids or [0]

    def submit(self, prompt: Union[str, Sequence[int]],
               sampling: Optional[SamplingParams] = None) -> Future:
        """Thread-safe; returns a Future resolving to the completion
        TEXT. Cancelling it cancels the request: its KV slot frees at
        the batcher's next step."""
        tok = self.tokenizer
        sampling = self._with_eos(sampling or self.config.sampling)
        inner = self.batcher.submit(self._ids(prompt), sampling)
        out: Future = Future()

        def _chain(f):
            # concurrent.futures swallows callback exceptions: a decode
            # failure must still resolve `out` or the caller hangs
            if out.done():  # cancelled by its caller
                return
            try:
                exc = f.exception()
                if exc is not None:
                    out.set_exception(exc)
                else:
                    out.set_result(tok.decode(f.result()))
            except BaseException as e:  # noqa: BLE001
                if not out.done():
                    out.set_exception(e)

        inner.add_done_callback(_chain)
        out.add_done_callback(lambda f: f.cancelled() and inner.cancel())
        return out

    def submit_stream(self, prompt: Union[str, Sequence[int]],
                      sampling: Optional[SamplingParams] = None):
        """Yields token ids as the batcher emits them."""
        sampling = self._with_eos(sampling or self.config.sampling)
        return self.batcher.submit_stream(self._ids(prompt), sampling)

    def shutdown(self) -> None:
        self.batcher.shutdown()
