"""Continuous batching: admit/evict sequences per decode step over a
fixed-slot KV cache (PyTorch port of
ray_tpu/models/continuous_batching.py).

- the KV cache has a FIXED number of slots (rows) and a fixed max_len,
- one decode step advances ALL slots together (free slots compute too
  and are masked out),
- per-slot sampling (temperature / top-k) is vectorized so requests
  with different SamplingParams share one device step,
- admission: a waiting request prefills (through the flash kernel) into
  a standalone single-row cache, padded to a 16·2^k length bucket, and
  the row is copied in place into its slot; eviction: stop-token /
  max_tokens / cache-full frees the slot the same step, and the next
  waiting request takes it.

``ContinuousBatcher.submit()`` is thread-safe and returns a Future; a
daemon pump thread (``cb-pump``) runs steps while any request is active
or waiting.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ray_tpu_torch import default_device
from ray_tpu_torch.models.decoding import (
    SamplingParams,
    _gumbel_argmax,
    forward_cached,
    init_cache,
)
from ray_tpu_torch.models.transformer import TransformerConfig
from ray_tpu_torch.ops.attention import NEG_INF


def _sample_per_slot(logits, generator, temps, topks):
    """Vectorized sampling: per-row temperature (0 = greedy) and top-k
    (0 = unfiltered). logits [B, V], temps [B] fp32, topks [B] int → ids [B]."""
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits.float() / temps.clamp_min(1e-6)[:, None]
    # per-row kth threshold: value at rank (top_k - 1) descending;
    # top_k == 0 disables the filter for that row
    v = logits.shape[-1]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    idx = (topks - 1).clamp(0, v - 1)[:, None]
    kth = torch.gather(sorted_desc, 1, idx)
    filtered = torch.where((topks[:, None] > 0) & (scaled < kth), NEG_INF, scaled)
    sampled = _gumbel_argmax(filtered, generator)
    return torch.where(temps > 0.0, sampled, greedy)


@dataclasses.dataclass
class _Request:
    tokens: List[int]
    sampling: SamplingParams
    future: Optional[Future]
    stream_q: Optional[queue.Queue]  # token stream, None-terminated
    out: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1


class ContinuousBatcher:
    """Iteration-level scheduler over a fixed-slot KV cache."""

    def __init__(self, cfg: TransformerConfig, params, max_len: int = 512,
                 slots: int = 8, seed: int = 0, device=None):
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.slots = slots
        self.device = default_device(device)
        self._waiting: "queue.Queue[_Request]" = queue.Queue()
        # scheduler state (_active/_free/_host_len/...) is confined to
        # the pump thread; only _waiting and stats cross threads
        self._active: Dict[int, _Request] = {}
        self._free = list(range(slots))
        self._wake = threading.Event()
        self._shutdown = False
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.cache = init_cache(cfg, slots, max_len, device=self.device)
        # per-slot host-side state (no device sync on the emit path)
        self._temps = np.zeros(slots, np.float32)
        self._topks = np.zeros(slots, np.int64)
        self._last_tok = np.zeros(slots, np.int64)
        self._host_len = np.zeros(slots, np.int64)
        # stats (observable by tests/metrics)
        self.stats = {"admitted": 0, "finished": 0, "steps": 0,
                      "max_active": 0, "tokens_out": 0,
                      "last_admit_step": -1}
        self._thread = threading.Thread(
            target=self._pump, daemon=True, name="cb-pump")
        self._thread.start()

    # -- public API -----------------------------------------------------
    def submit(self, tokens: Sequence[int],
               sampling: Optional[SamplingParams] = None) -> Future:
        """Thread-safe: enqueue one request; resolves to List[int]."""
        if self._shutdown:
            raise RuntimeError("ContinuousBatcher was shut down")
        fut: Future = Future()
        req = _Request(list(tokens) or [0], sampling or SamplingParams(),
                       fut, None)
        self._check_len(req)
        self._waiting.put(req)
        self._wake.set()
        return fut

    def submit_stream(self, tokens: Sequence[int],
                      sampling: Optional[SamplingParams] = None):
        """Yields token ids as they are emitted."""
        if self._shutdown:
            raise RuntimeError("ContinuousBatcher was shut down")
        q: queue.Queue = queue.Queue()
        req = _Request(list(tokens) or [0], sampling or SamplingParams(),
                       None, q)
        self._check_len(req)
        self._waiting.put(req)
        self._wake.set()
        while True:
            t = q.get()
            if t is None:
                return
            yield t

    def shutdown(self) -> None:
        self._shutdown = True
        self._wake.set()
        self._thread.join(timeout=10.0)
        # outstanding work can never run now: resolve it with an error
        # instead of hanging its callers
        err = RuntimeError("ContinuousBatcher was shut down")
        leftovers = list(self._active.values())
        while not self._waiting.empty():
            try:
                leftovers.append(self._waiting.get_nowait())
            except queue.Empty:
                break
        for req in leftovers:
            if req.future is not None and not req.future.done():
                req.future.set_exception(err)
            if req.stream_q is not None:
                req.stream_q.put(None)

    def _check_len(self, req: _Request) -> None:
        if len(req.tokens) >= self.max_len:
            raise ValueError(
                f"prompt length {len(req.tokens)} >= max_len "
                f"{self.max_len}")

    # -- device programs ------------------------------------------------
    def _prefill(self, tokens, length: int):
        """[1, S] prompt -> (last_logits [V], row_k, row_v [L, S, kvH, D])
        through a standalone single-row cache."""
        s = tokens.shape[1]
        row_cache = init_cache(self.cfg, 1, s, device=self.device)
        positions = torch.arange(s, device=self.device)[None, :]
        logits, row_cache = forward_cached(
            self.cfg, self.params, tokens, positions, row_cache, None,
            prefill=True)
        return logits[0, length - 1], row_cache.k[:, 0], row_cache.v[:, 0]

    def _install(self, row_k, row_v, slot: int, length: int) -> None:
        """Copy a prefilled row into its slot of the big cache, in place;
        the rest of the slot — stale data from its previous occupant — is
        zeroed, so the whole slot is overwritten."""
        s = row_k.shape[1]
        for big, row in ((self.cache.k, row_k), (self.cache.v, row_v)):
            big[:, slot, :s] = row
            big[:, slot, s:] = 0
        self.cache.lengths[slot] = length

    def _decode(self, toks, temps, topks, active_mask):
        cache = self.cache
        positions = cache.lengths[:, None]
        kv_mask = torch.arange(self.max_len, device=self.device)[None, :] <= \
            cache.lengths[:, None]
        logits, _ = forward_cached(
            self.cfg, self.params, toks[:, None], positions, cache, kv_mask)
        nxt = _sample_per_slot(logits[:, 0], self._gen, temps, topks)
        # only ACTIVE slots advance; free rows stay put
        cache.lengths += active_mask.to(cache.lengths.dtype)
        return nxt

    # -- scheduler ------------------------------------------------------
    @staticmethod
    def _bucket(n: int) -> int:
        b = 16
        while b < n:
            b *= 2
        return b

    def _admit(self) -> bool:
        admitted = False
        while self._free and not self._waiting.empty():
            try:
                req = self._waiting.get_nowait()
            except queue.Empty:
                break
            slot = self._free.pop()
            try:
                self._admit_one(req, slot)
            except Exception as e:  # noqa: BLE001 — e.g. out of memory
                # the slot goes back and THIS request fails; others and
                # the pump survive
                self._free.append(slot)
                if req.future is not None and not req.future.done():
                    req.future.set_exception(e)
                if req.stream_q is not None:
                    req.stream_q.put(None)
                continue
            admitted = True
        self.stats["max_active"] = max(self.stats["max_active"],
                                       len(self._active))
        return admitted

    def _admit_one(self, req: _Request, slot: int) -> None:
        bucket = min(self._bucket(len(req.tokens)), self.max_len)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, : len(req.tokens)] = req.tokens
        with torch.no_grad():
            last_logits, row_k, row_v = self._prefill(
                torch.from_numpy(toks).to(self.device), len(req.tokens))
            self._install(row_k, row_v, slot, len(req.tokens))
            first = _sample_per_slot(
                last_logits[None], self._gen,
                torch.tensor([req.sampling.temperature], dtype=torch.float32,
                             device=self.device),
                torch.tensor([req.sampling.top_k], device=self.device))
        req.slot = slot
        self.stats["last_admit_step"] = self.stats["steps"]
        self._temps[slot] = req.sampling.temperature
        self._topks[slot] = req.sampling.top_k
        self._host_len[slot] = len(req.tokens)
        self._last_tok[slot] = int(first[0])
        self._active[slot] = req
        self.stats["admitted"] += 1
        self._emit(req, self._last_tok[slot])

    def _emit(self, req: _Request, tok: int) -> None:
        """Deliver one sampled token; free the slot when the request is
        done (stop token / max_tokens / out of cache room)."""
        stop = req.sampling.stop_token_id
        done = False
        if stop is not None and tok == stop:
            done = True
        else:
            req.out.append(int(tok))
            if req.stream_q is not None:
                req.stream_q.put(int(tok))
            self.stats["tokens_out"] += 1
            if len(req.out) >= req.sampling.max_tokens:
                done = True
        # prompt_len + emitted tokens occupy the row; the NEXT decode
        # writes at position lengths[slot], which must stay < max_len —
        # matching Generator.generate's lengths >= max_len stop
        if not done and req.slot >= 0:
            if self._host_len[req.slot] >= self.max_len:
                done = True
        if done:
            self._retire(req)

    def _retire(self, req: _Request) -> None:
        self._retire_silent(req)
        self.stats["finished"] += 1
        if req.future is not None and not req.future.done():
            req.future.set_result(list(req.out))
        if req.stream_q is not None:
            req.stream_q.put(None)

    def _pump(self) -> None:
        while not self._shutdown:
            if not self._active and self._waiting.empty():
                self._wake.wait(timeout=0.1)
                self._wake.clear()
                continue
            try:
                self._step()
            except Exception as e:  # noqa: BLE001 — fail active requests
                for req in list(self._active.values()):
                    if req.future is not None and not req.future.done():
                        req.future.set_exception(e)
                    if req.stream_q is not None:
                        req.stream_q.put(None)
                    self._retire_silent(req)
                logging.getLogger(__name__).exception(
                    "continuous-batching step failed")

    def _retire_silent(self, req: _Request) -> None:
        if req.slot >= 0:
            self._active.pop(req.slot, None)
            self._free.append(req.slot)
            req.slot = -1

    def _step(self) -> None:
        self._admit()
        if not self._active:
            return
        active_mask = np.zeros(self.slots, bool)
        for slot in self._active:
            active_mask[slot] = True
        dev = self.device
        with torch.no_grad():
            toks = self._decode(
                torch.from_numpy(self._last_tok).to(dev),
                torch.from_numpy(self._temps).to(dev),
                torch.from_numpy(self._topks).to(dev),
                torch.from_numpy(active_mask).to(dev))
        self.stats["steps"] += 1
        toks_np = toks.cpu().numpy()
        for slot, req in list(self._active.items()):
            self._host_len[slot] += 1
            self._last_tok[slot] = int(toks_np[slot])
            self._emit(req, int(toks_np[slot]))
