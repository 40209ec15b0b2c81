"""Block-paged KV cache with prefix reuse (PyTorch port of
ray_tpu/models/paged_kv.py) — vLLM's PagedAttention memory model with
automatic prefix caching.

- **One physical pool** ``[L, num_pages, page_size, kvH, D]`` for K and
  V, allocated once on the device and written in place (its
  ``data_ptr()`` never changes). Page tables are ``[slots,
  pages_per_seq]`` on the host.
- **Decode** gathers each slot's pages into a dense per-layer view
  (``pool[l][page_table]``, ``[B, max_len, kvH, D]``: the transient is
  one layer's worth), attends with the plain ``_attend_cached`` as the
  slot-dense decode does, then scatters the fresh K/V into the slot's
  current write page. Advanced indexing returns a copy, so the write
  that the block makes into the view does not reach the pool: the
  fresh K/V are scattered into it explicitly, layer by layer. Inactive
  slots write to a reserved trash page (page 0), so the step needs no
  host-side branching.
- **Prefill runs the flash forward kernel.** A cold prompt is one causal
  kernel call a layer over its own fresh K/V (the slot-dense batcher's
  prefill, then installed into its pages). A prompt that reuses a
  cached prefix prefills only the remainder, at positions prefix_len..:
  a ``causal=False`` call over the prefix K/V (gathered from the pool)
  and a causal call over the fresh K/V, merged by log-sum-exp, since
  the kernel's causal mask is top-left aligned. L launches a cold
  prefill, 2·L a warm one.
- **Prefix reuse**: pages are refcounted; a finished sequence's prompt
  pages register content hashes at full-page granularity. A new prompt
  reuses the longest cached chain of FULL pages (incref — shared pages
  are never written: decode only appends to a sequence's private last
  page). Freed pages stay cached (rc=0, on the LRU free list) until the
  allocator reclaims them, exactly vLLM's "cached-free" state.
- **Disaggregated prefill**: ``submit_prefilled`` admits a request
  whose KV row was computed elsewhere, installing pages without running
  local prefill.

Eager PyTorch compiles no programs, so JAX's ``decode_cache_size`` (the
no-recompile hook) has no counterpart; what it guards is checked
instead: the pool never moves, and every decode step launches the same
kernels.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import queue
import threading
from collections import OrderedDict
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch import default_device
from ray_tpu_torch.models.continuous_batching import ContinuousBatcher, _sample_per_slot
from ray_tpu_torch.models.decoding import (
    SamplingParams,
    _block_cached,
    forward_cached,
    init_cache,
)
from ray_tpu_torch.models.transformer import TransformerConfig, _layer, _logits


class KVPoolExhausted(RuntimeError):
    """No free pages. A RuntimeError subclass so existing callers that
    catch the old bare RuntimeError keep working; the batcher's admit
    path catches THIS to requeue instead of failing the request."""


class PagedKV:
    """Host-side page bookkeeping: refcounts, free list, prefix map."""

    def __init__(self, num_pages: int, page_size: int):
        self.num_pages = num_pages
        self.page_size = page_size
        self.rc = np.zeros(num_pages, np.int32)
        self.rc[0] = 1  # page 0 = trash page, never allocated
        # free pages in LRU order; a freed page keeps its content (and
        # its prefix-map entry) until reallocated
        self.free: "OrderedDict[int, None]" = OrderedDict(
            (i, None) for i in range(1, num_pages))
        # prefix hash -> page id holding that page of the prefix
        self.prefix_map: Dict[str, int] = {}
        self.page_key: Dict[int, str] = {}  # inverse, for invalidation
        self.stats = {"prefix_hit_pages": 0, "alloc_pages": 0,
                      "evicted_entries": 0}

    def alloc(self) -> int:
        """Pop the least-recently-freed page, invalidating whatever
        prefix entry still pointed at its old content."""
        if not self.free:
            raise KVPoolExhausted("KV pool exhausted")
        page, _ = self.free.popitem(last=False)
        old_key = self.page_key.pop(page, None)
        if old_key is not None and self.prefix_map.get(old_key) == page:
            del self.prefix_map[old_key]
            self.stats["evicted_entries"] += 1
        self.rc[page] = 1
        self.stats["alloc_pages"] += 1
        return page

    def incref(self, page: int) -> None:
        if self.rc[page] == 0:
            self.free.pop(page, None)  # cached-free -> live again
        self.rc[page] += 1

    def decref(self, page: int) -> None:
        self.rc[page] -= 1
        if self.rc[page] == 0:
            self.free[page] = None  # to the LRU tail, content retained

    def lookup_prefix(self, keys: List[str]) -> List[int]:
        """Longest chain of cached pages matching the prefix keys."""
        pages: List[int] = []
        for key in keys:
            page = self.prefix_map.get(key)
            if page is None:
                break
            pages.append(page)
        self.stats["prefix_hit_pages"] += len(pages)
        return pages

    def register_prefix(self, keys: List[str], pages: List[int]) -> None:
        for key, page in zip(keys, pages):
            if key not in self.prefix_map:
                self.prefix_map[key] = page
                self.page_key[page] = key


def prefix_keys(tokens: Sequence[int], page_size: int) -> List[str]:
    """One content hash per FULL page of the prompt: key i covers
    tokens[:page_size*(i+1)] — a chain, so matching key i implies the
    whole prefix up to that page matches."""
    keys = []
    h = hashlib.sha1()
    full_pages = len(tokens) // page_size
    for i in range(full_pages):
        chunk = tokens[i * page_size:(i + 1) * page_size]
        h.update(np.asarray(chunk, np.int32).tobytes())
        keys.append(h.hexdigest())
    return keys


@dataclasses.dataclass
class _Request:
    tokens: List[int]
    sampling: SamplingParams
    future: Optional[Future]
    stream_q: Optional[queue.Queue]
    # disaggregated prefill: KV row + last logits computed elsewhere
    premade_row: Optional[Tuple[Any, Any, Any]] = None
    out: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    pages: List[int] = dataclasses.field(default_factory=list)
    # len(tokens) at submission: a preemption appends the output to tokens
    prompt_len: int = dataclasses.field(init=False)

    def __post_init__(self):
        self.prompt_len = len(self.tokens)


class PagedBatcher:
    """Continuous batching over the paged pool. API mirrors
    models/continuous_batching.ContinuousBatcher (submit/submit_stream/
    shutdown + stats) so engines can swap slot-dense for paged."""

    def __init__(self, cfg: TransformerConfig, params, max_len: int = 512,
                 slots: int = 8, page_size: int = 64,
                 extra_pages: int = 0, seed: int = 0,
                 num_pages: Optional[int] = None, device=None):
        """``num_pages`` overrides the pool size: smaller than
        1 + slots*pages_per_seq overcommits memory (lazy growth +
        recompute-preemption absorb the shortfall — vLLM's model);
        ``extra_pages`` adds headroom so freed prefix pages survive
        longer in the cache."""
        if max_len % page_size != 0:
            raise ValueError("max_len must be a multiple of page_size")
        self.device = default_device(device)
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.page_size = page_size
        self.pages_per_seq = max_len // page_size
        self.slots = slots
        if num_pages is None:
            num_pages = 1 + slots * self.pages_per_seq + extra_pages
        self.kv = PagedKV(num_pages, page_size)
        shape = (cfg.layers, num_pages, page_size, cfg.kv_heads, cfg.hd)
        self.pool_k = torch.zeros(shape, dtype=cfg.dtype, device=self.device)
        self.pool_v = torch.zeros(shape, dtype=cfg.dtype, device=self.device)
        # per-slot host state, confined to the pump thread
        self._page_table = np.zeros((slots, self.pages_per_seq), np.int64)
        self._lengths = np.zeros(slots, np.int64)
        self._temps = np.zeros(slots, np.float32)
        self._topks = np.zeros(slots, np.int64)
        self._last_tok = np.zeros(slots, np.int64)
        self._active: Dict[int, _Request] = {}
        self._free_slots = list(range(slots))
        self._waiting: "queue.Queue[_Request]" = queue.Queue()
        self._wake = threading.Event()
        self._shutdown = False
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.stats = {"admitted": 0, "finished": 0, "steps": 0,
                      "tokens_out": 0, "prefill_tokens": 0,
                      "prefix_hit_tokens": 0, "preempted": 0}
        self._thread = threading.Thread(target=self._pump, daemon=True,
                                        name="paged-pump")
        self._thread.start()

    # -- public API -----------------------------------------------------
    def submit(self, tokens: Sequence[int],
               sampling: Optional[SamplingParams] = None) -> Future:
        return self._enqueue(tokens, sampling, stream=False)

    def submit_stream(self, tokens: Sequence[int],
                      sampling: Optional[SamplingParams] = None):
        req = self._enqueue(tokens, sampling, stream=True)
        while True:
            t = req.get()
            if t is None:
                return
            yield t

    def submit_prefilled(self, tokens: Sequence[int], row_k, row_v,
                         last_logits,
                         sampling: Optional[SamplingParams] = None
                         ) -> Future:
        """Admit a request whose prompt KV was computed by a prefill
        replica (disaggregated prefill — reference:
        llm/_internal/serve/engines/vllm/kv_transfer/). ``row_k/row_v``
        are [L, S, kvH, D] with S >= len(tokens)."""
        if self._shutdown:
            raise RuntimeError("PagedBatcher was shut down")
        fut: Future = Future()
        dev = self.device
        req = _Request(list(tokens) or [0], sampling or SamplingParams(),
                       fut, None,
                       premade_row=(torch.as_tensor(row_k, device=dev),
                                    torch.as_tensor(row_v, device=dev),
                                    torch.as_tensor(last_logits, device=dev)))
        self._check_len(req)
        self._waiting.put(req)
        self._wake.set()
        return fut

    def _enqueue(self, tokens, sampling, stream: bool):
        if self._shutdown:
            raise RuntimeError("PagedBatcher was shut down")
        q: Optional[queue.Queue] = queue.Queue() if stream else None
        fut: Optional[Future] = None if stream else Future()
        req = _Request(list(tokens) or [0], sampling or SamplingParams(),
                       fut, q)
        self._check_len(req)
        self._waiting.put(req)
        self._wake.set()
        return q if stream else fut

    def _check_len(self, req: _Request) -> None:
        if len(req.tokens) >= self.max_len:
            raise ValueError(
                f"prompt length {len(req.tokens)} >= max_len "
                f"{self.max_len}")

    def shutdown(self) -> None:
        self._shutdown = True
        self._wake.set()
        self._thread.join(timeout=10.0)
        err = RuntimeError("PagedBatcher was shut down")
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

    # -- device programs ------------------------------------------------
    def _prefill(self, tokens, length: int, prefix_pages: List[int]):
        """Prefill ``tokens`` [1, S] (a bucketed remainder) at positions
        prefix_len.., after the reused prefix held in ``prefix_pages``
        (whole pages). Returns (last_logits [V] at ``length`` - 1, row_k,
        row_v [L, S, kvH, D] of the S fresh positions)."""
        cfg, s = self.cfg, tokens.shape[1]
        prefix_len = len(prefix_pages) * self.page_size
        row = init_cache(cfg, 1, prefix_len + s, device=self.device)
        if prefix_len:
            pk, pv = self._gather_row(prefix_pages)
            row.k[:, 0, :prefix_len] = pk
            row.v[:, 0, :prefix_len] = pv
        positions = prefix_len + torch.arange(s, device=self.device)[None, :]
        logits, row = forward_cached(cfg, self.params, tokens, positions, row,
                                     None, prefill=True, prefix_len=prefix_len)
        return (logits[0, length - prefix_len - 1], row.k[:, 0, prefix_len:],
                row.v[:, 0, prefix_len:])

    def _install(self, row_k, row_v, pages: List[int]) -> None:
        """Write a [L, S, kvH, D] row into ``pages`` of the pool, in order
        and in place: rows past S are zeroed, rows past the pages dropped
        (JAX sends those to the trash page)."""
        ps, n = self.page_size, len(pages)
        if not n:
            return
        idx = torch.tensor(pages, device=self.device)
        for pool, row in ((self.pool_k, row_k), (self.pool_v, row_v)):
            blk = row[:, :n * ps].to(pool.dtype)
            if blk.shape[1] < n * ps:
                pad = blk.new_zeros((blk.shape[0], n * ps - blk.shape[1]) + blk.shape[2:])
                blk = torch.cat([blk, pad], 1)
            pool[:, idx] = blk.reshape((blk.shape[0], n, ps) + blk.shape[2:])

    def _gather_row(self, pages: List[int]):
        """``pages`` → their dense K/V rows [L, len(pages)·page_size, kvH,
        D] (for continuation prefill over a reused prefix)."""
        idx = torch.tensor(pages, device=self.device)
        k, v = self.pool_k[:, idx], self.pool_v[:, idx]  # [L, P, ps, kvH, D]
        n = len(pages) * self.page_size
        return (k.reshape((k.shape[0], n) + k.shape[3:]),
                v.reshape((v.shape[0], n) + v.shape[3:]))

    def _decode(self, toks, page_table, lengths, temps, topks, active_mask):
        """One decode step for all slots over the paged pool; writes each
        active slot's fresh K/V into its page at its length, in place.
        Returns the next token of every slot [B]."""
        cfg = self.cfg
        b, ps = toks.shape[0], self.page_size
        t_total = self.pages_per_seq * ps
        positions = lengths[:, None]
        kv_mask = torch.arange(t_total, device=self.device)[None, :] <= lengths[:, None]
        # current write target per slot; inactive slots hit trash page 0
        bidx = torch.arange(b, device=self.device)
        cur_page = torch.where(
            active_mask,
            page_table[bidx, (lengths // ps).clamp(max=self.pages_per_seq - 1)], 0)
        cur_off = torch.where(active_mask, lengths % ps, 0)
        fresh = lengths.clamp(max=t_total - 1)
        x = self.params["embed"].to(cfg.dtype)[toks[:, None]]
        for i in range(cfg.layers):
            lp, lo = _layer(self.params, i)
            # dense per-layer view of each slot's pages: a copy (transient,
            # one layer), so the block's write of the fresh K/V stays in it
            kd = self.pool_k[i][page_table].reshape(b, t_total, cfg.kv_heads, cfg.hd)
            vd = self.pool_v[i][page_table].reshape(b, t_total, cfg.kv_heads, cfg.hd)
            x = _block_cached(cfg, x, lp, lo, positions, kd, vd, kv_mask)
            self.pool_k[i][cur_page, cur_off] = kd[bidx, fresh]
            self.pool_v[i][cur_page, cur_off] = vd[bidx, fresh]
        logits = _logits(cfg, self.params, x)
        return _sample_per_slot(logits[:, 0], self._gen, temps, topks)

    # -- scheduler ------------------------------------------------------
    _bucket = staticmethod(ContinuousBatcher._bucket)  # 16·2^k prefill lengths

    def _admit(self) -> None:
        while self._free_slots and not self._waiting.empty():
            try:
                req = self._waiting.get_nowait()
            except queue.Empty:
                break
            slot = self._free_slots.pop()
            try:
                self._admit_one(req, slot)
            except Exception as e:  # noqa: BLE001
                self._free_slots.append(slot)
                # _admit_one grows req.pages INCREMENTALLY (reused-prefix
                # increfs first, then each fresh alloc as it happens), so
                # this decref sweep releases everything a partial admit
                # acquired — no page leaks on pool exhaustion mid-admit
                for page in req.pages:
                    self.kv.decref(page)
                req.pages = []
                never_fits = (len(req.tokens) // self.page_size + 1
                              > self.kv.num_pages - 1)  # page 0 = trash
                if isinstance(e, KVPoolExhausted) and not never_fits:
                    # transient: active sequences hold the pool. Requeue
                    # at the FRONT (FIFO position kept — a tail requeue
                    # would let every later small request leapfrog a big
                    # one forever) and stop admitting; retired sequences
                    # free pages and the pump re-runs _admit every step.
                    # (A request bigger than the whole pool still fails:
                    # requeueing it would spin forever.)
                    with self._waiting.mutex:
                        self._waiting.queue.appendleft(req)
                        self._waiting.not_empty.notify()
                    break
                if req.future is not None and not req.future.done():
                    req.future.set_exception(e)
                if req.stream_q is not None:
                    req.stream_q.put(None)

    def _admit_one(self, req: _Request, slot: int) -> None:
        n = len(req.tokens)
        keys = prefix_keys(req.tokens, self.page_size)
        if req.premade_row is not None:
            reused: List[int] = []  # KV arrived whole from the prefiller
        else:
            reused = self.kv.lookup_prefix(keys)
            # reuse must leave at least one token to prefill (the last
            # logits come from the prefill forward)
            while reused and len(reused) * self.page_size >= n:
                self.kv.stats["prefix_hit_pages"] -= 1
                reused.pop()
        # every acquisition lands in req.pages IMMEDIATELY so the _admit
        # cleanup path can decref exactly what was taken when an alloc
        # below raises mid-admit
        req.pages = []
        for page in reused:
            self.kv.incref(page)
            req.pages.append(page)
        prefix_len = len(reused) * self.page_size
        self.stats["prefix_hit_tokens"] += prefix_len
        # LAZY allocation: only the pages the sequence occupies right now
        # (prompt + the first decode write at position n) — growth
        # happens per step in _grow_pages; this is what lets the pool be
        # smaller than slots × pages_per_seq (vLLM's overcommit)
        n_pages_now = n // self.page_size + 1
        for _ in range(n_pages_now - len(reused)):
            req.pages.append(self.kv.alloc())

        if req.premade_row is not None:
            row_k, row_v, last_logits = req.premade_row
            self._install(row_k, row_v, req.pages)
        else:
            remainder = req.tokens[prefix_len:]
            bucket = min(self._bucket(len(remainder)), self.max_len - prefix_len)
            bucket = max(bucket, len(remainder))
            toks = np.zeros((1, bucket), np.int64)
            toks[0, :len(remainder)] = remainder
            last_logits, row_k, row_v = self._prefill(
                torch.from_numpy(toks).to(self.device), n, reused)
            self.stats["prefill_tokens"] += len(remainder)
            self._install(row_k, row_v, req.pages[len(reused):])

        first = _sample_per_slot(
            last_logits[None], self._gen,
            torch.tensor([req.sampling.temperature], dtype=torch.float32,
                         device=self.device),
            torch.tensor([req.sampling.top_k], device=self.device))
        req.slot = slot
        self._page_table[slot] = 0
        self._page_table[slot, :len(req.pages)] = req.pages
        self._lengths[slot] = n
        self._temps[slot] = req.sampling.temperature
        self._topks[slot] = req.sampling.top_k
        self._last_tok[slot] = int(first[0])
        self._active[slot] = req
        self.stats["admitted"] += 1
        self._emit(req, self._last_tok[slot])

    def _emit(self, req: _Request, tok: int) -> None:
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
        if not done and req.slot >= 0 and \
                self._lengths[req.slot] >= self.max_len - 1:
            done = True
        if done:
            self._retire(req)

    def _retire(self, req: _Request) -> None:
        if req.slot >= 0:
            # register this prompt's full pages for future prefix hits
            keys = prefix_keys(req.tokens, self.page_size)
            self.kv.register_prefix(keys, req.pages[:len(keys)])
            self._release(req)
        self.stats["finished"] += 1
        if req.future is not None and not req.future.done():
            req.future.set_result(list(req.out))
        if req.stream_q is not None:
            req.stream_q.put(None)

    def _release(self, req: _Request) -> None:
        """Give back the request's pages and its slot."""
        for page in req.pages:
            self.kv.decref(page)
        req.pages = []
        self._active.pop(req.slot, None)
        self._free_slots.append(req.slot)
        req.slot = -1

    def _pump(self) -> None:
        while not self._shutdown:
            if not self._active and self._waiting.empty():
                self._wake.wait(timeout=0.1)
                self._wake.clear()
                continue
            try:
                with torch.no_grad():
                    self._step()
            except Exception as e:  # noqa: BLE001 — fail active requests
                for req in list(self._active.values()):
                    if req.future is not None and not req.future.done():
                        req.future.set_exception(e)
                    if req.stream_q is not None:
                        req.stream_q.put(None)
                    if req.slot >= 0:
                        self._release(req)
                logging.getLogger(__name__).exception("paged decode step failed")

    def _grow_pages(self) -> None:
        """Per-step lazy growth: every active slot must own the page its
        next decode write lands in. Pool exhausted → preempt the most
        recently admitted slot (free its pages, requeue it — it
        re-prefills from prompt+generated when room returns), matching
        vLLM's recompute-preemption policy. A slot preempted earlier in
        this sweep is skipped (JAX's loop indexes it and fails the step,
        ROADMAP.md Queue C)."""
        for slot in sorted(self._active):
            req = self._active.get(slot)
            if req is None:
                continue
            need = int(self._lengths[slot]) // self.page_size
            while need >= len(req.pages):
                try:
                    page = self.kv.alloc()
                except KVPoolExhausted:
                    # prefer preempting a DIFFERENT slot; if this is the
                    # only active one it preempts itself and returns
                    candidates = [s for s in self._active if s != slot]
                    victim = candidates[-1] if candidates else slot
                    self._preempt(victim)
                    if victim == slot:
                        return
                    continue
                req.pages.append(page)
                self._page_table[slot, len(req.pages) - 1] = page

    def _preempt(self, slot: int) -> None:
        req = self._active[slot]
        self._release(req)
        # recompute-preemption: when a slot frees up the request
        # re-prefills over prompt + everything generated so far and
        # resumes sampling from there. Already-emitted tokens stay
        # emitted (req.out keeps the max_tokens accounting). The prompt
        # is cut back first: JAX appends all of req.out again at each
        # preemption, repeating what an earlier one appended (Queue C).
        req.tokens = req.tokens[:req.prompt_len] + list(req.out)
        req.premade_row = None  # its KV is gone; must re-prefill
        self.stats["preempted"] += 1
        self._waiting.put(req)

    def _step(self) -> None:
        self._admit()
        if not self._active:
            return
        self._grow_pages()
        if not self._active:
            return
        active_mask = np.zeros(self.slots, bool)
        for slot in self._active:
            active_mask[slot] = True
        dev = self.device
        toks = self._decode(
            torch.from_numpy(self._last_tok).to(dev),
            torch.from_numpy(self._page_table).to(dev),
            torch.from_numpy(self._lengths).to(dev),
            torch.from_numpy(self._temps).to(dev),
            torch.from_numpy(self._topks).to(dev),
            torch.from_numpy(active_mask).to(dev))
        self.stats["steps"] += 1
        self._lengths[active_mask] += 1
        toks_np = toks.cpu().numpy()
        for slot, req in list(self._active.items()):
            self._last_tok[slot] = int(toks_np[slot])
            self._emit(req, int(toks_np[slot]))
