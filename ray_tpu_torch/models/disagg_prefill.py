"""Disaggregated prefill (PyTorch port of ray_tpu/models/disagg_prefill.py):
a prefill replica computes prompt KV, a decode replica consumes it — KV
crosses processes through a typed tensor channel, never the pickle path.

Reference: python/ray/llm/_internal/serve/engines/vllm/kv_transfer/ —
the reference splits prefill and decode across engine replicas and
ships KV blocks through a connector (NIXL / shared memory). Here the
prefill replica runs one bucketed prefill per prompt (the flash forward
kernel, L launches: ``forward_cached(prefill=True)``, as the paged
batcher's own prefill), writes the resulting [2, L, max_len, kvH, D] row
into a fixed-shape ``TensorChannel`` (shared memory, zero pickle) from a
pinned staging buffer, and the decode replica installs it straight into
its paged pool (``PagedBatcher.submit_prefilled``) and continuous-batches
decode. It runs no prompt prefill of its own.

Why it matters on the card: prefill is compute-bound (the tensor cores)
while decode is memory-bound (HBM streaming); separate replicas mean each
can be provisioned and batched on its own terms.

Pairing protocol: one caller submits ``prefill.remote`` then
``decode.remote`` for each request; actor task ordering per caller plus
the channel's one-slot ack backpressure keep the KV rows and decode
admissions in lockstep, and the decode side's ticket gate reads rows in
the engine's ticket order. The channel is same-host shared memory.

The rows travel as float32, the JAX package's wire: bf16 → fp32 → bf16
is exact. ``DisaggPrefillEngine`` takes ``num_gpus`` per replica beside
JAX's ``num_cpus`` (0 by default, JAX's placement: in local mode both
replicas share the driver's card; in a cluster each replica needs a
card of its own, ``num_gpus=1``) and an optional placement group whose
bundles 0 and 1 take the prefill and the decode replica. The decode
replica runs ``slots`` threads (JAX's runs 4 whatever its slots).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import torch

import ray_tpu_torch as rt
from ray_tpu_torch import default_device
from ray_tpu_torch.experimental.channel import TensorChannel
from ray_tpu_torch.models.decoding import SamplingParams, forward_cached, init_cache
from ray_tpu_torch.models.transformer import TransformerConfig

_TRANSPORT_DTYPE = "float32"  # the JAX package's wire; bf16 rows are cast exactly

Params = Union[Dict[str, Any], Callable[[], Dict[str, Any]]]


def _row_shape(cfg: TransformerConfig, max_len: int):
    # [2 (k/v), L, max_len, kvH, D]
    return (2, cfg.layers, max_len, cfg.kv_heads, cfg.hd)


def _params(params: Params):
    """The weights, or what a zero-argument callable that makes them
    returns, called here in the replica's process (a cluster replica then
    draws or loads its own instead of receiving them through the object
    store)."""
    return params() if callable(params) else params


@rt.remote(max_concurrency=1)
class PrefillReplica:
    """Computes prompt KV rows and streams them into the channel.

    max_concurrency=1: a single-threaded actor executes its tasks in
    enqueue order, so KV rows enter the channel in the same order the
    engine assigned ticket numbers — the decode side's ticket gate
    (DecodeReplica.generate) then pairs rows to requests exactly."""

    def __init__(self, cfg: TransformerConfig, params: Params, max_len: int,
                 channel: TensorChannel, device=None):
        self.cfg = cfg
        self.device = default_device(device)
        self.params = _params(params)
        self.max_len = max_len
        self.channel = channel
        # the row's host copy, pinned on a card: 512 MiB at llama3_8b's
        # full width, where a pageable copy off the card costs seconds
        self._row = torch.empty(_row_shape(cfg, max_len), dtype=torch.float32,
                                pin_memory=self.device.type == "cuda")
        self._times: List[Dict[str, float]] = []

    def prefill(self, tokens: Sequence[int]):
        """Returns (n_tokens, last_logits) on the object path; the KV
        row goes out-of-band through the tensor channel."""
        n = len(tokens)
        bucket = 16
        while bucket < n:
            bucket *= 2
        bucket = min(bucket, self.max_len)
        t0 = time.perf_counter()
        toks = torch.zeros((1, bucket), dtype=torch.int64)
        toks[0, :n] = torch.as_tensor(list(tokens), dtype=torch.int64)
        toks = toks.to(self.device)
        with torch.no_grad():
            cache = init_cache(self.cfg, 1, bucket, device=self.device)
            positions = torch.arange(bucket, device=self.device)[None, :]
            logits, cache = forward_cached(self.cfg, self.params, toks, positions,
                                           cache, None, prefill=True)
            last = logits[0, n - 1].float().cpu().numpy()
            t1 = time.perf_counter()
            row = torch.zeros(self._row.shape, dtype=torch.float32, device=self.device)
            row[0, :, :bucket] = cache.k[:, 0]
            row[1, :, :bucket] = cache.v[:, 0]
            self._row.copy_(row)  # one contiguous copy off the card
            del row, cache
        t2 = time.perf_counter()
        self.channel.write(self._row, timeout=120.0)
        self._times.append({"prefill_ms": 1e3 * (t1 - t0), "stage_ms": 1e3 * (t2 - t1),
                            "write_ms": 1e3 * (time.perf_counter() - t2)})
        return n, last

    def timings(self) -> List[Dict[str, float]]:
        """Per prompt, host ms: the prefill (to its last logits on the
        host), the row's copy into the staging buffer, and the channel
        write (waiting for the previous row's ack included)."""
        return list(self._times)


@rt.remote(max_concurrency=4)
class DecodeReplica:
    """Owns the paged pool; admits prefilled rows and decodes."""

    def __init__(self, cfg: TransformerConfig, params: Params, max_len: int,
                 slots: int, page_size: int, reader, device=None):
        from ray_tpu_torch.models.paged_kv import PagedBatcher

        self.batcher = PagedBatcher(cfg, _params(params), max_len=max_len,
                                    slots=slots, page_size=page_size, device=device)
        self.reader = reader
        # a card's rows land through one pinned buffer (a pageable 512 MiB
        # copy onto the card is several times slower), reused row by row
        self._row = torch.empty(_row_shape(cfg, max_len), dtype=torch.float32,
                                pin_memory=True) \
            if self.batcher.device.type == "cuda" else None
        # ticket gate: generate() may run on several actor threads, but
        # channel reads MUST happen in the engine's ticket order or two
        # same-length prompts could swap KV rows undetectably
        self._next_ticket = 0
        self._ticket_cv = threading.Condition()
        self._times: List[Dict[str, float]] = []

    def generate(self, tokens: Sequence[int], prefill_meta,
                 sampling: Optional[SamplingParams] = None,
                 ticket: int = 0) -> List[int]:
        """prefill_meta is PrefillReplica.prefill's return (resolved by
        the runtime when the prefill task finishes — by which time its
        KV row is already in, or entering, the channel)."""
        n, last_logits = prefill_meta
        if n != len(tokens):
            raise RuntimeError(f"prefill/decode pairing broke: {n} != {len(tokens)}")
        with self._ticket_cv:
            while ticket != self._next_ticket:
                if not self._ticket_cv.wait(timeout=300.0):
                    raise TimeoutError(
                        f"ticket {ticket} starved (next="
                        f"{self._next_ticket})")
            t0 = time.perf_counter()
            if self._row is None:
                row = torch.from_numpy(self.reader.read(timeout=120.0))
                t1 = time.perf_counter()
            else:
                view = self.reader.read_view(timeout=120.0)
                try:
                    self._row.numpy()[...] = view
                finally:
                    self.reader.release()
                t1 = time.perf_counter()
                # synchronous from pinned memory: the buffer is free again
                # before the next ticket's row is copied into it
                row = self._row.to(self.batcher.device)
            t2 = time.perf_counter()
            self._next_ticket += 1
            self._ticket_cv.notify_all()
        self._times.append({"read_ms": 1e3 * (t1 - t0), "to_device_ms": 1e3 * (t2 - t1)})
        # the logits arrive as a read-only array from the object path
        fut = self.batcher.submit_prefilled(
            tokens, row[0], row[1], torch.tensor(last_logits), sampling)
        return fut.result(timeout=300.0)

    def stats(self) -> Dict[str, int]:
        return dict(self.batcher.stats)

    def timings(self) -> List[Dict[str, float]]:
        """Per row, host ms: the channel read (a copy out of shared
        memory, into the pinned buffer on a card) and the copy onto the
        replica's device."""
        return list(self._times)

    def close(self) -> bool:
        self.batcher.shutdown()
        return True


class DisaggPrefillEngine:
    """Two-replica engine: ``generate`` fans a request through the
    prefill replica into the decode replica and returns the sampled
    tokens. Construction is driver-side; both replicas live on the
    local node (the KV channel is shared memory).

    ``device=None`` is the card (each replica's leased one in a
    cluster), raising here where there is none; the CPU only where the
    caller asks. ``params`` may be a zero-argument callable that each
    replica calls to build its weights. ``placement_group``: bundle 0
    takes the prefill replica, bundle 1 the decode replica."""

    def __init__(self, cfg: TransformerConfig, params: Params, max_len: int = 256,
                 slots: int = 4, page_size: int = 32,
                 num_cpus: float = 0.5, num_gpus: float = 0, device=None,
                 placement_group=None):
        from ray_tpu_torch.util.scheduling_strategies import (
            PlacementGroupSchedulingStrategy,
        )

        device = str(default_device(device).type)
        self.channel = TensorChannel(_row_shape(cfg, max_len),
                                     _TRANSPORT_DTYPE)

        def opts(bundle: int) -> dict:
            o = {"num_cpus": num_cpus, "num_gpus": num_gpus}
            if placement_group is not None:
                o["scheduling_strategy"] = PlacementGroupSchedulingStrategy(
                    placement_group, placement_group_bundle_index=bundle)
            return o

        self.prefiller = PrefillReplica.options(**opts(0)).remote(
            cfg, params, max_len, self.channel, device)
        # each generate() holds a thread of the decode replica until its
        # completion: as many threads as slots keep every slot busy
        self.decoder = DecodeReplica.options(max_concurrency=slots, **opts(1)).remote(
            cfg, params, max_len, slots, page_size, self.channel.reader(0), device)
        self._ticket = 0

    def generate(self, tokens: Sequence[int],
                 sampling: Optional[SamplingParams] = None):
        """Returns a ref resolving to the sampled token list."""
        ticket = self._ticket
        self._ticket += 1
        meta = self.prefiller.prefill.remote(list(tokens))
        return self.decoder.generate.remote(list(tokens), meta, sampling,
                                            ticket=ticket)

    def stats(self) -> Dict[str, int]:
        return rt.get(self.decoder.stats.remote())

    def shutdown(self) -> None:
        try:
            rt.get(self.decoder.close.remote(), timeout=30)
        except Exception:  # noqa: BLE001 — the replica may be gone already
            pass
        for a in (self.prefiller, self.decoder):
            try:
                rt.kill(a)
            except Exception:  # noqa: BLE001
                pass
        try:
            self.channel.close()
        except Exception:  # noqa: BLE001
            pass
