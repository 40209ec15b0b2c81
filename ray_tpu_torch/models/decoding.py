"""Autoregressive decoding with a KV cache (PyTorch port of
ray_tpu/models/decoding.py).

- prefill: one forward over the whole right-padded prompt batch, writing
  K/V for every layer into a preallocated cache [L, B, max_len, kvH, D].
  Its attention runs the flash kernel over the call's own fresh K/V:
  a prefill starts from an empty cache at positions 0..S-1, so for every
  real query row that is the same function as attending to the cache
  under the length mask. Rows past a prompt's length differ, and are
  never read: only the logits at length-1 are used, and decode writes a
  slot before it attends and masks every slot above it.
- decode: one single-token step per emitted token; attention is the
  plain fp32 ``_attend_cached`` over the whole (masked) cache.
- sampling (greedy / temperature / top-k) happens on the device; only
  the emitted token ids cross back to the host.

Unlike the JAX package, the cache is updated IN PLACE (JAX returns a new
one): ``forward_cached`` writes into ``cache.k``/``cache.v`` and returns
the same cache object.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ray_tpu_torch import default_device
from ray_tpu_torch.models.transformer import (
    TransformerConfig, _layer, _logits, _mlp, _qkv, _rms_norm,
)
from ray_tpu_torch.ops.attention import (
    NEG_INF, flash_attention, flash_attention_fwd, merge_lse,
)


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor  # [L, B, max_len, kvH, D]
    v: torch.Tensor  # [L, B, max_len, kvH, D]
    lengths: torch.Tensor  # [B] int64 — tokens currently in cache per sequence


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               dtype=None, device=None) -> KVCache:
    device = default_device(device)
    dtype = dtype or cfg.dtype
    shape = (cfg.layers, batch, max_len, cfg.kv_heads, cfg.hd)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        lengths=torch.zeros((batch,), dtype=torch.int64, device=device),
    )


def _attend_cached(q, k_cache, v_cache, q_pos, kv_len_mask):
    """q [B,S,H,D] against the full cache [B,max_len,kvH,D], in fp32.

    kv_len_mask [B, max_len] marks valid cache slots; q_pos [B,S] are the
    global positions of the queries (causal: key position <= q position).
    Query head h reads KV head h // (H / kvH), as the JAX package's
    repeat does, without materializing the repeat.
    """
    b, s, h, d = q.shape
    t, kvh = k_cache.shape[1], k_cache.shape[2]
    qg = q.float().reshape(b, s, kvh, h // kvh, d)
    logits = torch.einsum("bsgrd,btgd->bgrst", qg, k_cache.float()) / (d ** 0.5)
    logits = logits.reshape(b, h, s, t)
    key_pos = torch.arange(t, device=q.device)[None, :]
    causal = q_pos[:, None, :, None] >= key_pos[:, None, None, :]
    mask = kv_len_mask[:, None, None, :] & causal
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).reshape(b, kvh, h // kvh, s, t)
    out = torch.einsum("bgrst,btgd->bsgrd", probs, v_cache.float())
    return out.reshape(b, s, h, d).to(q.dtype)


def _prefix_prefill_attention(q, k, v, k_prefix, v_prefix):
    """Queries at positions P.. over the P cached prefix keys and the
    call's own fresh keys, as two flash kernel calls merged by
    log-sum-exp: the kernel's causal mask is top-left aligned (key <=
    query index), so one causal call over the whole row would hide the
    prefix from the first queries. The prefix is wholly visible
    (``causal=False``); the fresh keys are the causal diagonal."""
    o_pre, lse_pre = flash_attention_fwd(q, k_prefix, v_prefix, causal=False)
    o_new, lse_new = flash_attention_fwd(q, k, v, causal=True)
    return merge_lse(o_pre, lse_pre, o_new, lse_new)[0].to(q.dtype)


def _block_cached(cfg: TransformerConfig, x, p, lora, positions,
                  k_cache, v_cache, kv_len_mask, prefill: bool = False,
                  prefix_len: int = 0):
    """One decoder block against cached K/V; writes this call's K/V into
    ``k_cache``/``v_cache`` ([B, max_len, kvH, D] views) in place. A
    prefill with ``prefix_len`` > 0 continues a row whose first
    ``prefix_len`` slots already hold K/V (a reused prefix)."""
    if cfg.num_experts:
        raise NotImplementedError(
            "the cached (serving) path is dense-only: the JAX package's "
            "_block_cached (ray_tpu/models/decoding.py:113-118) runs no "
            "mixture of experts, so MoE serving is not a port item")
    b = x.shape[0]
    y = _rms_norm(x, p["ln_attn"], cfg.norm_eps)
    q, k, v = _qkv(cfg, y, p, lora, positions)

    # Positions past the cache are clamped to its last slot. Only rows
    # that are never read again get there: a sequence whose cache is full
    # has stopped, and a free continuous-batching slot is overwritten
    # whole when the next request is installed. (JAX drops such writes.)
    bidx = torch.arange(b, device=x.device)[:, None]
    slots = positions.clamp(max=k_cache.shape[1] - 1)
    k_cache[bidx, slots] = k.to(k_cache.dtype)
    v_cache[bidx, slots] = v.to(v_cache.dtype)
    if prefill and prefix_len:
        attn = _prefix_prefill_attention(q, k, v, k_cache[:, :prefix_len],
                                         v_cache[:, :prefix_len])
    elif prefill:
        attn = flash_attention(q, k, v, causal=True)
    else:
        attn = _attend_cached(q, k_cache, v_cache, positions, kv_len_mask)
    x = x + torch.einsum("bsnd,ndh->bsh", attn, p["wo"].to(attn.dtype))
    return _mlp(cfg, x, p, lora)


def forward_cached(cfg: TransformerConfig, params, tokens, positions,
                   cache: KVCache, kv_len_mask, prefill: bool = False,
                   prefix_len: int = 0):
    """Forward [B,S] tokens through all layers, writing the cache in place.

    ``prefill=True`` says the cache holds nothing at or past
    ``prefix_len`` and ``positions`` are prefix_len..prefix_len+S-1:
    attention then runs the flash kernel over the fresh K/V, and with
    ``prefix_len`` > 0 a second call over the cached prefix, merged.
    Returns (logits [B,S,V], cache) — the same cache object, updated.
    """
    x = params["embed"].to(cfg.dtype)[tokens]
    for i in range(cfg.layers):
        lp, lo = _layer(params, i)
        x = _block_cached(cfg, x, lp, lo, positions, cache.k[i], cache.v[i],
                          kv_len_mask, prefill=prefill, prefix_len=prefix_len)
    return _logits(cfg, params, x), cache


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Reference surface: vLLM SamplingParams (the subset that matters)."""

    max_tokens: int = 64
    temperature: float = 0.0  # 0 = greedy
    top_k: int = 0  # 0 = no top-k filter
    stop_token_id: Optional[int] = None


def _gumbel_argmax(logits, generator: torch.Generator):
    """One categorical draw per row of ``logits`` [B,V] (Gumbel-max)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    g = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return torch.argmax(logits + g, dim=-1)


def _sample(logits, generator: torch.Generator, temperature: float, top_k: int):
    """logits [B,V] → token ids [B] (int64)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / temperature
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, NEG_INF, logits)
    return _gumbel_argmax(logits, generator)


class Generator:
    """Prefill + decode loop over one parameter set on one device."""

    def __init__(self, cfg: TransformerConfig, params, max_len: int = 512,
                 device=None):
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.device = default_device(device)

    def _prefill(self, tokens, lengths, cache: KVCache):
        b, s = tokens.shape
        positions = torch.arange(s, device=self.device)[None, :].repeat(b, 1)
        logits, cache = forward_cached(
            self.cfg, self.params, tokens, positions, cache, None, prefill=True)
        cache.lengths.copy_(lengths)
        # logits at each prompt's LAST real token
        return logits[torch.arange(b, device=self.device), lengths - 1]

    def _decode(self, tok, cache: KVCache, generator, temperature, top_k):
        positions = cache.lengths[:, None]  # next slot per sequence
        kv_mask = torch.arange(self.max_len, device=self.device)[None, :] \
            <= cache.lengths[:, None]
        logits, cache = forward_cached(
            self.cfg, self.params, tok[:, None], positions, cache, kv_mask)
        cache.lengths += 1
        return _sample(logits[:, 0], generator, temperature, top_k)

    def _start(self, prompts, sampling: SamplingParams, seed: int):
        """Prefill ``prompts``; returns (first tokens, cache, generator)."""
        b = len(prompts)
        lens = np.array([len(p) for p in prompts], np.int64)
        if int(lens.max()) >= self.max_len:
            # without this check an over-long prompt would index past the
            # cache (the JAX package drops such writes silently)
            raise ValueError(
                f"prompt length {int(lens.max())} >= max_len {self.max_len}; "
                f"raise Generator(max_len=...)")
        toks = np.zeros((b, int(lens.max())), np.int64)
        for i, p in enumerate(prompts):
            toks[i, : len(p)] = p
        cache = init_cache(self.cfg, b, self.max_len, device=self.device)
        last_logits = self._prefill(
            torch.from_numpy(toks).to(self.device),
            torch.from_numpy(lens).to(self.device), cache)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        tok = _sample(last_logits, gen, sampling.temperature, sampling.top_k)
        return tok, cache, gen

    @torch.no_grad()
    def generate(self, prompts, sampling: Optional[SamplingParams] = None,
                 seed: int = 0):
        """prompts: list of token-id lists → list of completions
        (token-id lists, stop token excluded)."""
        sampling = sampling or SamplingParams()
        b = len(prompts)
        tok, cache, gen = self._start(prompts, sampling, seed)
        outs = [[] for _ in range(b)]
        done = np.zeros(b, bool)
        for _ in range(sampling.max_tokens):
            tok_np = tok.cpu().numpy()
            for i in range(b):
                if not done[i]:
                    if sampling.stop_token_id is not None and \
                            int(tok_np[i]) == sampling.stop_token_id:
                        done[i] = True
                    else:
                        outs[i].append(int(tok_np[i]))
            # a sequence whose next KV slot is out of room stops alone —
            # cache rows are per-sequence, so others keep decoding
            lens_np = cache.lengths.cpu().numpy()
            for i in range(b):
                if not done[i] and lens_np[i] >= self.max_len:
                    done[i] = True
            if done.all():
                break
            tok = self._decode(tok, cache, gen, sampling.temperature,
                               sampling.top_k)
        return outs

    def generate_stream(self, prompt, sampling: Optional[SamplingParams] = None,
                        seed: int = 0):
        """Single-prompt streaming: yields one token id at a time."""
        sampling = sampling or SamplingParams()
        prompt = list(prompt) or [0]
        with torch.no_grad():
            tok, cache, gen = self._start([prompt], sampling, seed)
        for _ in range(sampling.max_tokens):
            t = int(tok[0])
            if sampling.stop_token_id is not None and \
                    t == sampling.stop_token_id:
                return
            yield t
            if int(cache.lengths[0]) >= self.max_len:
                return
            with torch.no_grad():
                tok = self._decode(tok, cache, gen, sampling.temperature,
                                   sampling.top_k)
