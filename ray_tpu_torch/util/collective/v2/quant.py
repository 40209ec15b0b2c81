"""Wire codecs for the v2 collective stack (copy of
ray_tpu/util/collective/v2/quant.py).

Two codecs share one interface — a *wire format* for a flat tensor of
``nelems`` elements:

- :class:`ExactCodec` — raw array bytes, lossless.
- :class:`Int8BlockCodec` — block-scaled int8 with dynamic per-block
  scaling (EQuARX, arXiv 2506.17615): the message is cut into blocks of
  ``block`` elements; each block stores one f32 scale = amax/127 and
  its elements as ``rint(x/scale)`` in int8. 4x fewer wire bytes for
  f32 at ~0.4% of block dynamic range per quantization step.

Wire layout (int8): ``[nblocks x f32 scale][nelems x int8]`` — scales
first so the f32 region starts 4-byte aligned at offset 0.

Error contract (documented here, enforced by tests):

One quantize→dequantize round trip moves each element by at most
``scale_b/2 = amax_b/254`` (its block's dynamic range over 254), except
blocks whose amax is below the denormal floor ``127 * f32_tiny``, which
quantize to exact zero (error <= amax_b <= the floor). A quantized
allreduce of N contributions performs

    step 1: quantize every rank's input           (errors add across ranks)
    step 2: re-quantize the reduced segment for the intra-host fan-back
    step 3: (multi-host only) re-quantize the cross-host wire

so the per-element error against the exact sum is bounded by

    |err| <= 1.01 * steps * sum_i amax_b(rank_i) / 254  +  steps * floor

with steps = 2 on one host and 3 across hosts (the 1.01 covers the
second-order term from re-quantizing an already-perturbed sum).
:func:`sum_error_bound` computes exactly this bound from the raw
inputs; the accuracy tests assert against it element-wise, including
adversarial outlier / denormal / all-zero blocks. For benign
distributions the error is far smaller — ``QUANT_RTOL`` (2% of the
reduced value) is the headline tolerance documented in the README.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

QUANT_RTOL = 0.02
QUANT_STEPS_SINGLE_HOST = 2
QUANT_STEPS_MULTI_HOST = 3
DEFAULT_BLOCK = 512
# blocks quieter than this quantize to exact zero (scale division by a
# subnormal would be both slow and inaccurate)
_F32_TINY = float(np.finfo(np.float32).tiny)
ZERO_FLOOR = 127.0 * _F32_TINY

# elements per encode/decode chunk: keeps the f32 temporaries ~L2-sized
# so quantization costs ~1 streaming pass over the input, not 4
_CHUNK_ELEMS = 1 << 16


class ExactCodec:
    """Raw bytes on the wire; lossless, any dtype."""

    name = "exact"
    lossy = False
    block = 1

    def __init__(self, dtype):
        self.dtype = np.dtype(dtype)

    def wire_nbytes(self, nelems: int) -> int:
        return int(nelems) * self.dtype.itemsize

    def encode_into(self, flat: np.ndarray, mv: memoryview,
                    lo: int = 0, hi: Optional[int] = None) -> None:
        """Write elements [lo, hi) of ``flat`` into their place in the
        wire buffer (default: all of it)."""
        hi = flat.size if hi is None else hi
        dst = np.frombuffer(mv, self.dtype, hi - lo,
                            offset=lo * self.dtype.itemsize)
        np.copyto(dst, flat[lo:hi])

    def decode_slice(self, mv: memoryview, nelems: int, lo: int, hi: int,
                     out: Optional[np.ndarray] = None) -> np.ndarray:
        """Elements [lo, hi) as an ndarray. Without ``out`` this is a
        zero-copy VIEW of the wire buffer (valid only while the buffer
        is); with ``out`` the slice is copied there."""
        src = np.frombuffer(mv, self.dtype, hi - lo,
                            offset=lo * self.dtype.itemsize)
        if out is None:
            return src
        np.copyto(out, src)
        return out


class Int8BlockCodec:
    """Block-scaled int8 (see module docstring for the wire layout and
    error contract). Encode accepts any float dtype; decode returns
    float32 (the scale dtype) — callers cast at the boundary."""

    name = "int8"
    lossy = True

    def __init__(self, dtype, block: int = DEFAULT_BLOCK):
        self.dtype = np.dtype(dtype)
        if self.dtype.kind != "f":
            raise ValueError(f"int8 codec requires a float dtype, "
                             f"got {self.dtype}")
        self.block = max(16, int(block))

    def nblocks(self, nelems: int) -> int:
        return -(-int(nelems) // self.block)

    def wire_nbytes(self, nelems: int) -> int:
        return 4 * self.nblocks(nelems) + int(nelems)

    def _views(self, mv: memoryview, nelems: int):
        nb = self.nblocks(nelems)
        scales = np.frombuffer(mv, np.float32, nb)
        q = np.frombuffer(mv, np.int8, nelems, offset=4 * nb)
        return scales, q

    def _scratch(self, chunk: int):
        # per-instance scratch keeps the encode/decode temporaries
        # cache-resident AND allocation-free in the per-op hot loop
        sc = getattr(self, "_sc", None)
        if sc is None or sc[0].size < chunk:
            mb = chunk // self.block
            sc = (np.empty(chunk, np.float32), np.empty(chunk, np.float32),
                  np.empty(mb, np.float32), np.empty(mb, np.float32))
            self._sc = sc
        return sc

    def encode_into(self, flat: np.ndarray, mv: memoryview,
                    lo: int = 0, hi: Optional[int] = None) -> None:
        """Quantize elements [lo, hi) of ``flat`` into their place in
        the wire layout (``lo`` block-aligned; default: the whole
        message). No clip pass is needed: ``|x * (127/amax)| <= 127``
        holds by construction and ``rint`` leaves exact integers, so
        the final cast-assign into the int8 wire is lossless."""
        n = flat.size
        B = self.block
        lo0, hi0 = int(lo), n if hi is None else int(hi)
        if lo0 >= hi0:
            return
        assert lo0 % B == 0, "encode_into lo must be block-aligned"
        scales, q = self._views(mv, n)
        chunk = max(B, (_CHUNK_ELEMS // B) * B)
        staged, absbuf, amax, recip = self._scratch(chunk)
        for clo in range(lo0, hi0, chunk):
            chi = min(hi0, clo + chunk)
            m = chi - clo
            mb = -(-m // B)
            mpad = mb * B
            # ONE streaming read of the source per chunk: stage into the
            # cache-resident scratch (handles dtype cast + tail padding),
            # then every further pass is L2-local
            sc = staged[:mpad]
            sc[:m] = flat[clo:chi]
            if mpad != m:
                sc[m:] = 0.0
            sc2 = sc.reshape(mb, B)
            ab = absbuf[:mpad].reshape(mb, B)
            np.abs(sc2, out=ab)
            ab.max(axis=1, out=amax[:mb])
            with np.errstate(divide="ignore", over="ignore",
                             invalid="ignore"):
                # quiet/zero blocks produce inf here; masked right below
                np.divide(np.float32(127.0), amax[:mb], out=recip[:mb])
            quiet = amax[:mb] < ZERO_FLOOR
            np.multiply(amax[:mb], np.float32(1.0 / 127.0), out=amax[:mb])
            if quiet.any():
                recip[:mb][quiet] = 0.0  # quiet blocks -> exact zero
                amax[:mb][quiet] = 0.0
            bad = ~np.isfinite(amax[:mb])
            if bad.any():
                # a block containing inf/NaN cannot be scaled: poison
                # the WHOLE block with NaN (scale=NaN, q=0) so overflow
                # surfaces loudly on every rank instead of quantizing
                # to garbage ints — block granularity is inherent here,
                # where the exact path would flag only the element
                recip[:mb][bad] = 0.0
                amax[:mb][bad] = np.nan
            scales[clo // B: clo // B + mb] = amax[:mb]
            with np.errstate(invalid="ignore"):
                # inf*0 at poisoned positions is expected, not an error
                np.multiply(sc2, recip[:mb, None], out=sc2)
            if bad.any():
                # inf*0/NaN*0 left NaN at the non-finite positions;
                # zero them so the int8 cast below stays defined (the
                # NaN scale already poisons these blocks on decode)
                np.nan_to_num(sc, copy=False, nan=0.0,
                              posinf=0.0, neginf=0.0)
            np.rint(sc, out=sc)
            q[clo:chi] = sc[:m]  # cast-assign f32 -> int8 (exact ints)

    def decode_slice(self, mv: memoryview, nelems: int, lo: int, hi: int,
                     out: Optional[np.ndarray] = None,
                     add: bool = False) -> np.ndarray:
        """Dequantize elements [lo, hi) (``lo`` must sit on a block
        boundary) into a float32 array; ``add=True`` accumulates into
        ``out`` instead of overwriting. With ``out`` given the loop is
        chunked through cache-resident scratch — ~2 streaming passes."""
        B = self.block
        assert lo % B == 0, "decode_slice lo must be block-aligned"
        scales, q = self._views(mv, nelems)
        m = hi - lo
        if out is None:
            out = np.empty(m, np.float32)
            add = False
        chunk = max(B, (_CHUNK_ELEMS // B) * B)
        scaled = self._scratch(chunk)[0]
        for clo in range(lo, hi, chunk):
            chi = min(hi, clo + chunk)
            cm = chi - clo
            mb = -(-cm // B)
            full = cm // B
            sblk = scales[clo // B: (chi + B - 1) // B]
            dst = out[clo - lo: chi - lo]
            if add:
                buf = scaled[:cm]
            else:
                buf = dst
            buf[:] = q[clo:chi]  # cast-assign int8 -> f32
            if full:
                buf[: full * B].reshape(full, B)[:] *= sblk[:full, None]
            if cm % B:
                buf[full * B:] *= sblk[full]
            if add:
                dst += buf
        return out


# ---------------------------------------------------------------------------
# Error-bound helpers (the testable half of the accuracy contract)
# ---------------------------------------------------------------------------
def block_amax(flat: np.ndarray, block: int) -> np.ndarray:
    """Per-block max-magnitude of a flat array (last block zero-padded)."""
    n = flat.size
    nb = -(-n // block)
    x = np.abs(np.asarray(flat, np.float64).reshape(-1))
    if n % block:
        x = np.concatenate([x, np.zeros(nb * block - n)])
    return x.reshape(nb, block).max(axis=1)


def sum_error_bound(parts, block: int,
                    steps: int = QUANT_STEPS_SINGLE_HOST) -> np.ndarray:
    """Per-ELEMENT absolute error bound for a block-quantized sum of
    ``parts`` (the module docstring's formula, broadcast per element)."""
    n = int(np.asarray(parts[0]).size)
    per_block = np.zeros(-(-n // block))
    for p in parts:
        per_block += block_amax(np.asarray(p).reshape(-1), block)
    bound = 1.01 * steps * per_block / 254.0 + steps * ZERO_FLOOR
    return np.repeat(bound, block)[:n]
