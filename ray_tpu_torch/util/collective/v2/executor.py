"""Hierarchical collective executors (the v2 data plane) (copy of
ray_tpu/util/collective/v2/executor.py).

Composition (the hierarchical lesson of arXiv 2510.20171): every
algorithm is phrased as intra-host phases over the shm :class:`ShmArena`
composed with a cross-host phase over the object-path rendezvous —

allreduce::

    encode        every rank writes its (possibly quantized) tensor
                  into its arena slot                       [shm]
    reduce_local  local rank l reduces segment l across the host's
                  slots, straight out of shared memory      [shm]
    xh            counterpart groups (same local index, one rank per
                  host) exchange partial segments over RPC and reduce
                  across hosts                              [object path]
    publish       the final segment is published in the arena's
                  region                                    [shm]
    gather        every rank assembles the full result from the
                  region                                    [shm]

reducescatter stops after ``xh`` (each rank keeps only its own shard —
half the intra-host traffic of allreduce and no fan-back), allgather is
``encode`` + ``gather`` over the slots, broadcast writes one slot and
fans out (with a leader hop across hosts). On a single host the ``xh``
phase vanishes and every op is exactly the shm phases.

Overlap: for large segments the allreduce ``reduce_local`` +
``xh`` pair runs CHUNKED — the segment is cut into policy-agreed blocks
and block k's cross-host wire time hides behind block k+1's intra-host
reduction (publish one block, reduce the next, collect in order). The
wire format per block is the ordinary ``xh`` wire; only the key gains a
block suffix, so the barriered and overlapped paths reduce to the same
bytes in the same order (bit-identical for the exact codec).

Exactness: with the exact codec the reduction accumulates sequentially
in ascending rank order with the same dtype promotion rules as
``np.sum``/``np.mean`` over a stacked axis — on a SINGLE host this is
bit-identical to the v1 object/channel paths (asserted by tests).
Across hosts the per-host partials reassociate the float sum
((h0)+(h1) instead of fully sequential): results are deterministic and
identical on every rank, integer reductions stay bit-identical, floats
differ from the flat order only in the last ulp. With the int8 codec
the op obeys the error contract in :mod:`.quant`.

Elasticity: the executor addresses the group through its EFFECTIVE
coordinates (``_eff_rank``/``_eff_world`` — dense indices into the
current epoch's member tuple); the topology is built over the members,
so counterpart/leader math transparently spans degraded epochs. Every
arena wait goes through the group's ``_guarded_wait`` so a local peer
dying mid-phase raises a typed failure within the detection window
instead of a 120 s hang.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from ray_tpu_torch.observability import collective as obs_col
from ray_tpu_torch.util.collective.types import ReduceOp
from ray_tpu_torch.util.collective.v2 import policy as policy_mod
from ray_tpu_torch.util.collective.v2.quant import ExactCodec, Int8BlockCodec

_ACC_UFUNC = {
    ReduceOp.SUM: np.add,
    ReduceOp.MEAN: np.add,
    ReduceOp.PRODUCT: np.multiply,
    ReduceOp.MAX: np.maximum,
    ReduceOp.MIN: np.minimum,
}


def _chaos(op: str, phase: str) -> None:
    """Deterministic fault injection for the chaos tests: when
    ``RAY_TPU_COLLECTIVE_CHAOS_DIE`` names this phase (``"<phase>"`` or
    ``"<op>:<phase>"``), die the way a preempted worker dies — no
    cleanup, no exception, the process is simply gone. The tests stage
    the env var on exactly one rank."""
    want = os.environ.get("RAY_TPU_COLLECTIVE_CHAOS_DIE", "")
    if want and (want == phase or want == f"{op}:{phase}"):
        os._exit(1)


def acc_dtype(dtype, op: ReduceOp):
    """The accumulator/output dtype matching ``np.sum``/``np.prod``/
    ``np.mean`` over a stacked axis (the v1 reduction), so the exact
    path reproduces v1 results bit for bit — including the bool/int ->
    64-bit promotion that keeps int rings from overflowing."""
    dtype = np.dtype(dtype)
    if dtype.kind in "bui":
        if op in (ReduceOp.SUM, ReduceOp.PRODUCT):
            return np.dtype(np.uint64) if dtype.kind == "u" \
                else np.dtype(np.int64)
        if op == ReduceOp.MEAN:
            return np.dtype(np.float64)
    return dtype


def seg_bounds(nelems: int, parts: int, align: int = 1) -> List[int]:
    """parts+1 monotone offsets splitting ``nelems`` near-evenly, every
    interior boundary rounded down to a multiple of ``align`` (the
    quant codec needs block-aligned segment edges against the slot
    layout). Identical on every rank by construction."""
    out = []
    for i in range(parts + 1):
        b = (nelems * i) // parts
        if align > 1 and 0 < i < parts:
            b = (b // align) * align
        out.append(b)
    return out


def shard_bounds(shape: Tuple[int, ...], parts: int):
    """Flat element offsets + shard shapes matching
    ``np.array_split(arr, parts, axis=0)`` — the v1 reducescatter
    contract (shard values must be identical to v1's)."""
    if not shape:
        raise ValueError("reducescatter requires a tensor with ndim >= 1")
    rows = shape[0]
    row_elems = 1
    for d in shape[1:]:
        row_elems *= d
    base, rem = divmod(rows, parts)
    offs = [0]
    shapes = []
    for i in range(parts):
        r = base + (1 if i < rem else 0)
        offs.append(offs[-1] + r * row_elems)
        shapes.append((r,) + tuple(shape[1:]))
    return offs, shapes


class HierarchicalExecutor:
    """Stateless algorithm layer over one ObjStoreGroup's transports.

    The group provides: ``_eff_rank``/``_eff_world`` (dense coordinates
    in the current epoch), ``_topology`` (:class:`Topology`, built over
    the members), ``_policy2`` (:class:`GroupPolicy`),
    ``_ensure_arena(nbytes)`` (host-local :class:`ShmArena`, slots and
    region each >= nbytes), ``_sub_exchange(key, value, eff_ranks)`` /
    ``_sub_put``+``_sub_collect`` (object-path all-to-all among an
    effective-rank subset, sync or split for overlap),
    ``_scatter_exchange(key, per_dest, eff_ranks)`` (pairwise: each
    participant receives only what was addressed to it) and
    ``_guarded_wait(fn, op, phase, ranks)`` (deadline-budgeted,
    liveness-probing shm waits)."""

    def __init__(self, group):
        self._g = group

    # ------------------------------------------------------------------
    def _local_peer_globals(self) -> List[int]:
        """GLOBAL ranks of my host's other members — the suspect list
        for intra-host (arena) waits."""
        g = self._g
        topo = g._topology
        return [g._members[p] for p in topo.local_peers
                if p != g._eff_rank]

    def _begin(self, arena, op: str) -> None:
        g = self._g
        peers = self._local_peer_globals()
        g._guarded_wait(lambda t: arena.begin(timeout=t),
                        op, "arena_begin", ranks=peers)

    def _wait_wrote(self, arena, op: str, only: Optional[int] = None) -> None:
        g = self._g
        peers = self._local_peer_globals()
        g._guarded_wait(lambda t: arena.wait_wrote(timeout=t, only=only),
                        op, "encode", ranks=peers)

    def _wait_posted(self, arena, op: str) -> None:
        g = self._g
        peers = self._local_peer_globals()
        g._guarded_wait(lambda t: arena.wait_posted(timeout=t),
                        op, "publish", ranks=peers)

    # ------------------------------------------------------------------
    def _codecs(self, flat: np.ndarray, op: Optional[ReduceOp]):
        """(slot codec, final-segment codec, accumulator dtype, output
        dtype) for this op — all derived from group-agreed inputs.
        Int8 codecs are cached per (dtype, block) so their chunk
        scratch actually amortizes across ops."""
        g = self._g
        if op is not None:
            qc = policy_mod.quant_codec_for(
                flat.nbytes, flat.dtype, op, g._topology, g._policy2)
            if qc is not None:
                cache = getattr(self, "_qcache", None)
                if cache is None:
                    cache = self._qcache = {}
                qc = cache.setdefault((str(qc.dtype), qc.block), qc)
                return qc, qc, np.dtype(np.float32), flat.dtype
        out_dt = acc_dtype(flat.dtype, op) if op is not None else flat.dtype
        return (ExactCodec(flat.dtype), ExactCodec(out_dt), out_dt, out_dt)

    def _arena_for(self, slot_nbytes: int, region_nbytes: int):
        return self._g._ensure_arena(max(slot_nbytes, region_nbytes))

    @staticmethod
    def _reduce_slices(codec, slots, nelems, lo, hi, op: ReduceOp, adt,
                       own: Optional[int] = None,
                       own_data: Optional[np.ndarray] = None) -> np.ndarray:
        """Reduce elements [lo, hi) across slot wires, reading straight
        out of shared memory. Sequential ascending-rank accumulation —
        see :func:`acc_dtype` for why this matches v1 bit for bit.
        ``own``/``own_data``: the caller's own contribution comes from
        its local array instead of a shm round trip (same position in
        the accumulation order, so exact results are unchanged; for the
        int8 codec the own term skips one quantization — strictly
        *inside* the documented error bound)."""
        def term(i):
            if own is not None and i == own:
                seg = own_data[lo:hi]
                if isinstance(codec, Int8BlockCodec) \
                        and seg.dtype != np.float32:
                    seg = seg.astype(np.float32)
                return seg
            return codec.decode_slice(slots[i], nelems, lo, hi)

        if isinstance(codec, Int8BlockCodec):
            acc = np.empty(hi - lo, np.float32)
            first = term(0)
            np.copyto(acc, first)
            for i in range(1, len(slots)):
                if own is not None and i == own:
                    acc += term(i)
                else:
                    codec.decode_slice(slots[i], nelems, lo, hi,
                                       out=acc, add=True)
            return acc
        ufunc = _ACC_UFUNC[op]
        acc = term(0).astype(adt)
        for i in range(1, len(slots)):
            ufunc(acc, term(i), out=acc)
        return acc

    @staticmethod
    def _wire_of(codec, seg: np.ndarray) -> np.ndarray:
        """Encode a segment as a standalone message (cross-host wire)."""
        buf = np.empty(codec.wire_nbytes(seg.size), np.uint8)
        codec.encode_into(seg, memoryview(buf))
        return buf

    @staticmethod
    def _xh_accumulate(codec, wires_or_vals, nelems: int, op: ReduceOp,
                       adt) -> np.ndarray:
        """Reduce one cross-host exchange's payloads in sender (host)
        order — shared by the barriered and overlapped paths so both
        produce the same bytes."""
        if isinstance(codec, Int8BlockCodec):
            acc = codec.decode_slice(
                memoryview(wires_or_vals[0]), nelems, 0, nelems)
            for w in wires_or_vals[1:]:
                codec.decode_slice(memoryview(w), nelems, 0, nelems,
                                   out=acc, add=True)
            return acc
        ufunc = _ACC_UFUNC[op]
        acc = np.asarray(wires_or_vals[0]).astype(adt, copy=True)
        for v in wires_or_vals[1:]:
            ufunc(acc, np.asarray(v), out=acc)
        return acc

    def _xh_reduce(self, rec, opname: str, codec, seg: np.ndarray,
                   tag: str, op: ReduceOp, adt) -> np.ndarray:
        """Cross-host phase (barriered): allreduce ``seg`` within my
        counterpart group (same local index on every host) over the
        object path."""
        g = self._g
        topo = g._topology
        peers = topo.counterparts()
        with obs_col.phase_span(rec, opname, "xh", seg.nbytes):
            payload = self._wire_of(codec, seg) \
                if isinstance(codec, Int8BlockCodec) else seg
            vals = g._sub_exchange(f"xh_{tag}", payload, list(peers),
                                   op=opname, phase="xh")
            return self._xh_accumulate(codec, vals, seg.size, op, adt)

    def _xh_blocks(self, rec, opname: str, codec, nblk: int,
                   seg_nbytes: int) -> Optional[List[int]]:
        """Block grid for the overlapped reduce_local+xh pipeline, or
        None when the op stays barriered. Pure function of group-agreed
        inputs (policy knobs, segment size — identical across the
        counterpart group under a uniform topology), so every
        participant chunks identically."""
        g = self._g
        pol = g._policy2
        if not pol.overlap or seg_nbytes < pol.overlap_min_bytes \
                or seg_nbytes <= pol.overlap_block_bytes or nblk < 1:
            return None
        blocks = max(2, -(-seg_nbytes // pol.overlap_block_bytes))
        rec["overlap_blocks"] = blocks
        return seg_bounds(nblk, blocks, align=codec.block)

    # ------------------------------------------------------------------
    def allreduce(self, arr: np.ndarray, op: ReduceOp,
                  rec: Optional[dict] = None) -> np.ndarray:
        g = self._g
        topo = g._topology
        op = ReduceOp(op)
        rec = rec if rec is not None else {}
        flat = arr.reshape(-1)
        n = flat.size
        L = topo.local_world
        slot_codec, seg_codec, adt, out_dt = self._codecs(flat, op)
        rec["algo"], rec["codec"] = "hier", slot_codec.name
        rec["topology"] = topo.describe()
        bounds = seg_bounds(n, L, align=slot_codec.block)
        roffs = [0]
        for s in range(L):
            roffs.append(roffs[-1]
                         + seg_codec.wire_nbytes(bounds[s + 1] - bounds[s]))
        arena = self._arena_for(slot_codec.wire_nbytes(n), roffs[-1])
        lr = topo.local_rank
        lo, hi = bounds[lr], bounds[lr + 1]
        self._begin(arena, "allreduce")
        _chaos("allreduce", "encode")
        with obs_col.phase_span(rec, "allreduce", "encode", flat.nbytes):
            # own segment skips the shm round trip: this rank reduces it
            # straight from its local array, and no peer ever reads it
            mv = arena.slot(lr)
            slot_codec.encode_into(flat, mv, 0, lo)
            slot_codec.encode_into(flat, mv, hi, n)
            arena.mark_wrote()
            self._wait_wrote(arena, "allreduce")
        _chaos("allreduce", "reduce_local")
        slots = [arena.slot(r) for r in range(L)]
        overlapped = False
        if not topo.single_host and hi > lo:
            blk = self._xh_blocks(rec, "allreduce", seg_codec, hi - lo,
                                  (hi - lo) * flat.itemsize)
            if blk is not None:
                acc = self._overlapped_reduce_xh(
                    rec, slot_codec, seg_codec, slots, flat, n, lo, hi,
                    blk, lr, op, adt)
                overlapped = True
        if not overlapped:
            with obs_col.phase_span(rec, "allreduce", "reduce_local",
                                    (hi - lo) * flat.itemsize * L):
                acc = self._reduce_slices(slot_codec, slots, n, lo, hi,
                                          op, adt, own=lr, own_data=flat) \
                    if hi > lo else np.empty(0, adt)
            if not topo.single_host and hi > lo:
                _chaos("allreduce", "xh")
                acc = self._xh_reduce(rec, "allreduce", seg_codec, acc,
                                      f"ar{lr}", op, adt)
        with obs_col.phase_span(rec, "allreduce", "publish", acc.nbytes):
            if hi > lo:
                seg_codec.encode_into(
                    acc, arena.region()[roffs[lr]: roffs[lr + 1]])
            arena.mark_posted()
            self._wait_posted(arena, "allreduce")
        _chaos("allreduce", "gather")
        with obs_col.phase_span(rec, "allreduce", "gather", flat.nbytes):
            out = np.empty(n, out_dt)
            region = arena.region()
            lossy = isinstance(seg_codec, Int8BlockCodec)
            for s in range(L):
                slo, shi = bounds[s], bounds[s + 1]
                if shi <= slo:
                    continue
                if s == lr and not lossy:
                    # exact: the local accumulator IS the region bytes
                    out[slo:shi] = acc
                    continue
                # own segment included when lossy: every rank must see
                # the same post-roundtrip values, own rank included
                dec = seg_codec.decode_slice(
                    region[roffs[s]: roffs[s + 1]], shi - slo, 0, shi - slo)
                out[slo:shi] = dec  # casts quant f32 -> out dtype
            arena.mark_done()
        if op == ReduceOp.MEAN and isinstance(slot_codec, Int8BlockCodec):
            out = (out.astype(np.float32) / g._eff_world).astype(out_dt)
        elif op == ReduceOp.MEAN:
            out = out / g._eff_world  # true divide: matches np.mean
        return out.reshape(arr.shape)

    def _overlapped_reduce_xh(self, rec, slot_codec, seg_codec, slots,
                              flat, n, lo, hi, blk, lr, op: ReduceOp,
                              adt) -> np.ndarray:
        """Chunked reduce_local + xh pipeline: reduce block k locally,
        PUBLISH its wire (non-blocking put), move on to block k+1 —
        block k's cross-host transfer rides under k+1's reduction.
        Collection then accumulates in block order and host order, so
        the result is byte-identical to the barriered path (exact
        codec) / within the same quant bound (int8).

        The per-block wire is the ordinary xh wire over the block's
        elements; the key carries the block index, so counterpart
        groups (which chunk identically — the grid is a pure function
        of group-agreed inputs) rendezvous block by block."""
        g = self._g
        topo = g._topology
        peers = list(topo.counterparts())
        tag = f"ar{lr}"
        handles = []
        parts: List[np.ndarray] = []
        nblk = len(blk) - 1
        with obs_col.phase_span(rec, "allreduce", "reduce_local",
                                (hi - lo) * flat.itemsize * len(slots)):
            for k in range(nblk):
                blo, bhi = lo + blk[k], lo + blk[k + 1]
                if bhi <= blo:
                    parts.append(np.empty(0, adt))
                    handles.append(None)
                    continue
                part = self._reduce_slices(slot_codec, slots, n, blo, bhi,
                                           op, adt, own=lr, own_data=flat)
                parts.append(part)
                _chaos("allreduce", f"xh_chunk{k}")
                with obs_col.phase_span(rec, "allreduce", "xh", 0):
                    handles.append(g._sub_put(
                        f"xh_{tag}_b{k}",
                        self._wire_of(seg_codec, part)
                        if isinstance(seg_codec, Int8BlockCodec) else part,
                        peers, op="allreduce", phase="xh"))
        acc = np.empty(hi - lo, np.float32
                       if isinstance(seg_codec, Int8BlockCodec) else adt)
        with obs_col.phase_span(rec, "allreduce", "xh",
                                (hi - lo) * flat.itemsize):
            for k in range(nblk):
                if handles[k] is None:
                    continue
                vals = g._sub_collect(handles[k])
                blo, bhi = blk[k], blk[k + 1]
                acc[blo:bhi] = self._xh_accumulate(
                    seg_codec, vals, bhi - blo, op, adt)
        return acc

    # ------------------------------------------------------------------
    def reducescatter(self, arr: np.ndarray, op: ReduceOp,
                      rec: Optional[dict] = None) -> np.ndarray:
        """True reduce-scatter: each rank leaves with ONLY its shard
        (np.array_split axis-0 semantics, v1-identical values) — no
        full-tensor fan-back phase at all."""
        g = self._g
        topo = g._topology
        op = ReduceOp(op)
        rec = rec if rec is not None else {}
        flat = np.ascontiguousarray(arr).reshape(-1)
        n = flat.size
        me = g._eff_rank
        offs, shapes = shard_bounds(arr.shape, g._eff_world)
        codec = ExactCodec(flat.dtype)  # intra-host RS stays exact
        adt = acc_dtype(flat.dtype, op)
        rec["algo"], rec["codec"] = "hier", codec.name
        rec["topology"] = topo.describe()
        arena = self._arena_for(codec.wire_nbytes(n), 0)
        lr = topo.local_rank
        self._begin(arena, "reducescatter")
        _chaos("reducescatter", "encode")
        with obs_col.phase_span(rec, "reducescatter", "encode", flat.nbytes):
            # shards only THIS rank reduces (its counterpart set) skip
            # the shm round trip — their contribution comes from the
            # local array; everything other local ranks read is written
            mv = arena.slot(lr)
            mine_only = [me] if topo.single_host \
                else list(topo.counterparts())
            prev = 0
            for p in sorted(mine_only):
                codec.encode_into(flat, mv, prev, offs[p])
                prev = offs[p + 1]
            codec.encode_into(flat, mv, prev, n)
            arena.mark_wrote()
            self._wait_wrote(arena, "reducescatter")
        _chaos("reducescatter", "reduce_local")
        slots = [arena.slot(r) for r in range(topo.local_world)]

        def partial(rank: int) -> np.ndarray:
            lo, hi = offs[rank], offs[rank + 1]
            if hi <= lo:
                return np.empty(0, adt)
            return self._reduce_slices(codec, slots, n, lo, hi, op, adt,
                                       own=lr, own_data=flat)

        if topo.single_host:
            with obs_col.phase_span(
                    rec, "reducescatter", "reduce_local",
                    (offs[me + 1] - offs[me]) * flat.itemsize
                    * topo.local_world):
                acc = partial(me)
        else:
            peers = topo.counterparts()
            with obs_col.phase_span(rec, "reducescatter", "reduce_local",
                                    flat.nbytes):
                mine = {p: partial(p) for p in peers}
            _chaos("reducescatter", "xh")
            with obs_col.phase_span(
                    rec, "reducescatter", "xh",
                    (offs[me + 1] - offs[me]) * flat.itemsize):
                # pairwise scatter: each peer receives ONLY its shard
                vals = g._scatter_exchange(
                    f"xh_rs{topo.local_rank}",
                    {p: mine[p] for p in peers if p != me},
                    list(peers), op="reducescatter", phase="xh")
                acc = mine[me]
                ufunc = _ACC_UFUNC[op]
                for d in vals:
                    ufunc(acc, np.asarray(d), out=acc)
        arena.mark_posted()
        arena.mark_done()
        if op == ReduceOp.MEAN:
            acc = acc / g._eff_world
        return acc.reshape(shapes[me])

    # ------------------------------------------------------------------
    def allgather(self, arr: np.ndarray,
                  rec: Optional[dict] = None) -> List[np.ndarray]:
        """Single-host allgather over the arena slots (multi-host
        groups keep the object path — every byte crosses the wire
        either way, so hierarchy buys nothing there)."""
        g = self._g
        topo = g._topology
        rec = rec if rec is not None else {}
        flat = arr.reshape(-1)
        n = flat.size
        codec = ExactCodec(flat.dtype)
        rec["algo"], rec["codec"] = "hier", codec.name
        rec["topology"] = topo.describe()
        arena = self._arena_for(codec.wire_nbytes(n), 0)
        self._begin(arena, "allgather")
        _chaos("allgather", "encode")
        with obs_col.phase_span(rec, "allgather", "encode", flat.nbytes):
            codec.encode_into(flat, arena.slot(topo.local_rank))
            arena.mark_wrote()
            self._wait_wrote(arena, "allgather")
        _chaos("allgather", "gather")
        with obs_col.phase_span(rec, "allgather", "gather",
                                flat.nbytes * topo.local_world):
            parts: List[np.ndarray] = [None] * g._eff_world  # type: ignore
            for r in range(topo.local_world):
                rank = topo.local_peers[r]
                if rank == g._eff_rank:
                    parts[rank] = flat.copy().reshape(arr.shape)
                else:
                    parts[rank] = codec.decode_slice(
                        arena.slot(r), n, 0, n,
                        out=np.empty(n, flat.dtype)).reshape(arr.shape)
            arena.mark_posted()
            arena.mark_done()
        return parts

    # ------------------------------------------------------------------
    def broadcast(self, arr: np.ndarray, src_rank: int,
                  rec: Optional[dict] = None) -> np.ndarray:
        """``src_rank`` is an EFFECTIVE index (the caller maps the
        global source through the member tuple)."""
        g = self._g
        topo = g._topology
        rec = rec if rec is not None else {}
        flat = np.ascontiguousarray(arr).reshape(-1)
        n = flat.size
        me = g._eff_rank
        codec = ExactCodec(flat.dtype)
        rec["algo"], rec["codec"] = "hier", codec.name
        rec["topology"] = topo.describe()
        data = flat if me == src_rank else None
        if not topo.single_host:
            src_host = topo.keys[src_rank]
            ranks = sorted({src_rank} | {
                topo.leader(h) for h in topo.hosts if h != src_host})
            if me in ranks:
                _chaos("broadcast", "xh")
                with obs_col.phase_span(rec, "broadcast", "xh", flat.nbytes):
                    # src_rank is part of the key: each key's participant
                    # set must be FIXED, or broadcasts from different
                    # sources would desync the per-key sequence counters
                    vals = g._sub_exchange(
                        f"xh_bcast{src_rank}",
                        data if me == src_rank else None, ranks,
                        op="broadcast", phase="xh")
                    data = np.asarray(vals[ranks.index(src_rank)]).reshape(-1)
            local_src = src_rank if topo.my_host == src_host \
                else topo.leader(topo.my_host)
        else:
            local_src = src_rank
        lsrc = topo.local_peers.index(local_src)
        arena = self._arena_for(codec.wire_nbytes(n), 0)
        self._begin(arena, "broadcast")
        _chaos("broadcast", "encode")
        with obs_col.phase_span(rec, "broadcast", "encode", flat.nbytes):
            if topo.local_rank == lsrc:
                codec.encode_into(data, arena.slot(lsrc))
            arena.mark_wrote()
            self._wait_wrote(arena, "broadcast", only=lsrc)
        _chaos("broadcast", "gather")
        with obs_col.phase_span(rec, "broadcast", "gather", flat.nbytes):
            if topo.local_rank == lsrc:
                out = data.copy()
            else:
                out = codec.decode_slice(
                    arena.slot(lsrc), n, 0, n, out=np.empty(n, flat.dtype))
            arena.mark_posted()
            arena.mark_done()
        return out.reshape(arr.shape)
