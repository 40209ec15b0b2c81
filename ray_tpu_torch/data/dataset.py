"""Dataset — lazy, block-based data plane (PyTorch port of
ray_tpu/data/dataset.py).

Reference: python/ray/data/dataset.py:202 (`Dataset`), lazy logical plan
(_internal/logical/), streaming execution (streaming_executor.py:100).

Design here: a Dataset is (source block refs, chain of logical ops).
Consecutive per-block ops FUSE into one function per block (the
reference planner's map-fusion); all-to-all ops (repartition, shuffle,
sort, groupby) are barriers. Blocks are dicts of numpy arrays in the
object store. The port runs the plan in the calling process, as the JAX
package does in local mode, under a cluster too; the streaming executor
over remote tasks is ROADMAP.md Queue A item 11.
`iter_torch_batches` feeds the train step on the card.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

import torch

import ray_tpu_torch
from ray_tpu_torch import default_device
from ray_tpu_torch.data.block import (
    Block,
    block_concat,
    block_from_rows,
    block_num_rows,
    block_size_bytes,
    block_slice,
    block_take,
    block_to_rows,
    normalize_batch,
    to_batch_format,
)
from ray_tpu_torch.data._internal.executor import Executor


# ---------------------------------------------------------------------------
# Logical ops
# ---------------------------------------------------------------------------
class _Op:
    pass


class _MapBlocks(_Op):
    """Per-block transform (map/map_batches/filter/flat_map fuse here)."""

    def __init__(self, fn: Callable[[Block], Block], name: str):
        self.fn = fn
        self.name = name


class _ActorMapBlocks(_Op):
    """Stateful per-block transform (reference: map_operator.py:196 actor
    pool — ``compute`` with a callable class): ``cls()`` is constructed
    once a run of the plan, ``wrapper(instance, block)`` applies it to
    each block. Never fuses with neighbors."""

    def __init__(self, cls: type, wrapper: Callable, name: str):
        self.cls = cls
        self.wrapper = wrapper
        self.name = name


class _Shuffle(_Op):
    """All-to-all op as a distributed two-stage shuffle: ``partition_fn``
    splits each block into k parts (map tasks), ``reduce_fn`` merges part
    j of every block (reduce tasks). ``prepare`` may inspect the input
    refs first (e.g. sort boundary sampling) and returns the actual
    partition fn. Blocks never materialize on the driver (reference:
    _internal/planner/{sort,random_shuffle}.py)."""

    def __init__(self, partition_fn, reduce_fn, name: str,
                 num_outputs: Optional[int] = None, prepare=None):
        self.partition_fn = partition_fn
        self.reduce_fn = reduce_fn
        self.num_outputs = num_outputs
        self.prepare = prepare
        self.name = name


class _Limit(_Op):
    def __init__(self, n: int):
        self.n = n


class Dataset:
    """Lazy distributed dataset (reference: data/dataset.py:202)."""

    def __init__(self, block_refs: List[Any], ops: Optional[List[_Op]] = None):
        self._source_refs = list(block_refs)
        self._ops: List[_Op] = list(ops or [])
        self._executor = Executor()

    # -- plan building ------------------------------------------------
    def _with(self, op: _Op) -> "Dataset":
        return Dataset(self._source_refs, self._ops + [op])

    def map_batches(
        self,
        fn: Callable,
        *,
        batch_format: Optional[str] = None,
        batch_size: Optional[int] = None,
        fn_kwargs: Optional[Dict] = None,
        concurrency: Optional[Union[int, Tuple[int, int]]] = None,
        **_ignored,
    ) -> "Dataset":
        """Apply fn to batches (reference: dataset.py:531). With
        batch_size=None the whole block is one batch (fastest on TPU —
        blocks are already sized for the store).

        ``fn`` may be a callable CLASS (reference: actor compute
        strategy): it is constructed once and reused across blocks.
        ``concurrency`` (an int, or the reference's (min, max)) sizes the
        JAX package's actor pool or task budget; the plan runs in
        process here, so it is accepted and changes nothing."""
        kw = fn_kwargs or {}

        def _call_batches(call, block: Block) -> Block:
            if not block_num_rows(block):
                return block
            if batch_size is None:
                return normalize_batch(call(to_batch_format(block, batch_format), **kw))
            outs = []
            n = block_num_rows(block)
            for s in range(0, n, batch_size):
                piece = block_slice(block, s, min(s + batch_size, n))
                outs.append(normalize_batch(call(to_batch_format(piece, batch_format), **kw)))
            return block_concat(outs)

        name = f"MapBatches({getattr(fn, '__name__', 'fn')})"
        if isinstance(fn, type):
            return self._with(_ActorMapBlocks(fn, _call_batches, name))

        def _apply(block: Block) -> Block:
            return _call_batches(fn, block)

        return self._with(_MapBlocks(_apply, name))

    def map(self, fn: Callable) -> "Dataset":
        def _apply(block: Block) -> Block:
            return block_from_rows([fn(r) for r in block_to_rows(block)])

        return self._with(_MapBlocks(_apply, "Map"))

    def flat_map(self, fn: Callable) -> "Dataset":
        def _apply(block: Block) -> Block:
            out = []
            for r in block_to_rows(block):
                out.extend(fn(r))
            return block_from_rows(out)

        return self._with(_MapBlocks(_apply, "FlatMap"))

    def filter(self, fn: Callable) -> "Dataset":
        def _apply(block: Block) -> Block:
            return block_from_rows([r for r in block_to_rows(block) if fn(r)])

        return self._with(_MapBlocks(_apply, "Filter"))

    def select_columns(self, cols: List[str]) -> "Dataset":
        return self._with(_MapBlocks(lambda b: {k: b[k] for k in cols}, "Select"))

    def drop_columns(self, cols: List[str]) -> "Dataset":
        return self._with(
            _MapBlocks(lambda b: {k: v for k, v in b.items() if k not in cols}, "Drop")
        )

    def add_column(self, name: str, fn: Callable[[Block], np.ndarray]) -> "Dataset":
        def _apply(block: Block) -> Block:
            out = dict(block)
            out[name] = np.asarray(fn(block))
            return out

        return self._with(_MapBlocks(_apply, f"AddColumn({name})"))

    def limit(self, n: int) -> "Dataset":
        return self._with(_Limit(n))

    # -- all-to-all (distributed two-stage shuffles) -------------------
    def repartition(self, num_blocks: int) -> "Dataset":
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")

        def _part(block: Block, k: int, idx: int) -> List[Block]:
            n = block_num_rows(block)
            return [block_take(block, i) for i in np.array_split(np.arange(n), k)]

        return self._with(_Shuffle(
            _part, block_concat, f"Repartition({num_blocks})",
            num_outputs=num_blocks,
        ))

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        def _part(block: Block, k: int, idx: int) -> List[Block]:
            n = block_num_rows(block)
            # per-BLOCK-INDEX rng: every block must draw a different
            # assignment stream or same-offset rows stay co-located
            rng = np.random.RandomState(
                None if seed is None else (seed * 1_000_003 + idx) % (2**31)
            )
            assign = rng.randint(0, k, size=n)
            return [block_take(block, np.where(assign == j)[0]) for j in range(k)]

        def _reduce(parts: List[Block]) -> Block:
            merged = block_concat(parts)
            n = block_num_rows(merged)
            if not n:
                return merged
            rng = np.random.RandomState(seed)
            return block_take(merged, rng.permutation(n))

        return self._with(_Shuffle(_part, _reduce, "RandomShuffle"))

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        def _prepare(refs: List[Any]) -> Callable:
            # sample keys from each block to pick range boundaries
            # (reference: sample-based sort partitioning, planner/sort.py)
            def _sample(block: Block) -> Block:
                vals = block.get(key)
                if vals is None or not len(vals):
                    return {}
                idx = np.linspace(0, len(vals) - 1, min(64, len(vals))).astype(int)
                return {"s": np.asarray(vals)[idx]}

            samp_refs = list(self._executor.map_refs(_sample, iter(refs)))
            sample_arrays = [
                s["s"] for s in (ray_tpu_torch.get(r) for r in samp_refs) if s
            ]
            samples = np.concatenate(sample_arrays) if sample_arrays else np.array([])
            # boundaries once here, not per map task; evenly-spaced order
            # statistics (not np.quantile) so string keys sort too
            k_out = max(1, len(refs))
            if len(samples):
                ss = np.sort(samples)
                cut = np.linspace(0, len(ss) - 1, k_out + 1).astype(int)[1:-1]
                bounds = ss[cut]
            else:
                bounds = samples

            def _part(block: Block, k: int, idx: int) -> List[Block]:
                if not block_num_rows(block):
                    return [block] * k
                assign = np.searchsorted(bounds, block[key], side="right")
                if descending:
                    assign = (k - 1) - assign  # reversed range order
                return [block_take(block, np.where(assign == j)[0]) for j in range(k)]

            return _part

        def _reduce(parts: List[Block]) -> Block:
            merged = block_concat(parts)
            if not block_num_rows(merged):
                return merged
            order = np.argsort(merged[key], kind="stable")
            if descending:
                order = order[::-1]
            return block_take(merged, order)

        return self._with(_Shuffle(None, _reduce, f"Sort({key})", prepare=_prepare))

    def groupby(self, key: str) -> "GroupedData":
        return GroupedData(self, key)

    def join(self, other: "Dataset", on: str, how: str = "inner",
             num_partitions: Optional[int] = None) -> "Dataset":
        """Distributed hash join (reference: data/_internal joins via
        hash shuffle; data/dataset.py Dataset.join). Both sides
        hash-partition on the key (map tasks), matching partitions join
        pairwise (one task per bucket) — no driver materialization of
        either table."""
        if how not in ("inner", "left", "outer"):
            raise ValueError(f"unsupported join how={how!r}")
        # the tasks import pandas on the runtime's threads; a first import
        # on several threads at once can fail with a _DeadlockError, so
        # the caller imports it first
        import pandas.util  # noqa: F401

        left_refs = list(self._iter_output_refs())
        right_refs = list(other._iter_output_refs())
        k = num_partitions or max(len(left_refs), len(right_refs), 1)

        @ray_tpu_torch.remote(num_returns=k)
        def _part(block: Block, key: str, k: int):
            n = block_num_rows(block)
            if not n:
                # keep the SCHEMA even with zero rows: a bucket whose
                # side is empty must still know that side's columns, or
                # a left/outer join there drops them instead of NaN-ing
                parts = [{c: v[:0] for c, v in block.items()}
                         for _ in range(k)]
            else:
                from pandas.util import hash_array

                vals = np.asarray(block[key])
                # canonicalize BEFORE hashing: both sides of the join
                # must bucket equal keys identically even when their
                # dtypes differ (int64 5 joining float64 5.0 — common
                # after parquet/CSV ingestion)
                if vals.dtype.kind in "iufb":
                    vals = vals.astype(np.float64)
                assign = (hash_array(vals) % k).astype(np.int64)
                parts = [block_take(block, np.where(assign == j)[0])
                         for j in range(k)]
            return parts if k > 1 else parts[0]

        @ray_tpu_torch.remote
        def _join_bucket(key: str, how: str, n_left: int, *parts):
            import pandas as pd

            def side_df(side):
                data = block_concat(
                    [p for p in side if block_num_rows(p)])
                return pd.DataFrame(data) if data \
                    else pd.DataFrame({key: []})

            lefts, rights = parts[:n_left], parts[n_left:]
            if not any(block_num_rows(p) for p in parts):
                return {}
            merged = side_df(lefts).merge(side_df(rights), on=key,
                                          how=how, suffixes=("", "_right"))
            # a bucket whose side had ZERO rows lost that side's columns
            # in the merge — every part still carries its schema (see
            # _part's zero-row slices), so restore them as NaN to keep
            # bucket schemas consistent
            for p in parts:
                for c in p:
                    if c not in merged.columns:
                        merged[c] = np.nan
            return {c: merged[c].to_numpy() for c in merged.columns}

        left_parts = [_part.remote(r, on, k) for r in left_refs]
        right_parts = [_part.remote(r, on, k) for r in right_refs]
        if k == 1:
            left_parts = [[p] for p in left_parts]
            right_parts = [[p] for p in right_parts]
        out_refs = []
        for j in np.arange(k):
            bucket_left = [ps[j] for ps in left_parts]
            bucket_right = [ps[j] for ps in right_parts]
            out_refs.append(_join_bucket.remote(
                on, how, len(bucket_left), *bucket_left, *bucket_right))
        return Dataset(out_refs)

    def union(self, *others: "Dataset") -> "Dataset":
        refs = list(self._iter_output_refs())
        for o in others:
            refs.extend(o._iter_output_refs())
        return Dataset(refs)

    def zip(self, other: "Dataset") -> "Dataset":
        a = self.materialize_block()
        b = other.materialize_block()
        merged = dict(a)
        for k, v in b.items():
            merged[k if k not in merged else f"{k}_1"] = v
        return Dataset([ray_tpu_torch.put(merged)])

    # -- execution -----------------------------------------------------
    def _iter_output_refs(self) -> Iterator[Any]:
        """Execute the plan, yielding output block refs streamingly.

        Consecutive _MapBlocks fuse into one function per block; runs of
        map stages (fused chains + actor-class stages) run in process,
        block after block (the JAX package's local mode; its STREAMING
        executor, reference streaming_executor.py:100, is ROADMAP.md
        Queue A item 11). Shuffles are barriers between segments."""
        refs: Iterator[Any] = iter(self._source_refs)
        i = 0
        ops = self._ops
        while i < len(ops):
            op = ops[i]
            if isinstance(op, (_MapBlocks, _ActorMapBlocks)):
                # collect the maximal run of map-like stages into one
                # segment
                phys: List[Any] = []
                j = i
                while j < len(ops):
                    if isinstance(ops[j], _MapBlocks):
                        fused = [ops[j].fn]
                        j += 1
                        while j < len(ops) and isinstance(ops[j], _MapBlocks):
                            fused.append(ops[j].fn)
                            j += 1

                        def chain(block, fns=tuple(fused)):
                            for f in fns:
                                block = f(block)
                            return block

                        phys.append(("fn", chain))
                    elif isinstance(ops[j], _ActorMapBlocks):
                        phys.append(("actor", ops[j]))
                        j += 1
                    else:
                        break
                refs = self._run_map_segment(phys, refs)
                i = j
            elif isinstance(op, _Shuffle):
                in_refs = list(refs)
                part_fn = op.partition_fn
                if op.prepare is not None:
                    part_fn = op.prepare(in_refs)
                refs = self._executor.shuffle_refs(
                    in_refs, part_fn, op.reduce_fn,
                    num_outputs=op.num_outputs,
                )
                i += 1
            elif isinstance(op, _Limit):
                refs = _limit_refs(refs, op.n)
                i += 1
            else:
                raise TypeError(op)
        return refs

    def _run_map_segment(self, phys: List[Any], refs: Iterator[Any]) -> Iterator[Any]:
        # in process: construct actor classes once, map serially
        out = refs
        for kind, payload in phys:
            if kind == "fn":
                out = self._executor.map_refs(payload, out)
            else:
                out = self._executor.map_refs(
                    functools.partial(payload.wrapper, payload.cls()), out)
        return out

    def iter_blocks(self) -> Iterator[Block]:
        for r in self._iter_output_refs():
            yield ray_tpu_torch.get(r)

    def iter_rows(self) -> Iterator[Any]:
        for b in self.iter_blocks():
            yield from block_to_rows(b)

    def iter_batches(
        self,
        *,
        batch_size: Optional[int] = 256,
        batch_format: Optional[str] = None,
        drop_last: bool = False,
        local_shuffle_buffer_size: Optional[int] = None,
        local_shuffle_seed: Optional[int] = None,
    ) -> Iterator[Any]:
        """Re-batch the block stream to batch_size (reference:
        dataset.py:5981). The carry-over path avoids concatenating more
        than one pending block at a time."""
        rng = np.random.RandomState(local_shuffle_seed)
        carry: Block = {}
        for block in self.iter_blocks():
            if local_shuffle_buffer_size:
                n = block_num_rows(block)
                if n:
                    block = block_take(block, rng.permutation(n))
            carry = block_concat([carry, block]) if carry else block
            if batch_size is None:
                if block_num_rows(carry):
                    yield to_batch_format(carry, batch_format)
                carry = {}
                continue
            while block_num_rows(carry) >= batch_size:
                yield to_batch_format(block_slice(carry, 0, batch_size), batch_format)
                carry = block_slice(carry, batch_size, block_num_rows(carry))
        if block_num_rows(carry) and not drop_last and batch_size is not None:
            yield to_batch_format(carry, batch_format)

    def iter_torch_batches(self, *, batch_size: int = 256, device=None, mesh=None,
                           drop_last: bool = True) -> Iterator[Any]:
        """Ingest for the train step: yields dicts of tensors on ``device``
        (None: the card). The counterpart of the JAX package's
        ``iter_jax_batches``, with its dtypes (``jnp.asarray`` under JAX's
        default config: 64-bit ints and floats become 32-bit). ``mesh``
        plays ``sharding``'s part: each rank keeps its rows of the global
        batch (``parallel.sharding.shard_batch``)."""
        from ray_tpu_torch.parallel.sharding import shard_batch

        dev = default_device(device)
        for batch in self.iter_batches(batch_size=batch_size, drop_last=drop_last):
            cpu = {k: torch.from_numpy(np.ascontiguousarray(v, _jax_dtype(v.dtype)))
                   for k, v in batch.items()}
            yield {k: v.to(dev) for k, v in shard_batch(mesh, cpu).items()}

    # -- consumption ---------------------------------------------------
    def take(self, n: int = 20) -> List[Any]:
        out = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def take_all(self) -> List[Any]:
        return list(self.iter_rows())

    def count(self) -> int:
        return sum(block_num_rows(b) for b in self.iter_blocks())

    def sum(self, col: str) -> float:
        return float(np.sum([b[col].sum() for b in self.iter_blocks() if block_num_rows(b)]))

    def min(self, col: str) -> float:
        return float(np.min([b[col].min() for b in self.iter_blocks() if block_num_rows(b)]))

    def max(self, col: str) -> float:
        return float(np.max([b[col].max() for b in self.iter_blocks() if block_num_rows(b)]))

    def mean(self, col: str) -> float:
        tot, cnt = 0.0, 0
        for b in self.iter_blocks():
            n = block_num_rows(b)
            if n:
                tot += float(b[col].sum())
                cnt += n
        return tot / max(cnt, 1)

    def schema(self) -> Dict[str, Any]:
        for b in self.iter_blocks():
            if block_num_rows(b):
                return {k: (v.dtype, v.shape[1:]) for k, v in b.items()}
        return {}

    def num_blocks(self) -> int:
        return sum(1 for _ in self._iter_output_refs())

    def size_bytes(self) -> int:
        return sum(block_size_bytes(b) for b in self.iter_blocks())

    def materialize(self) -> "Dataset":
        """Execute the plan; result holds concrete block refs."""
        return Dataset(list(self._iter_output_refs()))

    def materialize_block(self) -> Block:
        return block_concat(list(self.iter_blocks()))

    def split(self, n: int, *, locality_hints=None) -> List["Dataset"]:
        """Split into n datasets (reference: dataset.py split for per-worker
        ingest shards)."""
        refs = list(self._iter_output_refs())
        if len(refs) < n:
            whole = block_concat([ray_tpu_torch.get(r) for r in refs])
            rows = block_num_rows(whole)
            idx = np.array_split(np.arange(rows), n)
            return [Dataset([ray_tpu_torch.put(block_take(whole, i))]) for i in idx]
        parts = np.array_split(np.arange(len(refs)), n)
        return [Dataset([refs[i] for i in p]) for p in parts]

    def train_test_split(self, test_size: float, *, shuffle: bool = False,
                         seed: Optional[int] = None) -> Tuple["Dataset", "Dataset"]:
        whole = self.materialize_block()
        n = block_num_rows(whole)
        idx = np.arange(n)
        if shuffle:
            np.random.RandomState(seed).shuffle(idx)
        k = int(n * (1 - test_size))
        return (
            Dataset([ray_tpu_torch.put(block_take(whole, idx[:k]))]),
            Dataset([ray_tpu_torch.put(block_take(whole, idx[k:]))]),
        )

    # -- writers ---------------------------------------------------------
    def _write_files(self, path: str, fmt: str) -> List[str]:
        """One file per output block, written in process (reference:
        Dataset.write_parquet/write_csv)."""
        import os

        os.makedirs(path, exist_ok=True)
        return [_write_block_file(ray_tpu_torch.get(r),
                                  os.path.join(path, f"part-{i:05d}.{fmt}"), fmt)
                for i, r in enumerate(self._iter_output_refs())]

    def write_parquet(self, path: str) -> List[str]:
        return self._write_files(path, "parquet")

    def write_csv(self, path: str) -> List[str]:
        return self._write_files(path, "csv")

    def write_json(self, path: str) -> List[str]:
        return self._write_files(path, "json")

    def __repr__(self) -> str:
        names = [getattr(op, "name", type(op).__name__) for op in self._ops]
        return f"Dataset(blocks={len(self._source_refs)}, plan={' -> '.join(names) or 'source'})"

    stats = __repr__


class GroupedData:
    """Hash-shuffle groupby: rows hash-partition by key (map tasks), each
    reduce task aggregates its partition's groups — no driver
    materialization (reference: hash-shuffle groupby,
    _internal/gpu_shuffle/hash_shuffle.py re-imagined for CPU blocks)."""

    def __init__(self, ds: Dataset, key: str):
        self._ds = ds
        self._key = key

    def _agg(self, agg_fn: Callable[[Block], Dict[str, Any]], suffix: str) -> Dataset:
        key = self._key

        def _part(block: Block, k: int, idx: int) -> List[Block]:
            n = block_num_rows(block)
            if not n:
                return [block] * k
            vals = np.asarray(block[key])
            if vals.dtype.kind in "iub":
                assign = vals.astype(np.int64) % k
            else:
                # stable across processes (PYTHONHASHSEED-independent)
                from pandas.util import hash_array

                assign = (hash_array(vals) % k).astype(np.int64)
            return [block_take(block, np.where(assign == j)[0]) for j in range(k)]

        def _reduce(parts: List[Block]) -> Block:
            merged = block_concat(parts)
            if not block_num_rows(merged):
                return {}
            uniq, inverse = np.unique(merged[key], return_inverse=True)
            rows = []
            for gi, kv in enumerate(uniq):
                grp = block_take(merged, np.where(inverse == gi)[0])
                row = {key: kv}
                row.update(agg_fn(grp))
                rows.append(row)
            return block_from_rows(rows)

        return self._ds._with(_Shuffle(_part, _reduce, f"GroupBy({key})"))

    def count(self) -> Dataset:
        return self._agg(lambda g: {"count()": block_num_rows(g)}, "count")

    def sum(self, col: str) -> Dataset:
        return self._agg(lambda g: {f"sum({col})": g[col].sum()}, "sum")

    def mean(self, col: str) -> Dataset:
        return self._agg(lambda g: {f"mean({col})": g[col].mean()}, "mean")

    def max(self, col: str) -> Dataset:
        return self._agg(lambda g: {f"max({col})": g[col].max()}, "max")

    def min(self, col: str) -> Dataset:
        return self._agg(lambda g: {f"min({col})": g[col].min()}, "min")

    def std(self, col: str, ddof: int = 1) -> Dataset:
        # <= ddof rows: dispersion is UNDEFINED, not zero (matching
        # pandas/numpy NaN semantics — 0.0 would claim perfect
        # certainty from a single sample)
        return self._agg(
            lambda g: {f"std({col})": float(np.std(g[col], ddof=ddof))
                       if block_num_rows(g) > ddof
                       else float("nan")}, "std")

    def aggregate(self, **aggs: Tuple[str, str]) -> Dataset:
        """Multiple named aggregations in ONE shuffle (reference:
        GroupedData.aggregate): ``aggregate(total=("x", "sum"),
        hi=("x", "max"))``."""
        fns = {"sum": lambda a: a.sum(), "mean": lambda a: a.mean(),
               "min": lambda a: a.min(), "max": lambda a: a.max(),
               "count": lambda a: len(a),
               "std": lambda a: float(np.std(a, ddof=1))
               if len(a) > 1 else float("nan")}
        for name, (col, op) in aggs.items():
            if op not in fns:
                raise ValueError(f"unknown aggregation {op!r}")

        def _multi(g: Block) -> Dict[str, Any]:
            return {name: fns[op](g[col])
                    for name, (col, op) in aggs.items()}

        return self._agg(_multi, "agg")


def _write_block_file(block: Block, path: str, fmt: str) -> str:
    if fmt == "parquet":
        import pyarrow as pa
        import pyarrow.parquet as pq

        pq.write_table(
            pa.table({k: list(v) if v.ndim > 1 else v for k, v in block.items()}),
            path,
        )
    elif fmt in ("csv", "json"):
        import pandas as pd

        df = pd.DataFrame({k: list(v) if v.ndim > 1 else v for k, v in block.items()})
        if fmt == "csv":
            df.to_csv(path, index=False)
        else:
            df.to_json(path, orient="records", lines=True)
    else:
        raise ValueError(f"unknown format {fmt}")
    return path


def _limit_refs(refs: Iterator[Any], n: int) -> Iterator[Any]:
    remaining = n
    for r in refs:
        if remaining <= 0:
            return
        block = ray_tpu_torch.get(r)
        rows = block_num_rows(block)
        if rows <= remaining:
            remaining -= rows
            yield r
        else:
            yield ray_tpu_torch.put(block_slice(block, 0, remaining))
            remaining = 0


def _jax_dtype(dtype: np.dtype) -> np.dtype:
    """The dtype ``jnp.asarray`` gives a numpy array under JAX's default
    config (no x64): 64-bit ints, floats and complex numbers halve."""
    return _X64_TO_X32.get(np.dtype(dtype), dtype)


_X64_TO_X32 = {np.dtype(np.int64): np.dtype(np.int32),
               np.dtype(np.uint64): np.dtype(np.uint32),
               np.dtype(np.float64): np.dtype(np.float32),
               np.dtype(np.complex128): np.dtype(np.complex64)}
