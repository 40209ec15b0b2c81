"""Dataset creation APIs (PyTorch port of ray_tpu/data/read_api.py;
reference: python/ray/data/read_api.py).

Sources create blocks eagerly-but-cheaply (refs into the object store);
files are read one block a file, by a task a file under a cluster (in
process in local mode).
"""

from __future__ import annotations

import glob as glob_mod
import os
from typing import Any, Dict, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import Block, block_from_rows
from ray_tpu_torch.data.dataset import Dataset

DEFAULT_BLOCK_ROWS = 64 * 1024


def from_items(items: List[Any], *, override_num_blocks: Optional[int] = None) -> Dataset:
    n_blocks = override_num_blocks or max(1, min(len(items) // 1000, 64)) or 1
    chunks = np.array_split(np.arange(len(items)), n_blocks)
    refs = [
        ray_tpu_torch.put(block_from_rows([items[i] for i in c])) for c in chunks if len(c)
    ]
    return Dataset(refs)


def range(n: int, *, override_num_blocks: Optional[int] = None) -> Dataset:  # noqa: A001
    n_blocks = override_num_blocks or max(1, min(n // DEFAULT_BLOCK_ROWS, 64))
    bounds = np.linspace(0, n, n_blocks + 1, dtype=np.int64)
    refs = [
        ray_tpu_torch.put({"id": np.arange(bounds[i], bounds[i + 1])})
        for i in np.arange(n_blocks)
        if bounds[i + 1] > bounds[i]
    ]
    return Dataset(refs)


def range_tensor(n: int, *, shape=(1,), override_num_blocks: Optional[int] = None) -> Dataset:
    ds = range(n, override_num_blocks=override_num_blocks)

    def _expand(block: Block) -> Block:
        ids = block["id"]
        data = np.broadcast_to(
            ids.reshape((-1,) + (1,) * len(shape)), (len(ids),) + tuple(shape)
        ).copy()
        return {"data": data}

    return ds.map_batches(lambda b: _expand(b))


def from_numpy(arr: np.ndarray, column: str = "data") -> Dataset:
    return Dataset([ray_tpu_torch.put({column: np.asarray(arr)})])


def from_blocks(blocks: List[Block]) -> Dataset:
    return Dataset([ray_tpu_torch.put(b) for b in blocks])


def from_pandas(df) -> Dataset:
    return Dataset([ray_tpu_torch.put({c: np.asarray(df[c]) for c in df.columns})])


def from_arrow(table) -> Dataset:
    return Dataset([ray_tpu_torch.put({c: np.asarray(v) for c, v in table.to_pydict().items()})])


def _expand_paths(paths, suffix: Optional[str] = None) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            pat = os.path.join(p, "**", f"*{suffix or ''}")
            out.extend(sorted(glob_mod.glob(pat, recursive=True)))
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(glob_mod.glob(p)))
        else:
            out.append(p)
    return [p for p in out if os.path.isfile(p)]


def _read_file(path: str, fmt: str, kwargs: Dict[str, Any]) -> Block:
    if fmt == "parquet":
        import pyarrow.parquet as pq

        t = pq.read_table(path, **kwargs)
        return {c: np.asarray(v) for c, v in t.to_pydict().items()}
    if fmt == "csv":
        import pandas as pd

        df = pd.read_csv(path, **kwargs)
        return {c: np.asarray(df[c]) for c in df.columns}
    if fmt == "json":
        import pandas as pd

        df = pd.read_json(path, lines=kwargs.pop("lines", True), **kwargs)
        return {c: np.asarray(df[c]) for c in df.columns}
    if fmt == "text":
        with open(path) as f:
            return {"text": np.asarray([ln.rstrip("\n") for ln in f])}
    if fmt == "npy":
        return {"data": np.load(path, **kwargs)}
    raise ValueError(f"unknown format {fmt}")


_read_file_task = ray_tpu_torch.remote(_read_file)


def _read_files(paths, fmt: str, suffix: str, **kwargs) -> Dataset:
    files = _expand_paths(paths, suffix)
    if not files:
        raise FileNotFoundError(f"No files found for {paths!r}")
    from ray_tpu_torch.data.dataset import _use_local_exec

    if _use_local_exec():
        refs = [ray_tpu_torch.put(_read_file(p, fmt, dict(kwargs))) for p in files]
    else:
        refs = [_read_file_task.remote(p, fmt, dict(kwargs)) for p in files]
    return Dataset(refs)


def read_parquet(paths, **kwargs) -> Dataset:
    return _read_files(paths, "parquet", ".parquet", **kwargs)


def read_csv(paths, **kwargs) -> Dataset:
    return _read_files(paths, "csv", ".csv", **kwargs)


def read_json(paths, **kwargs) -> Dataset:
    return _read_files(paths, "json", ".json", **kwargs)


def read_text(paths, **kwargs) -> Dataset:
    return _read_files(paths, "text", ".txt", **kwargs)


def read_numpy(paths, **kwargs) -> Dataset:
    return _read_files(paths, "npy", ".npy", **kwargs)
