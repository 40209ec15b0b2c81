"""Data's readers and writers as tasks: the file cases of
tests/test_data_streaming.py on a two-node ``Cluster`` of the port's (read
tasks a file, write tasks a block), and ``iter_torch_batches`` over blocks
the workers made, each outcome held against JAX's Data in JAX's local
mode on the same seeds (tests/test_torch_data_streaming.py says how);
then the streaming executor's stages overlapping over read tasks.
"""

import os
import time

import numpy as np
import torch

import ray_tpu
import ray_tpu_torch
from cluster_ref import both, collector_paused, data_cluster as cluster  # noqa: F401


def test_parquet_roundtrip_pipeline(cluster, tmp_path):
    def pipeline(D):
        where = tmp_path / D.__name__ / "pq"
        src = D.range(2_000, override_num_blocks=4).add_column(
            "x", lambda b: b["id"].astype(np.float64) * 0.5)
        paths = src.write_parquet(str(where))
        assert len(paths) == 4 and all(os.path.exists(p) for p in paths)
        ds = (D.read_parquet(str(where))
              .map_batches(lambda b: {"id": b["id"], "y": b["x"] * 2.0})
              .random_shuffle(seed=11))
        return [(b["id"].tolist(), b["y"].tolist()) for b in ds.iter_batches(batch_size=256)]

    ref, got = both(pipeline)
    assert sum(len(i) for i, _ in got) == 2_000
    assert sum(sum(y) for _, y in got) == float(np.arange(2_000).sum())  # y = id
    assert got == ref


def test_csv_json_roundtrip(cluster, tmp_path):
    def roundtrip(D):
        src = D.from_items([{"a": i, "b": f"s{i}"} for i in range(100)])
        src.write_csv(str(tmp_path / D.__name__ / "csv"))
        rows = sorted(((int(r["a"]), str(r["b"])) for r in
                       D.read_csv(str(tmp_path / D.__name__ / "csv")).take_all()))
        src.write_json(str(tmp_path / D.__name__ / "json"))
        return rows, D.read_json(str(tmp_path / D.__name__ / "json")).count()

    ref, got = both(roundtrip)
    assert len(got[0]) == 100 and got[0][5] == (5, "s5") and got[1] == 100
    assert got == ref


def test_iter_torch_batches_from_pipeline(cluster):
    """The port's ``iter_torch_batches`` over blocks its workers made,
    against JAX's ``iter_jax_batches`` of the same pipeline."""
    def pipeline(D):
        return D.range(512, override_num_blocks=2).map_batches(
            lambda b: {"x": b["id"].astype(np.float32)})

    with collector_paused():
        ref = [np.asarray(b["x"]) for b in pipeline(ray_tpu.data).iter_jax_batches(batch_size=128)]
    got = list(pipeline(ray_tpu_torch.data).iter_torch_batches(batch_size=128, device="cpu"))
    assert len(got) == 4
    assert float(sum(b["x"].sum() for b in got)) == float(np.arange(512).sum())
    assert all(b["x"].dtype == torch.float32 for b in got)
    assert all((b["x"].numpy() == r).all() for b, r in zip(got, ref))


def test_streaming_stage_overlap(cluster, tmp_path):
    """Stage 2 (an actor pool) starts on early blocks while stage 1 is
    still running later ones: no barrier between the map stages of a
    read -> map_batches -> ingest pipeline (JAX's assertion)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    # the source files written here (JAX's test writes them with
    # write_parquet, which test_parquet_roundtrip_pipeline holds)
    (tmp_path / "pq").mkdir()
    for i in range(24):
        pq.write_table(pa.table({"id": np.arange(i * 64, (i + 1) * 64)}),
                       str(tmp_path / "pq" / f"part-{i:05d}.parquet"))

    def stage1(b):
        time.sleep(0.75)
        out = dict(b)
        out["t1_end"] = np.full(len(b["id"]), time.time())
        return out

    class Stage2:
        def __init__(self):
            self.blocks = 0

        def __call__(self, b):
            self.blocks += 1
            time.sleep(0.1)
            out = dict(b)
            out["t2_start"] = np.full(len(b["id"]), time.time())
            return out

    ds = (ray_tpu_torch.data.read_parquet(str(tmp_path / "pq"))
          .map_batches(stage1)
          .map_batches(Stage2, concurrency=2))
    t1_end, t2_start = [], []
    for batch in ds.iter_batches(batch_size=None):
        t1_end.append(batch["t1_end"].max())
        t2_start.append(batch["t2_start"].min())
    assert len(t1_end) == 24
    assert min(t2_start) < max(t1_end), (
        f"stages ran serially: first t2 {min(t2_start):.3f} >= last t1 {max(t1_end):.3f}")
