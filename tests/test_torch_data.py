"""The port's Data (ray_tpu_torch.data) against ray_tpu.data, in local mode.

Each case of tests/test_data.py, and each op, reader and writer besides,
is written once as a function of the package module. It runs through
``ray_tpu`` and then through ``ray_tpu_torch``, each under its own
``init(local_mode=True)`` / ``shutdown()``, and both must give the same
outcome: values with their numpy types, row order, schemas, and errors
by class and message. The join and grouped-aggregate cases, which
tests/test_data.py runs on a cluster, run here in local mode in both.
``iter_torch_batches`` is held against ``iter_jax_batches``: values,
dtypes (64-bit ints and floats become 32-bit, as ``jnp.asarray`` gives
them), ``drop_last``, and a mesh of one.
"""

import json
import os

import jax
import numpy as np
import pandas  # noqa: F401 — imported before the join's tasks import it on threads
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

import ray_tpu
import ray_tpu.data  # noqa: F401 — rt.data in the cases
import ray_tpu_torch
import ray_tpu_torch.data  # noqa: F401
from ray_tpu_torch.data import dataset as port_dataset
from ray_tpu_torch.data._internal.executor import Executor

PACKAGES = (ray_tpu, ray_tpu_torch)
CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def plain(x):
    """``x`` with numpy values spelled out (type, dtype, shape, values) and
    NaN as a token, so two outcomes compare with ==."""
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape, plain(x.tolist()))
    if isinstance(x, np.dtype):
        return ("dtype", x.str)
    if isinstance(x, np.generic):
        return (type(x).__name__, plain(x.item()))
    if isinstance(x, float) and x != x:
        return "nan"
    return x


def outcome(fn):
    try:
        return ("ok", plain(fn()))
    except Exception as e:  # noqa: BLE001 — the outcome is the exception
        return (type(e).__name__, str(e).replace("ray_tpu_torch", "ray_tpu"))


def run_local(rt, fn, *args):
    rt.init(local_mode=True)
    try:
        return outcome(lambda: fn(rt, *args))
    finally:
        rt.shutdown()


# ---- tests/test_data.py: TestCreation -----------------------------------
@case
def range_count_schema(rt):
    ds = rt.data.range(1000)
    assert ds.count() == 1000 and "id" in ds.schema()
    return ds.count(), ds.schema(), ds.num_blocks()


@case
def from_items_rows(rt):
    rows = rt.data.from_items([{"a": i, "b": i * 2} for i in range(10)]).take_all()
    assert rows[3] == {"a": 3, "b": 6}
    return rows


@case
def from_numpy(rt):
    ds = rt.data.from_numpy(np.ones((16, 4)))
    assert ds.count() == 16 and ds.schema()["data"][1] == (4,)
    return ds.count(), ds.schema(), ds.take(2)


# ---- TestTransforms ------------------------------------------------------
@case
def map_batches_fused_chain(rt):
    ds = (rt.data.range(100)
          .map_batches(lambda b: {"id": b["id"] * 2})
          .map_batches(lambda b: {"id": b["id"] + 1}))
    assert ds.take(3) == [{"id": 1}, {"id": 3}, {"id": 5}]
    return ds.take(3), ds.take_all()


@case
def map_and_filter(rt):
    ds = rt.data.range(20).map(lambda r: {"v": int(r["id"]) ** 2}).filter(
        lambda r: r["v"] % 2 == 0)
    assert ds.take(3) == [{"v": 0}, {"v": 4}, {"v": 16}]
    return ds.take_all()


@case
def flat_map(rt):
    rows = rt.data.from_items([1, 2]).flat_map(lambda r: [r, r * 10]).take_all()
    assert rows == [1, 10, 2, 20]
    return rows


@case
def add_select_drop_columns(rt):
    ds = rt.data.range(5).add_column("double", lambda b: b["id"] * 2)
    assert set(ds.schema()) == {"id", "double"}
    assert ds.select_columns(["double"]).take(2) == [{"double": 0}, {"double": 2}]
    assert set(ds.drop_columns(["double"]).schema()) == {"id"}
    return ds.take_all(), ds.drop_columns(["double"]).schema()


@case
def limit(rt):
    assert rt.data.range(1000).limit(7).count() == 7
    return rt.data.range(100, override_num_blocks=4).limit(30).take_all()


@case
def map_batches_sizes_formats_and_class(rt):
    seen = []

    class AddOffset:  # a callable class: one instance a pool (in process here)
        def __init__(self):
            self.offset = 1000

        def __call__(self, batch):
            seen.append(len(batch["id"]))
            return {"id": batch["id"] + self.offset}

    chunked = rt.data.range(10, override_num_blocks=2).map_batches(
        lambda b: {"n": np.full(len(b["id"]), len(b["id"]))}, batch_size=3)
    pandas_out = rt.data.range(6).map_batches(
        lambda df: df.assign(sq=df["id"] ** 2), batch_format="pandas")
    with_kwargs = rt.data.range(4).map_batches(lambda b, k: {"id": b["id"] * k},
                                               fn_kwargs={"k": 7}, concurrency=(1, 3))
    pooled = rt.data.range(8, override_num_blocks=2).map_batches(AddOffset, concurrency=2)
    return (chunked.take_all(), pandas_out.take_all(), with_kwargs.take_all(),
            pooled.take_all(), seen, repr(pooled), repr(chunked))


# ---- TestAllToAll --------------------------------------------------------
@case
def repartition(rt):
    ds = rt.data.range(100).repartition(7).materialize()
    assert ds.num_blocks() == 7 and ds.count() == 100
    return [len(b["id"]) for b in ds.iter_blocks()], ds.take_all()


@case
def repartition_zero_raises(rt):
    return rt.data.range(10).repartition(0)


@case
def random_shuffle_preserves_set(rt):
    ds = rt.data.range(50).random_shuffle(seed=7)
    vals = sorted(r["id"] for r in ds.take_all())
    assert vals == list(range(50))
    first = rt.data.range(50).random_shuffle(seed=7).take(5)
    assert first != [{"id": i} for i in range(5)]
    return ds.take_all(), rt.data.range(50, override_num_blocks=5).random_shuffle(
        seed=3).take_all()


@case
def sort(rt):
    ds = rt.data.from_items([{"k": v} for v in [3, 1, 2]]).sort("k")
    assert [r["k"] for r in ds.take_all()] == [1, 2, 3]
    dsd = rt.data.from_items([{"k": v} for v in [3, 1, 2]]).sort("k", descending=True)
    assert [r["k"] for r in dsd.take_all()] == [3, 2, 1]
    words = rt.data.from_items([{"w": w} for w in "pear fig apple kiwi plum date".split()],
                               override_num_blocks=3)
    rng = np.random.RandomState(0)
    many = rt.data.from_items([{"k": int(v)} for v in rng.randint(0, 1000, 200)],
                              override_num_blocks=4)
    return (ds.take_all(), dsd.take_all(), words.sort("w").take_all(),
            words.sort("w", descending=True).take_all(), many.sort("k").take_all())


@case
def groupby(rt):
    ds = rt.data.from_items([{"g": i % 3, "v": float(i)} for i in range(9)])
    counts = {r["g"]: r["count()"] for r in ds.groupby("g").count().take_all()}
    assert counts == {0: 3, 1: 3, 2: 3}
    sums = {r["g"]: r["sum(v)"] for r in ds.groupby("g").sum("v").take_all()}
    assert sums[0] == 0 + 3 + 6
    named = rt.data.from_items([{"name": n, "v": i} for i, n in enumerate("abcab")],
                               override_num_blocks=2)
    return ([g.take_all() for g in (ds.groupby("g").count(), ds.groupby("g").sum("v"),
                                    ds.groupby("g").mean("v"), ds.groupby("g").min("v"),
                                    ds.groupby("g").max("v"))],
            named.groupby("name").sum("v").take_all())


@case
def aggregates(rt):
    ds = rt.data.range(10)
    assert ds.sum("id") == 45 and ds.min("id") == 0
    assert ds.max("id") == 9 and ds.mean("id") == 4.5
    return ds.sum("id"), ds.min("id"), ds.max("id"), ds.mean("id"), ds.size_bytes()


# ---- TestBatching --------------------------------------------------------
@case
def iter_batches_sizes(rt):
    ds = rt.data.range(100)
    sizes = [len(b["id"]) for b in ds.iter_batches(batch_size=32)]
    assert sizes == [32, 32, 32, 4]
    sizes = [len(b["id"]) for b in ds.iter_batches(batch_size=32, drop_last=True)]
    assert sizes == [32, 32, 32]
    blocks = rt.data.range(100, override_num_blocks=3)
    shuffled = list(blocks.iter_batches(batch_size=40, local_shuffle_buffer_size=10,
                                        local_shuffle_seed=5))
    return (list(ds.iter_batches(batch_size=32)),
            list(blocks.iter_batches(batch_size=None)), shuffled)


@case
def iter_batches_pandas(rt):
    b = next(iter(rt.data.range(10).iter_batches(batch_size=5, batch_format="pandas")))
    assert list(b.columns) == ["id"]
    a = next(iter(rt.data.range(10).iter_batches(batch_size=5, batch_format="pyarrow")))
    return list(b.columns), b.to_dict("list"), a.to_pydict()


@case
def iter_batches_bad_format_raises(rt):
    return next(iter(rt.data.range(10).iter_batches(batch_format="feather")))


@case
def split_for_workers(rt):
    parts = rt.data.range(100).split(4)
    assert sum(p.count() for p in parts) == 100
    many = rt.data.range(100, override_num_blocks=8).split(3)
    return [p.take_all() for p in parts], [p.take_all() for p in many]


@case
def train_test_split(rt):
    train, test = rt.data.range(100).train_test_split(0.2)
    assert train.count() == 80 and test.count() == 20
    strain, stest = rt.data.range(20).train_test_split(0.25, shuffle=True, seed=4)
    return train.take_all(), test.take_all(), strain.take_all(), stest.take_all()


@case
def union_zip_take_and_schema(rt):
    a = rt.data.range(3)
    b = rt.data.from_items([{"id": 10 + i, "w": 0.5 * i} for i in range(3)])
    zipped = a.zip(b)
    return (a.union(rt.data.range(2), a).take_all(), zipped.take_all(), zipped.schema(),
            rt.data.range(0).schema(), list(a.iter_rows()), a.take(2),
            rt.data.from_blocks([{"x": np.arange(3)}, {"x": np.arange(2)}]).take_all(),
            rt.data.range_tensor(4, shape=(2, 3)).take(2), rt.data.range(5).stats())


@case
def from_pandas_and_arrow(rt):
    import pandas as pd
    import pyarrow as pa

    df = pd.DataFrame({"a": [1, 2, 3], "b": [0.5, 1.5, 2.5]})
    return (rt.data.from_pandas(df).take_all(),
            rt.data.from_arrow(pa.table({"c": ["x", "y"]})).take_all())


# ---- TestIO --------------------------------------------------------------
@case
def read_text_roundtrip(rt, tmp):
    p = os.path.join(tmp, "f.txt")
    with open(p, "w") as f:
        f.write("a\nb\nc\n")
    ds = rt.data.read_text(p)
    assert [r["text"] for r in ds.take_all()] == ["a", "b", "c"]
    return ds.take_all()


@case
def read_csv(rt, tmp):
    p = os.path.join(tmp, "t.csv")
    with open(p, "w") as f:
        f.write("x,y\n1,2\n3,4\n")
    ds = rt.data.read_csv(p)
    assert ds.take_all() == [{"x": 1, "y": 2}, {"x": 3, "y": 4}]
    return ds.take_all()


@case
def read_parquet(rt, tmp):
    import pyarrow as pa
    import pyarrow.parquet as pq

    pq.write_table(pa.table({"a": [1, 2, 3]}), os.path.join(tmp, "t.parquet"))
    ds = rt.data.read_parquet(os.path.join(tmp, "t.parquet"))
    assert [r["a"] for r in ds.take_all()] == [1, 2, 3]
    return ds.take_all()


@case
def read_json_and_numpy(rt, tmp):
    with open(os.path.join(tmp, "r.json"), "w") as f:
        f.write("\n".join(json.dumps({"k": i, "s": str(i)}) for i in range(3)) + "\n")
    np.save(os.path.join(tmp, "a.npy"), np.arange(12.0).reshape(4, 3))
    np.save(os.path.join(tmp, "b.npy"), np.arange(3.0).reshape(1, 3))
    return (rt.data.read_json(os.path.join(tmp, "r.json")).take_all(),
            rt.data.read_numpy(tmp).take_all(),
            rt.data.read_numpy(os.path.join(tmp, "*.npy")).count())


@case
def read_missing_raises(rt, tmp):
    return rt.data.read_csv(os.path.join(tmp, "nothing-here"))


@case
def write_and_read_back(rt, tmp):
    ds = rt.data.from_items([{"i": i, "f": i / 4, "s": f"r{i}"} for i in range(10)],
                            override_num_blocks=3)
    out = []
    for fmt, read in (("csv", rt.data.read_csv), ("json", rt.data.read_json),
                      ("parquet", rt.data.read_parquet)):
        d = os.path.join(tmp, fmt)
        paths = getattr(ds, f"write_{fmt}")(d)
        out.append(([os.path.relpath(p, tmp) for p in paths], read(d).take_all()))
    return out


# ---- TestClusterExec, in local mode here ---------------------------------
@case
def map_batches_over_blocks(rt):
    ds = rt.data.range(1000, override_num_blocks=8).map_batches(lambda b: {"id": b["id"] * 3})
    assert ds.sum("id") == 3 * sum(range(1000))
    return ds.sum("id"), ds.num_blocks()


# ---- TestJoinsAndAggregates, in local mode here --------------------------
@case
def inner_join(rt):
    left = rt.data.from_items([{"id": i, "x": i * 10} for i in range(8)],
                              override_num_blocks=3)
    right = rt.data.from_items([{"id": i, "y": i * 100} for i in range(4, 12)],
                               override_num_blocks=2)
    rows = left.join(right, on="id").take_all()
    got = sorted((r["id"], r["x"], r["y"]) for r in rows)
    assert got == [(i, i * 10, i * 100) for i in range(4, 8)]
    return rows, left.join(right, on="id", how="outer").take_all()


@case
def left_join_keeps_unmatched(rt):
    left = rt.data.from_items([{"id": i, "x": i} for i in range(4)])
    right = rt.data.from_items([{"id": 2, "y": 9}])
    rows = left.join(right, on="id", how="left").take_all()
    assert len(rows) == 4
    by_id = {r["id"]: r for r in rows}
    assert by_id[2]["y"] == 9 and np.isnan(by_id[0]["y"])
    return rows


@case
def left_join_empty_buckets_keep_schema(rt):
    left = rt.data.from_items([{"id": i, "x": i} for i in range(8)], override_num_blocks=4)
    right = rt.data.from_items([{"id": 3, "y": 30}], override_num_blocks=1)
    rows = left.join(right, on="id", how="left", num_partitions=4).take_all()
    assert len(rows) == 8 and all("y" in r for r in rows)
    by_id = {r["id"]: r for r in rows}
    assert by_id[3]["y"] == 30 and np.isnan(by_id[0]["y"])
    return rows


@case
def join_bad_how_raises(rt):
    return rt.data.range(3).join(rt.data.range(3), on="id", how="cross")


@case
def groupby_std_and_multi_aggregate(rt):
    ds = rt.data.from_items([{"g": i % 2, "v": float(i)} for i in range(10)],
                            override_num_blocks=3)
    rows = ds.groupby("g").aggregate(total=("v", "sum"), hi=("v", "max"),
                                     n=("v", "count")).take_all()
    by_g = {r["g"]: r for r in rows}
    assert by_g[0]["total"] == 0 + 2 + 4 + 6 + 8
    assert by_g[1]["hi"] == 9.0 and by_g[0]["n"] == 5
    std_rows = ds.groupby("g").std("v").take_all()
    got = {r["g"]: r["std(v)"] for r in std_rows}
    assert abs(got[1] - np.std([1, 3, 5, 7, 9], ddof=1)) < 1e-9
    single = rt.data.from_items([{"g": 0, "v": 1.0}]).groupby("g").aggregate(
        sd=("v", "std"), mu=("v", "mean"), lo=("v", "min")).take_all()
    return rows, std_rows, single


@case
def aggregate_unknown_raises(rt):
    return rt.data.range(4).groupby("id").aggregate(x=("id", "median"))


@pytest.mark.parametrize("name", sorted(CASES))
def test_same_outcome_as_ray_tpu(name, tmp_path):
    fn = CASES[name]
    args = ()
    if fn.__code__.co_argcount == 2:  # a file case: its own directory a package
        args = (str(tmp_path / "jax"), str(tmp_path / "port"))
        for d in args:
            os.makedirs(d)
    ref = run_local(ray_tpu, fn, *args[:1])
    got = run_local(ray_tpu_torch, fn, *args[1:])
    assert ref[0] != "AssertionError", ref
    if args:  # each package's directory in a message
        ref, got = repr(ref).replace(args[0], "<tmp>"), repr(got).replace(args[1], "<tmp>")
    assert got == ref


# ---- iter_torch_batches against iter_jax_batches --------------------------
def mixed_dataset(data):
    rng = np.random.RandomState(0)
    return data.from_blocks([
        {"i64": rng.randint(0, 1000, n).astype(np.int64), "f64": rng.randn(n),
         "f32": rng.randn(n).astype(np.float32), "i32": np.arange(n, dtype=np.int32),
         "flag": rng.rand(n) > 0.5, "tok": rng.randint(0, 50, (n, 6)),
         "u8": rng.randint(0, 255, n).astype(np.uint8)}
        for n in (7, 13, 4)])


def torch_batches(**kw):
    ray_tpu_torch.init(local_mode=True)
    try:
        return list(mixed_dataset(ray_tpu_torch.data).random_shuffle(seed=1)
                    .iter_torch_batches(device="cpu", **kw))
    finally:
        ray_tpu_torch.shutdown()


def jax_batches(**kw):
    ray_tpu.init(local_mode=True)
    try:
        return list(mixed_dataset(ray_tpu.data).random_shuffle(seed=1).iter_jax_batches(**kw))
    finally:
        ray_tpu.shutdown()


def assert_same_batches(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert list(g) == list(r)
        for k in r:
            want = np.asarray(r[k])
            assert g[k].device.type == "cpu" and g[k].numpy().dtype == want.dtype, k
            np.testing.assert_array_equal(g[k].numpy(), want)


@pytest.mark.parametrize("drop_last", [True, False])
def test_iter_torch_batches_matches_iter_jax_batches(drop_last):
    ref = jax_batches(batch_size=5, drop_last=drop_last)
    got = torch_batches(batch_size=5, drop_last=drop_last)
    assert [len(b["i64"]) for b in got] == ([5] * 4 if drop_last else [5] * 4 + [4])
    assert_same_batches(got, ref)
    assert {k: v.dtype for k, v in got[0].items()} == {
        "i64": torch.int32, "f64": torch.float32, "f32": torch.float32, "i32": torch.int32,
        "flag": torch.bool, "tok": torch.int32, "u8": torch.uint8}


def test_iter_torch_batches_on_a_mesh_of_one():
    """``mesh`` in place of ``sharding``: the one rank keeps every row."""
    from ray_tpu_torch.parallel import single_device_mesh

    sharding = NamedSharding(Mesh(np.array(jax.devices()[:1]), ("data",)),
                             PartitionSpec("data"))
    ref = jax_batches(batch_size=8, sharding=sharding)
    mesh = single_device_mesh("cpu")
    try:
        got = torch_batches(batch_size=8, mesh=mesh)
    finally:
        torch.distributed.destroy_process_group()
    assert_same_batches(got, ref)


def test_iter_torch_batches_needs_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = port_dataset.Dataset([{"id": np.arange(4)}])
    with pytest.raises(RuntimeError, match="CUDA"):
        next(ds.iter_torch_batches(batch_size=2))


# ---- Data under the cluster runtime ------------------------------------
def test_cluster_execution_raises_naming_item_10b(tmp_path):
    """Where Data's plan runs: under a cluster, ``init()``, the executor
    maps blocks in worker processes (``local=False``, what
    ``_use_local_exec`` picks there), and every op, read and write runs
    as tasks; under local mode in the driver's process. The outcomes are
    the same (tests/test_torch_data_streaming.py holds the rows against
    JAX's)."""
    from ray_tpu_torch.data.dataset import _use_local_exec

    (tmp_path / "f.txt").write_text("a\nb\n")
    for kwargs in ({"num_cpus": 1}, {"local_mode": True}):
        ray_tpu_torch.init(**kwargs)
        try:
            local = _use_local_exec()
            assert local == ("local_mode" in kwargs)
            pids = []
            ex = Executor()
            assert [ray_tpu_torch.get(r) for r in ex.map_refs(
                lambda b: pids.append(os.getpid()) or dict(b, pid=os.getpid()),
                iter([{"id": 1}]), local=local)] == [
                    {"id": 1, "pid": os.getpid() if local else pids_of_workers()}]
            assert pids == ([os.getpid()] if local else [])
            assert ray_tpu_torch.data.range(4).map_batches(lambda b: b).random_shuffle(
                seed=0).count() == 4
            assert ray_tpu_torch.data.read_text(str(tmp_path / "f.txt")).take_all() \
                == [{"text": "a"}, {"text": "b"}]
            out = str(tmp_path / f"o{len(kwargs)}{kwargs.get('num_cpus', 0)}")
            assert len(ray_tpu_torch.data.range(4).write_csv(out)) == 1
        finally:
            ray_tpu_torch.shutdown()


class pids_of_workers:
    """Equal to any pid but the driver's."""

    def __eq__(self, pid):
        return pid != os.getpid()


def test_data_fed_train_step():
    """``iter_torch_batches`` into the port's train step (tiny + LoRA,
    fp32, on the CPU): 2 steps on the shuffled plan's batches give the
    metrics of the same steps on the plan's ``iter_batches`` rows."""
    from ray_tpu_torch import train as S
    from ray_tpu_torch.models import transformer as T

    cfg = T.config("tiny", dtype=torch.float32, param_dtype=torch.float32)
    opt = S.default_optimizer(cfg)
    run = S.make_train_step(cfg, opt, device="cpu")
    rows = np.random.RandomState(0).randint(0, cfg.vocab_size, (8, 32))
    ray_tpu_torch.init(local_mode=True)
    try:
        ds = ray_tpu_torch.data.from_numpy(rows, column="tokens").random_shuffle(seed=0)
        fed = list(ds.iter_torch_batches(batch_size=4, device="cpu"))
        plain_rows = [torch.from_numpy(b["tokens"]) for b in ds.iter_batches(batch_size=4)]
    finally:
        ray_tpu_torch.shutdown()
    assert [b["tokens"].dtype for b in fed] == [torch.int32] * 2
    got, ref = [], []
    for batches, out in ((fed, got), ([{"tokens": t} for t in plain_rows], ref)):
        state = S.init_state(cfg, opt, seed=0, device="cpu")
        for b in batches:
            state, m = run(state, b)
            out.append({k: float(v) for k, v in m.items()})
    assert got == ref and all(np.isfinite(m["loss"]) for m in got)
