"""The OBJSTORE collective backend on the port's cluster, one host, held
against numpy (tests/test_collective_v2.py TestHierSingleHost,
tests/test_collective.py TestObjStoreBackend): every reduce op of a
4-rank shared-memory arena group bit-identical to the numpy reduction of
the stacked inputs, promotions included; true reducescatter shards;
arena broadcast and allgather; ranks of differing dtypes degrading
together to the object path; an 8-rank group; the int8 route within the
JAX package's stated bound (``quant.sum_error_bound``, computed by JAX's
own function); ``algo=flat`` keeping every op off the arena; two ranks
on the seqlock channel, the chunked ring pipe and the object path, with
send/recv, a barrier and CPU torch tensors for input (numpy out).
"""

import numpy as np
import pytest

import ray_tpu_torch as rt
from objstore_ref import REDUCERS, run, spawn, teardown
from ray_tpu.util.collective.v2 import quant as jquant


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4)
    try:
        yield
    finally:
        rt.shutdown()


def test_4rank_exact_suite(cluster):
    rng = np.random.RandomState(3)
    ws = spawn(4, "t_h4")
    parts = [(rng.randn(220, 220) * 10 ** rng.randint(-3, 4)).astype(np.float32)
             for _ in range(4)]  # ~190 KiB: the arena
    for op in ("sum", "mean", "max", "min", "product"):
        outs = run(ws, "allreduce", [(p, op) for p in parts])
        expect = REDUCERS[op](np.stack(parts))
        for o in outs:
            assert o.dtype == expect.dtype
            np.testing.assert_array_equal(o, expect)
    ints = [np.full((200, 200), 2 ** 30, np.int32) for _ in range(4)]
    outs = run(ws, "allreduce", [(p,) for p in ints])
    for o in outs:
        assert o.dtype == np.int64
        np.testing.assert_array_equal(o, np.sum(np.stack(ints), axis=0))
    ev = rt.get(ws[0].last_op_event.remote(), timeout=60)
    assert ev["algo"] == "hier" and ev["codec"] == "exact"
    assert {"encode", "reduce_local", "publish", "gather"} <= set(ev["phases"])
    for shape in [(10, 7), (13,), (9, 3, 2)]:
        rs_in = [rng.randn(*shape).astype(np.float32) for _ in range(4)]
        outs = run(ws, "reducescatter", [(p,) for p in rs_in])
        ref = np.array_split(np.sum(np.stack(rs_in), axis=0), 4, axis=0)
        for r, o in enumerate(outs):
            assert o.shape == ref[r].shape
            np.testing.assert_array_equal(o, ref[r])
    outs = run(ws, "broadcast", [(np.full((150, 150), float(i), np.float32), 2)
                                 for i in range(4)])
    for o in outs:
        np.testing.assert_array_equal(o, np.full((150, 150), 2.0, np.float32))
    big = [np.full((200, 200), float(i), np.float32) for i in range(4)]
    outs = run(ws, "allgather", [(b, "torch" if i == 1 else "numpy") for i, b in enumerate(big)])
    for o in outs:
        for r in range(4):
            assert isinstance(o[r], np.ndarray)
            np.testing.assert_array_equal(o[r], big[r])
    teardown(ws)


def test_divergent_dtypes_degrade_to_object_path(cluster):
    ws = spawn(2, "t_dtype")
    outs = rt.get([ws[0].allreduce.remote(np.full((120, 120), 1.0, np.float32)),
                   ws[1].allreduce.remote(np.full((120, 120), 2.0, np.float64))], timeout=300)
    for o in outs:
        np.testing.assert_allclose(o, np.full((120, 120), 3.0))
    teardown(ws)


def test_allreduce_8rank(cluster):
    ws = spawn(8, "t_h8")
    parts = [np.full((180, 180), float(i + 1), np.float32) for i in range(8)]
    outs = run(ws, "allreduce", [(p,) for p in parts])
    for o in outs:
        np.testing.assert_array_equal(o, np.sum(np.stack(parts), axis=0))
    rs_in = [np.arange(64, dtype=np.float32).reshape(16, 4) * (i + 1) for i in range(8)]
    outs = run(ws, "reducescatter", [(a,) for a in rs_in])
    chunks = np.array_split(np.sum(np.stack(rs_in), axis=0), 8, axis=0)
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o, chunks[r])
    teardown(ws)


def test_quantized_accuracy_adversarial(cluster):
    env = {"RAY_TPU_COLLECTIVE_QUANT": "int8", "RAY_TPU_COLLECTIVE_QUANT_MIN_BYTES": "65536",
           "RAY_TPU_COLLECTIVE_QUANT_BLOCK": "128"}
    ws = spawn(4, "t_q", env=env)
    rng = np.random.RandomState(5)
    n = 64 << 10  # 256 KiB fp32: quantized
    parts = []
    for i in range(4):
        p = (rng.randn(n) * 10 ** rng.randint(-2, 3)).astype(np.float32)
        p[i * 1000] = 1e7 * (i + 1)
        p[2000 + i * 128: 2128 + i * 128] = 1e-40
        p[5000:5128] = 0.0
        parts.append(p)
    outs = run(ws, "allreduce", [(p,) for p in parts])
    exact = np.sum(np.stack(parts), axis=0)
    bound = jquant.sum_error_bound(parts, 128, steps=jquant.QUANT_STEPS_SINGLE_HOST)
    for o in outs:
        assert o.dtype == np.float32 and np.all(np.abs(o - exact) <= bound)
        np.testing.assert_array_equal(o, outs[0])
    assert rt.get(ws[0].last_op_event.remote(), timeout=60)["codec"] == "int8"
    benign = [np.abs(rng.randn(n)).astype(np.float32) + 1.0 for _ in range(4)]
    outs = run(ws, "allreduce", [(p,) for p in benign])
    np.testing.assert_allclose(outs[0], np.sum(np.stack(benign), axis=0),
                               rtol=jquant.QUANT_RTOL)
    small = [rng.randn(2048).astype(np.float32) for _ in range(4)]
    outs = run(ws, "allreduce", [(p,) for p in small])
    for o in outs:
        np.testing.assert_array_equal(o, np.sum(np.stack(small), axis=0))
    teardown(ws)


def test_flat_override_keeps_v1_planes(cluster):
    ws = spawn(4, "t_flat", env={"RAY_TPU_COLLECTIVE_ALGO": "flat"})
    parts = [np.full((220, 220), float(i + 1), np.float32) for i in range(4)]
    outs = run(ws, "allreduce", [(p,) for p in parts])
    for o in outs:
        np.testing.assert_array_equal(o, np.sum(np.stack(parts), axis=0))
    assert rt.get(ws[0].last_op_event.remote(), timeout=60)["algo"] != "hier"
    outs = run(ws, "reducescatter", [(p,) for p in parts])
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o, np.array_split(np.sum(np.stack(parts), axis=0), 4)[r])
    outs = run(ws, "broadcast", [(p, 1) for p in parts])
    for o in outs:
        np.testing.assert_array_equal(o, parts[1])
    assert rt.get(ws[0].last_op_event.remote(), timeout=60)["algo"] != "hier"
    teardown(ws)


@pytest.mark.parametrize("nbytes,route", [(16, "channel"), (8 << 20, "pipe")])
def test_two_ranks(cluster, nbytes, route):
    """Two ranks: every op against numpy on the route the table gives
    (the 8 MiB allreduce's event names ``pipe``); reducescatter and
    broadcast on the arena, send/recv and a barrier on the object path;
    rank 1 hands in a CPU torch tensor and gets numpy back."""
    ws = spawn(2, f"t_two_{route}")
    n = nbytes // 4
    parts = [np.arange(n, dtype=np.float32) * (r + 1) for r in range(2)]
    for op in ("sum", "max"):
        outs = run(ws, "allreduce", [(parts[0], op), (parts[1], op, "torch")])
        for o in outs:
            assert isinstance(o, np.ndarray)
            np.testing.assert_array_equal(o, REDUCERS[op](np.stack(parts)))
    if route == "pipe":
        assert rt.get(ws[0].last_op_event.remote(), timeout=60)["algo"] == "pipe"
    outs = run(ws, "allgather", [(p,) for p in parts])
    for o in outs:
        np.testing.assert_array_equal(o[0], parts[0])
        np.testing.assert_array_equal(o[1], parts[1])
    rs = [np.arange(12, dtype=np.float32).reshape(6, 2) * (r + 1) for r in range(2)]
    outs = run(ws, "reducescatter", [(a,) for a in rs])
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o, np.array_split(rs[0] + rs[1], 2)[r])
    outs = run(ws, "broadcast", [(np.full((2,), float(r)), 1) for r in range(2)])
    for o in outs:
        np.testing.assert_array_equal(o, np.full((2,), 1.0))
    sent = rt.get([ws[0].send.remote(np.array([42.0]), 1), ws[1].recv.remote(0)], timeout=60)
    assert sent[0] is True and float(sent[1][0]) == 42.0
    assert run(ws, "barrier", [(), ()]) == [True, True]
    teardown(ws)
