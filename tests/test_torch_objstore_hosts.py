"""The OBJSTORE backend's full hierarchy on the port's cluster, across two
fake hosts of one box (``RAY_TPU_COLLECTIVE_TOPOLOGY_KEY``), and the
rendezvous directory's garbage collection (tests/test_collective_v2.py
TestFakeMultiHost and TestRendezvousGC): the cross-host exact sum within
float reassociation of numpy's and identical on every rank, integer sums
bit-identical, broadcasts from several sources, true reducescatter; the
int8 route within the JAX package's stated multi-host bound; the
watermark GC of late collectors, subgroup collects, a new incarnation of
a named rendezvous, the bounded-directory assert, p2p keys exempt from
it; and a 4-rank group's directory bounded after a burst of ops.
"""

import numpy as np
import pytest

import ray_tpu_torch as rt
from objstore_ref import host_envs, run, spawn, teardown
from ray_tpu.util.collective.v2 import quant as jquant
from ray_tpu_torch.util.collective.objstore_group import _Rendezvous


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4)
    try:
        yield
    finally:
        rt.shutdown()


def test_exact_across_fake_hosts(cluster):
    ws = spawn(4, "t_xh", envs=host_envs())
    rng = np.random.RandomState(6)
    parts = [rng.randn(320, 320).astype(np.float32) for _ in range(4)]
    outs = run(ws, "allreduce", [(p,) for p in parts])
    for o in outs:
        np.testing.assert_allclose(o, np.sum(np.stack(parts), axis=0), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(o, outs[0])
    ints = [np.full((320, 320), 3 * (i + 1), np.int32) for i in range(4)]
    for o in run(ws, "allreduce", [(p,) for p in ints]):
        np.testing.assert_array_equal(o, np.sum(np.stack(ints), axis=0))
    for src in (0, 1, 3):
        outs = run(ws, "broadcast", [(np.full((320, 320), float(i), np.float32), src)
                                     for i in range(4)])
        for o in outs:
            np.testing.assert_array_equal(o, np.full((320, 320), float(src), np.float32))
    ev = rt.get(ws[0].last_op_event.remote(), timeout=60)
    assert ev["algo"] == "hier" and "xh" in ev["phases"]
    rs_in = [rng.randn(12, 5).astype(np.float32) for _ in range(4)]
    outs = run(ws, "reducescatter", [(p,) for p in rs_in])
    ref = np.array_split(np.sum(np.stack(rs_in), axis=0), 4, axis=0)
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o, ref[r])
    teardown(ws)


def test_quant_across_fake_hosts_within_bound(cluster):
    extra = {"RAY_TPU_COLLECTIVE_QUANT": "int8", "RAY_TPU_COLLECTIVE_QUANT_MIN_BYTES": "65536",
             "RAY_TPU_COLLECTIVE_QUANT_BLOCK": "128"}
    ws = spawn(4, "t_xhq", envs=host_envs(extra))
    rng = np.random.RandomState(7)
    parts = [(rng.randn(64 << 10) * 50).astype(np.float32) for _ in range(4)]
    parts[0][123] = 5e6
    outs = run(ws, "allreduce", [(p,) for p in parts])
    exact = np.sum(np.stack(parts), axis=0)
    bound = jquant.sum_error_bound(parts, 128, steps=jquant.QUANT_STEPS_MULTI_HOST)
    for o in outs:
        assert np.all(np.abs(o - exact) <= bound)
        np.testing.assert_array_equal(o, outs[0])
    assert rt.get(ws[0].last_op_event.remote(), timeout=60)["codec"] == "int8"
    teardown(ws)


def get(ref):
    return rt.get(ref, timeout=30)


def test_gc_contract(cluster):
    # (a) ranks 0 and 1 collect seq 0, rank 2 abandons it
    r = _Rendezvous.remote(3)
    for rank in range(3):
        get(r.put.remote("k", 0, rank, rank))
    assert get(r.collect.remote("k", 0, 0)) is not None
    assert get(r.collect.remote("k", 0, 1)) is not None
    assert get(r.directory_stats.remote())["per_key"].get("k") == 1
    for rank in range(3):
        get(r.put.remote("k", 1, rank, 10 + rank))
    for rank in range(3):
        assert get(r.collect.remote("k", 1, rank)) is not None
    assert get(r.directory_stats.remote())["live_slots"] == 0
    # (b) a subgroup collect gcs too
    r = _Rendezvous.remote(4)
    for rank in (1, 3):
        get(r.put.remote("xh", 0, rank, rank))
    assert get(r.collect.remote("xh", 0, 1, [1, 3])) == [1, 3]
    assert get(r.collect.remote("xh", 0, 3, [1, 3])) == [1, 3]
    assert get(r.directory_stats.remote())["live_slots"] == 0
    # (c) a new incarnation restarts at seq 0; a p2p send made before its
    # first collective survives the reset
    r = _Rendezvous.remote(2)
    for seq in range(3):
        for rank in range(2):
            get(r.put.remote("k", seq, rank, rank))
        for rank in range(2):
            assert get(r.collect.remote("k", seq, rank)) is not None
    get(r.put.remote("p2p_0_1", 0, 0, "msg"))
    get(r.put.remote("k", 0, 0, "fresh0"))
    get(r.put.remote("k", 0, 1, "fresh1"))
    assert get(r.collect.remote("k", 0, 0)) == ["fresh0", "fresh1"]
    assert get(r.collect_from.remote("p2p_0_1", 0, 0)) == "msg"
    # (d) a leak trips the bounded-directory assert
    r = _Rendezvous.remote(2)
    with pytest.raises(Exception, match="leaking"):
        for seq in range(2 * 2 + 10):
            get(r.put.remote("leak", seq, 0, seq))
    # (e) p2p keys are exempt: a sender may run ahead of its receiver
    r = _Rendezvous.remote(2)
    for seq in range(2 * 2 + 10):
        get(r.put.remote("p2p_0_1", seq, 0, seq))
    for seq in range(2 * 2 + 10):
        assert get(r.collect_from.remote("p2p_0_1", seq, 0)) == seq
    assert get(r.directory_stats.remote())["live_slots"] == 0


def test_group_directory_stays_bounded(cluster):
    ws = spawn(4, "t_gc", envs=host_envs())
    arr = np.ones((320, 320), np.float32)
    for _ in range(2):
        run(ws, "allreduce", [(arr,)] * 4)
        run(ws, "broadcast", [(arr, 0)] * 4)
    stats = get(rt.get_actor("__collective_rdv_t_gc").directory_stats.remote())
    for key, live in stats["per_key"].items():
        assert live <= 2 * 4 + 8, (key, stats)
    teardown(ws)
