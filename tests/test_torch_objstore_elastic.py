"""The OBJSTORE backend's fault model on the port's cluster
(tests/test_collective_elastic.py's tier-1 cases), across two fake
hosts: a rank that dies (``RAY_TPU_COLLECTIVE_CHAOS_DIE``, the
executor's ``_chaos`` hook) at the encode or the gather phase leaves
every survivor with the full sum or a typed ``CollectiveError``, never
a partial sum nor a hang, and a retry completes exactly over the
survivors at a bumped epoch; a rank killed mid-op is named by a
``CollectiveRankFailure`` well within the op deadline; async allreduces
keep FIFO order and snapshot their input; the overlapped chunked path is
bit-identical to the barriered one; the simulated WAN cap keeps results
exact. The typed errors reach the driver typed, through ``rt.get``.
"""

import time

import numpy as np
import pytest

import ray_tpu_torch as rt
from objstore_ref import host_envs, run, spawn, teardown
from ray_tpu_torch.exceptions import GetTimeoutError
from ray_tpu_torch.util.collective import (
    CollectiveError,
    CollectiveHandle,
    CollectiveRankFailure,
)

OP_TIMEOUT = 8.0


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4)
    try:
        yield
    finally:
        rt.shutdown()


def survivors_recover(surv, parts):
    """Survivors retry until a degraded allreduce completes, exactly over
    the survivor set."""
    surv_sum = np.sum(np.stack(parts[:len(surv)]), axis=0)
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        futs = [w.allreduce.remote(p) for w, p in zip(surv, parts)]
        try:
            res = [rt.get(f, timeout=2 * OP_TIMEOUT + 14) for f in futs]
        except Exception as e:  # noqa: BLE001 — a typed retry signal
            assert isinstance(e, CollectiveError), repr(e)
            continue
        for o in res:
            np.testing.assert_array_equal(o, surv_sum)
        return True
    return False


@pytest.mark.parametrize("phase", ["encode", "gather"])
def test_rank_death_at_phase(cluster, phase):
    per_rank = {3: {"RAY_TPU_COLLECTIVE_CHAOS_DIE": f"allreduce:{phase}"}}
    ws = spawn(4, f"t_chaos_{phase}", envs=host_envs(per_rank=per_rank, op_timeout="8"))
    parts = [np.full((320, 320), float(r + 1), np.float32) for r in range(4)]
    full = np.sum(np.stack(parts), axis=0)
    outcomes = []
    for f in [w.allreduce.remote(p) for w, p in zip(ws, parts)]:
        try:
            outcomes.append(("ok", rt.get(f, timeout=2 * OP_TIMEOUT + 14)))
        except Exception as e:  # noqa: BLE001
            outcomes.append(("err", e))
    for _kind, out in outcomes:
        assert not isinstance(out, GetTimeoutError), f"a rank hung at phase {phase}"
    assert outcomes[3][0] == "err", "the chaos rank did not die"
    for kind, out in outcomes[:3]:
        if kind == "ok":
            np.testing.assert_array_equal(out, full)
        else:
            assert isinstance(out, CollectiveError), repr(out)
    surv = ws[:3]
    assert survivors_recover(surv, parts), "survivors never completed a degraded allreduce"
    for v in rt.get([w.view.remote() for w in surv], timeout=30):
        assert v["epoch"] >= 1 and v["members"] == [0, 1, 2]
    teardown(surv)


def test_rank_failure_named_within_detection_window(cluster):
    ws = spawn(4, "t_failfast", envs=host_envs(op_timeout="12"))
    parts = [np.full((320, 320), float(r + 1), np.float32) for r in range(4)]
    outs = run(ws, "allreduce", [(p,) for p in parts], timeout=120)
    np.testing.assert_array_equal(outs[0], np.sum(np.stack(parts), axis=0))
    t0 = time.monotonic()
    futs = [w.allreduce.remote(p) for w, p in zip(ws[:3], parts[:3])]  # rank 3 absent
    time.sleep(1.0)
    rt.kill(ws[3])
    named, errs = 0, []
    for f in futs:
        with pytest.raises(Exception) as info:  # noqa: PT011 — typed below
            rt.get(f, timeout=40)
        e = info.value
        errs.append(e)
        assert isinstance(e, CollectiveError), repr(e)
        if isinstance(e, CollectiveRankFailure):
            assert 3 in e.dead_ranks
            named += 1
    assert named >= 1, f"nobody named the dead rank: {errs!r}"
    assert time.monotonic() - t0 < 12 + 14
    assert survivors_recover(ws[:3], parts)
    teardown(ws[:3])


def test_handle_unit_semantics():
    h = CollectiveHandle("allreduce", "g")
    assert not h.done()
    with pytest.raises(TimeoutError):
        h.result(timeout=0.05)
    h._finish(exc=CollectiveRankFailure((1,), 2, "g"))
    assert h.done()
    with pytest.raises(CollectiveRankFailure):
        h.result(timeout=1)
    h2 = CollectiveHandle("allreduce", "g")
    h2._finish(value=5)
    assert h2.result() == 5


def test_async_fifo_order_values_and_snapshot(cluster):
    ws = spawn(4, "t_async")
    arrs = [[np.full((1024,), float((r + 1) * (k + 1)), np.float32) for k in range(3)]
            for r in range(4)]
    outs = run(ws, "async_round", [(arrs[r],) for r in range(4)], timeout=180)
    for k in range(3):
        for r in range(4):
            np.testing.assert_array_equal(outs[r][k], np.full((1024,), float(10 * (k + 1)),
                                                              np.float32))
    for o in run(ws, "async_snapshot", [()] * 4, timeout=120):
        np.testing.assert_array_equal(o, np.full((64,), 4.0, np.float32))
    teardown(ws)


def test_overlapped_matches_barriered_bitwise(cluster):
    rng = np.random.RandomState(11)
    parts = [rng.randn(128 << 10).astype(np.float32) for _ in range(4)]
    results = {}
    for mode, extra in (("overlap", {"RAY_TPU_COLLECTIVE_OVERLAP": "1",
                                     "RAY_TPU_COLLECTIVE_OVERLAP_MIN_BYTES": "32768",
                                     "RAY_TPU_COLLECTIVE_OVERLAP_BLOCK_BYTES": "32768"}),
                        ("barrier", {"RAY_TPU_COLLECTIVE_OVERLAP": "0"})):
        ws = spawn(4, f"t_ovl_{mode}", envs=host_envs(extra, op_timeout="60"))
        outs = run(ws, "allreduce", [(p,) for p in parts])
        for o in outs[1:]:
            np.testing.assert_array_equal(o, outs[0])
        results[mode] = outs[0]
        teardown(ws)
    np.testing.assert_array_equal(results["overlap"], results["barrier"])
    np.testing.assert_allclose(results["overlap"], np.sum(np.stack(parts), axis=0),
                               rtol=1e-5, atol=1e-6)


def test_wan_sim_keeps_results_exact(cluster):
    ws = spawn(4, "t_wan", envs=host_envs({"RAY_TPU_COLLECTIVE_WAN_GBPS": "4"},
                                          op_timeout="60"))
    parts = [np.full((64 << 10,), float(r + 1), np.float32) for r in range(4)]
    for o in run(ws, "allreduce", [(p,) for p in parts]):
        np.testing.assert_array_equal(o, np.sum(np.stack(parts), axis=0))
    teardown(ws)
