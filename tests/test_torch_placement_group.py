"""The port's placement groups (ray_tpu_torch.util, util.gpu) held against
the JAX package's (ray_tpu.util, util/tpu.py) on the CPU.

The cases of tests/test_placement_group.py's TestPlacementGroup run as
functions of a package ``rt`` on one cluster of each package
(module-scoped; JAX's with the cyclic collector paused, ROADMAP.md Queue
C), with equal outcomes. The port's cluster advertises four fake cards
(``RAY_TPU_FAKE_GPUS=4``), the counterpart of JAX's fake chips: a
``num_gpus=1`` actor in a ``{"GPU": 1}`` bundle sees that bundle's card
in ``CUDA_VISIBLE_DEVICES`` (JAX's ``TPU_VISIBLE_CHIPS`` case), and two
``SlicePlacementGroup``s of two cards each hold disjoint cards. Then
``host_group_specs`` against JAX's, the TPU names that raise, and
``drain`` on a one-node group, read back from the GCS's own node table
(JAX's ``drain`` raises a TypeError on any group, ROADMAP.md Queue C).
"""

import contextlib
import gc
import os
import time
from concurrent.futures import ThreadPoolExecutor

import pytest

import ray_tpu
import ray_tpu.util
import ray_tpu_torch
import ray_tpu_torch.util
from ray_tpu_torch.accelerators.gpu import FAKE_GPUS_ENV

PACKAGES = (ray_tpu, ray_tpu_torch)


@contextlib.contextmanager
def collector_paused():
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


@pytest.fixture(scope="module")
def clusters():
    before = os.environ.get(FAKE_GPUS_ENV)
    os.environ[FAKE_GPUS_ENV] = "4"
    try:
        with collector_paused():
            for rt in PACKAGES:
                rt.init(num_cpus=4)
            refs = [(rt, rt.remote(lambda: 1).remote()) for rt in PACKAGES]
            assert [rt.get(r, timeout=120) for rt, r in refs] == [1, 1]
            yield
            for rt in PACKAGES:
                rt.shutdown()
    finally:
        if before is None:
            os.environ.pop(FAKE_GPUS_ENV, None)
        else:
            os.environ[FAKE_GPUS_ENV] = before


def outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the outcome is the exception
        return (type(e).__name__, str(e))


# ---- TestPlacementGroup --------------------------------------------------------
def create_ready_remove(rt):
    pg = rt.util.placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
    ready = pg.ready(timeout=30)
    table = rt.util.placement_group_table(pg)
    rt.util.remove_placement_group(pg)
    return ready, pg.bundle_count, pg.bundle_specs, table["state"], len(pg.id)


def infeasible_not_ready(rt):
    pg = rt.util.placement_group([{"CPU": 64}], strategy="PACK")
    ready = pg.ready(timeout=2)
    rt.util.remove_placement_group(pg)
    return ready


def actor_in_bundle(rt):
    pg = rt.util.placement_group([{"CPU": 1}], strategy="PACK")
    assert pg.ready(timeout=30)

    @rt.remote
    class A:
        def ping(self):
            return "pong"

    a = A.options(scheduling_strategy=rt.util.PlacementGroupSchedulingStrategy(
        placement_group=pg, placement_group_bundle_index=0)).remote()
    try:
        return rt.get(a.ping.remote(), timeout=60)
    finally:
        rt.kill(a)
        rt.util.remove_placement_group(pg)


def bundle_resources_capacity(rt):
    """Tasks in a 1-CPU bundle can't exceed the bundle's capacity: 3
    tasks of 0.5 s serialize (>= ~1.5 s)."""
    pg = rt.util.placement_group([{"CPU": 1}], strategy="PACK")
    assert pg.ready(timeout=30)

    @rt.remote
    def f():
        import time as _time

        _time.sleep(0.5)
        return 1

    strat = rt.util.PlacementGroupSchedulingStrategy(placement_group=pg)
    t0 = time.monotonic()
    out = rt.get([f.options(scheduling_strategy=strat).remote() for _ in range(3)],
                 timeout=120)
    serialized = time.monotonic() - t0 >= 1.2
    rt.util.remove_placement_group(pg)
    return out, serialized


def validation(rt):
    return [outcome(lambda: rt.util.placement_group([], strategy="PACK")),
            outcome(lambda: rt.util.placement_group([{"CPU": 1}], strategy="DIAGONAL"))]


CASES = [create_ready_remove, infeasible_not_ready, actor_in_bundle,
         bundle_resources_capacity, validation]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_same_outcome_as_jax(clusters, case):
    """Each package's run of the case on a thread of its own, side by
    side (the cases wait on timeouts and sleeps)."""
    with ThreadPoolExecutor(2) as pool:
        ref, port = pool.map(lambda rt: outcome(lambda: case(rt)), PACKAGES)
    assert ref[0] == "ok", ref
    assert port == ref


def test_util_exports_the_jax_packages_names():
    assert ray_tpu_torch.util.__all__ == ray_tpu.util.__all__
    assert all(hasattr(ray_tpu_torch.util, n) for n in ray_tpu_torch.util.__all__)


# ---- cards in bundles ------------------------------------------------------------
def _card_actor(rt):
    @rt.remote
    class HostWorker:
        def cards(self):
            import os as _os

            return (_os.environ.get("CUDA_VISIBLE_DEVICES"),
                    rt.get_runtime_context().get_assigned_resources()["gpu_ids"])

    return HostWorker


def test_actor_in_a_gpu_bundle_sees_the_bundles_card(clusters):
    """Two ``{"GPU": 1}`` bundles take cards 0 and 1; an actor leasing
    ``num_gpus=1`` in bundle i sees bundle i's card, and one outside the
    group gets a card the bundles do not hold."""
    rt = ray_tpu_torch
    pg = rt.util.placement_group([{"CPU": 1, "GPU": 1}, {"CPU": 1, "GPU": 1}],
                                 strategy="STRICT_PACK")
    assert pg.ready(timeout=30)
    HostWorker = _card_actor(rt)
    actors = [HostWorker.options(num_gpus=1, scheduling_strategy=(
        rt.util.PlacementGroupSchedulingStrategy(pg, placement_group_bundle_index=i)))
        .remote() for i in range(2)]
    outside = HostWorker.options(num_gpus=1).remote()
    try:
        got = rt.get([a.cards.remote() for a in actors + [outside]], timeout=120)
        assert got[:2] == [("0", [0]), ("1", [1])]
        assert got[2][0] in ("2", "3") and got[2][1] == [int(got[2][0])]
    finally:
        for a in actors + [outside]:
            rt.kill(a)
        rt.util.remove_placement_group(pg)


def test_a_removed_groups_leased_card_stays_leased(clusters):
    """Removing a group whose actor still holds the bundle's card gives
    back the rest of the bundle, not that card: the other three cards go
    to three new leases, a fourth waits, and gets the card once the
    actor is gone. (The raylet returned the whole bundle, so that card
    was handed out twice: two groups of two cards made after the first
    test of this file saw the same two cards.)"""
    rt = ray_tpu_torch
    HostWorker = _card_actor(rt)
    pg = rt.util.placement_group([{"CPU": 1, "GPU": 1}])
    assert pg.ready(timeout=30)
    a = HostWorker.options(num_gpus=1, scheduling_strategy=(
        rt.util.PlacementGroupSchedulingStrategy(pg, 0))).remote()
    others = []
    try:
        held = rt.get(a.cards.remote(), timeout=60)[1]
        rt.util.remove_placement_group(pg)
        others = [HostWorker.options(num_gpus=1).remote() for _ in range(4)]
        calls = [w.cards.remote() for w in others]
        done, waiting = rt.wait(calls, num_returns=3, timeout=60)
        assert len(done) == 3
        cards = [c for _, ids in rt.get(done) for c in ids]
        assert sorted(cards + held) == [0, 1, 2, 3]
        assert rt.wait(waiting, timeout=1.0)[0] == []  # no fifth card
        rt.kill(a)
        assert rt.get(waiting[0], timeout=60)[1] == held
    finally:
        for w in [a] + others:
            rt.kill(w)


def test_slice_placement_groups_hold_disjoint_cards(clusters):
    """Two one-host slices of two cards each: ``ready``, one worker each
    (``num_workers``), each worker's two cards its own; once removed the
    cards are free again for a third."""
    from ray_tpu_torch.util.gpu import SlicePlacementGroup

    rt = ray_tpu_torch
    spgs = [SlicePlacementGroup(gpus_per_host=2, name=f"s{i}") for i in range(2)]
    assert all(s.ready(timeout=30) for s in spgs)
    assert [(s.num_workers, s.placement_group.bundle_specs) for s in spgs] == [
        (1, [{"CPU": 1.0, "GPU": 2.0}])] * 2
    HostWorker = _card_actor(rt)
    workers = [HostWorker.options(num_gpus=2, scheduling_strategy=(
        rt.util.PlacementGroupSchedulingStrategy(s.placement_group, 0))).remote()
        for s in spgs]
    try:
        got = rt.get([w.cards.remote() for w in workers], timeout=120)
    finally:
        for w in workers:
            rt.kill(w)
        for s in spgs:
            s.remove()
    cards = [set(v.split(",")) for v, _ in got]
    assert [len(c) for c in cards] == [2, 2] and not cards[0] & cards[1], got
    assert cards[0] | cards[1] == {"0", "1", "2", "3"}
    third = SlicePlacementGroup(num_hosts=1, gpus_per_host=4)
    try:
        assert third.ready(timeout=30)
    finally:
        third.remove()


def test_host_group_specs_match_jax():
    """One slice of one host: the same bootstrap spec as JAX's for its
    counterpart (the spec itself is the port's HostGroupSpec); TPU names
    raise, naming the rename or ROADMAP.md's row."""
    from ray_tpu.util.tpu import SlicePlacementGroup as JSlice
    from ray_tpu.util.tpu import SliceInfo

    from ray_tpu_torch.util.gpu import SlicePlacementGroup, SliceInfo as TSliceInfo
    from ray_tpu_torch.util.gpu import get_tpu_coordinator_env_vars

    j = JSlice.__new__(JSlice)
    j.info = SliceInfo(pod_type="v5litepod-4", num_hosts=1, chips_per_host=4)
    j._pgs = []
    t = SlicePlacementGroup.__new__(SlicePlacementGroup)
    t.info = TSliceInfo(num_hosts=1, gpus_per_host=4)
    t._pgs = []
    want = [vars(s) for s in j.host_group_specs("10.0.0.1:8476")]
    got = [vars(s) for s in t.host_group_specs("10.0.0.1:8476")]
    assert got == want
    t.info = TSliceInfo(num_hosts=2, gpus_per_host=8)
    assert [(s.process_id, s.num_processes) for s in t.host_group_specs("h:1")] == [(0, 2),
                                                                                   (1, 2)]
    with pytest.raises(ValueError, match="names a TPU slice"):
        SlicePlacementGroup("v5litepod-16")
    with pytest.raises(NotImplementedError, match="Queue A item 7, 'multi-slice megascale_env'"):
        SlicePlacementGroup(gpus_per_host=1, num_slices=2)
    with pytest.raises(NotImplementedError, match="Queue A item 7, 'multi-slice megascale_env'"):
        get_tpu_coordinator_env_vars(got and t.host_group_specs("h:1")[0])


def test_drain_marks_the_groups_node_draining(clusters, tmp_path):
    """``drain`` reads the group by its ID object and drains its node:
    the GCS's node table then holds that node draining for preemption
    (last in the file: the node takes no new work after it). A task runs
    on the node until the table is read, so the drain cannot finish (and
    the node leave the table's draining state) before it is read."""
    from ray_tpu_torch._private.drain import REASON_PREEMPTION
    from ray_tpu_torch.util.gpu import SlicePlacementGroup

    rt = ray_tpu_torch
    running, release = tmp_path / "running", tmp_path / "release"

    @rt.remote
    def hold():
        running.touch()
        deadline = time.monotonic() + 60
        while not release.exists() and time.monotonic() < deadline:
            time.sleep(0.05)

    spg = SlicePlacementGroup(gpus_per_host=1)
    assert spg.ready(timeout=30)
    info = rt.util.placement_group_table(spg.placement_group)
    node = info["bundle_nodes"][0]
    held = hold.remote()
    deadline = time.monotonic() + 60
    while not running.exists():
        assert time.monotonic() < deadline, "the holding task never started"
        time.sleep(0.05)
    try:
        drained = spg.drain(deadline_s=60)
        assert drained == [node]
        table = {n["NodeID"]: n for n in rt.nodes()}
        assert table[node]["Draining"] and table[node]["DrainReason"] == REASON_PREEMPTION, \
            table[node]
    finally:
        release.touch()
    assert rt.get(held, timeout=60) is None
    spg.remove()
