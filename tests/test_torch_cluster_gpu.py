"""Card leases on the port's cluster, with ``RAY_TPU_FAKE_GPUS=2``.

The raylet leases "GPU" as instances, as JAX's leases TPU chips: a
``num_gpus=1`` task or actor gets one card id, its worker's
``CUDA_VISIBLE_DEVICES`` names it before user code runs, and
``get_runtime_context().get_assigned_resources()["gpu_ids"]`` reports it.
A request that finds no free card waits for one. A worker keeps the card
set of its first lease. There is no card here: the driver counts two
through ``RAY_TPU_FAKE_GPUS``, and no worker calls CUDA.
"""

import os
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.accelerators.gpu import FAKE_GPUS_ENV


@pytest.fixture(scope="module")
def cluster():
    """Two fake cards, and no CUDA_VISIBLE_DEVICES for the cluster to
    inherit (a worker maps its lease's ids through that list)."""
    before = {k: os.environ.pop(k, None) for k in (FAKE_GPUS_ENV, "CUDA_VISIBLE_DEVICES")}
    os.environ[FAKE_GPUS_ENV] = "2"
    try:
        rt.init(num_cpus=4)
    finally:
        os.environ.pop(FAKE_GPUS_ENV)
        os.environ.update({k: v for k, v in before.items() if v is not None})
    yield
    rt.shutdown()


@rt.remote(num_gpus=1)
def lease(hold_s):
    """What the lease looks like from inside, and when it ran."""
    import torch

    start = time.time()
    ctx = (os.environ["CUDA_VISIBLE_DEVICES"],
           rt.get_runtime_context().get_assigned_resources()["gpu_ids"],
           torch.cuda.is_initialized(), os.getpid())
    time.sleep(hold_s)
    return ctx + (start, time.time())


@rt.remote(num_gpus=1)
class Holder:
    def card(self):
        return os.environ["CUDA_VISIBLE_DEVICES"], \
            rt.get_runtime_context().get_assigned_resources()["gpu_ids"]


def test_two_cards_advertised(cluster):
    assert rt.cluster_resources()["GPU"] == 2.0
    assert rt.available_resources()["GPU"] == 2.0


def test_leases_get_distinct_cards_and_a_third_waits(cluster):
    out = rt.get([lease.remote(1.5) for _ in range(3)], timeout=90)
    for visible, ids, initialized, *_ in out:
        assert visible == ",".join(map(str, ids)) and len(ids) == 1
        assert initialized is False
    first, second, third = sorted(out, key=lambda r: r[4])
    # the first two ran at once, on the two cards
    assert {first[0], second[0]} == {"0", "1"}
    assert second[4] < first[5]
    # the third started only once one of them had ended, on its card
    assert third[4] >= min(first[5], second[5]) - 0.05
    assert third[0] == (first if first[5] <= second[5] else second)[0]


def test_a_worker_keeps_its_card(cluster):
    """Many short leases: each worker process only ever saw one card set."""
    seen = {}
    for visible, _, _, pid, *_ in rt.get([lease.remote(0.05) for _ in range(12)], timeout=90):
        seen.setdefault(pid, set()).add(visible)
    assert all(len(v) == 1 for v in seen.values())

    @rt.remote
    def no_card():
        return os.environ["CUDA_VISIBLE_DEVICES"], os.getpid()

    cpu = rt.get([no_card.remote() for _ in range(6)], timeout=90)
    assert {v for v, _ in cpu} == {""}
    assert not {p for _, p in cpu} & set(seen)


def test_an_actor_holds_its_card_until_killed(cluster):
    a, b = Holder.remote(), Holder.remote()
    cards = rt.get([a.card.remote(), b.card.remote()], timeout=90)
    assert sorted(c for c, _ in cards) == ["0", "1"]
    assert [c for c, _ in cards] == [",".join(map(str, ids)) for _, ids in cards]
    c = Holder.remote()
    pending = c.card.remote()
    ready, _ = rt.wait([pending], timeout=3)
    assert ready == []  # both cards are held
    rt.kill(a)
    visible, ids = rt.get(pending, timeout=90)
    assert visible == cards[0][0] and ids == cards[0][1]  # a's card, freed
    for h in (b, c):
        rt.kill(h)


def test_fractional_cards_refused(cluster):
    with pytest.raises(ValueError, match="whole cards"):
        lease.options(num_gpus=0.5).remote(0)
    with pytest.raises(ValueError, match="whole cards"):
        Holder.options(num_gpus=1.5).remote()
