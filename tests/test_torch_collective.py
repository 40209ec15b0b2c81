"""The port's collective API (ray_tpu_torch.util.collective) and bootstrap
(ray_tpu_torch.parallel.bootstrap) held against numpy and the JAX package.

Four spawned gloo ranks, brought up through the port's
``local_process_specs`` + ``initialize_host``, run every op and ReduceOp
(tests/torch_ranks.py ``collectives``); each result is held against
numpy on the same inputs, including the cases where the JAX package's
XLAGroup is quirky (reducescatter MIN and PRODUCT, broadcast from a
src_rank other than 0). In the pytest process a world of one with a list
of 8 parts is held against XLAGroup on the 8 CPU devices, in the cases
where XLAGroup is not quirky. fp32 sums: 1e-6 relative (summation
order); max, min and broadcast exact.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ray_tpu.parallel import bootstrap as jbootstrap
from ray_tpu.util.collective.types import ReduceOp as JReduceOp
from ray_tpu.util.collective.xla_group import XLAGroup
from ray_tpu_torch.parallel import bootstrap
from ray_tpu_torch.util import collective as col
from tests.torch_ranks import BOOTSTRAP, World, collective_input

WORLD = 4
SEED = 3
NP_OPS = {"sum": lambda a: a.sum(0), "product": lambda a: a.prod(0),
          "max": lambda a: a.max(0), "min": lambda a: a.min(0),
          "mean": lambda a: a.mean(0)}


def close(a, b):
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def ranks_raw(tmp_path_factory):
    world = World(WORLD, tmp_path_factory.mktemp("collective"))
    try:
        specs = bootstrap.local_process_specs(WORLD)
        world.send({BOOTSTRAP: specs, "ops": ("collectives", {"seed": SEED})})
        yield world.results(), specs
    finally:
        world.stop()


@pytest.fixture
def ranks(ranks_raw):
    """Each rank's results of the ``collectives`` case, and the specs."""
    results, specs = ranks_raw
    return [r["ops"] for r in results], specs


def inputs():
    return np.stack([collective_input(SEED, r) for r in range(WORLD)])  # [W, 8, 3]


def parts():
    """Every rank's two parts, in global order: [W * 2, 8, 3]."""
    return np.stack([p for x in inputs() for p in (x, 2 * x)])


def test_bring_up_through_initialize_host(ranks_raw):
    results, specs = ranks_raw
    assert [r["jax_imported"] for r in results] == [[]] * WORLD
    out = [r["ops"] for r in results]
    assert [s.process_id for s in specs] == list(range(WORLD))
    assert len({s.coordinator_address for s in specs}) == 1
    assert all(s.num_processes == WORLD for s in specs)
    for r, o in enumerate(out):
        assert o["rank"] == (r, WORLD, True, -1)


@pytest.mark.parametrize("op", list(NP_OPS))
def test_allreduce_matches_numpy(ranks, op):
    out, _ = ranks
    want, want_parts = NP_OPS[op](inputs()), NP_OPS[op](parts())
    for o in out:
        close(o[("allreduce", op)], want)
        close(o[("allreduce_parts", op)], want_parts)


@pytest.mark.parametrize("op", list(NP_OPS))
def test_reducescatter_matches_numpy(ranks, op):
    """Rank r gets chunk r of the op over the ranks' inputs; with two
    parts a rank it gets its two rows of the [n, chunk] view. MIN and
    PRODUCT reduce as themselves (XLAGroup reduces both as max)."""
    out, _ = ranks
    red, red_parts = NP_OPS[op](inputs()), NP_OPS[op](parts())
    for r, o in enumerate(out):
        close(o[("reducescatter", op)], red.reshape(WORLD, 1, 2, 3)[r])
        close(o[("reducescatter_parts", op)], red_parts.reshape(2 * WORLD, 1, 3)[2 * r:2 * r + 2])


def test_allgather_broadcast_send_recv_match_numpy(ranks):
    out, _ = ranks
    x = inputs()
    for r, o in enumerate(out):
        np.testing.assert_array_equal(o["allgather"], x)
        np.testing.assert_array_equal(o["allgather_parts"], parts())
        np.testing.assert_array_equal(o["allreduce_int"],
                                      sum(np.arange(4, dtype=np.int32) + q for q in range(WORLD)))
        assert o["allreduce_int"].dtype == np.int32
        np.testing.assert_array_equal(o["broadcast"], x[2])  # src_rank=2, not 0
        np.testing.assert_array_equal(o["recv"], x[(r - 1) % WORLD][(r - 1) % WORLD])
        assert o["x_unchanged"]


def test_async_allreduce_keeps_order_and_snapshots(ranks):
    out, _ = ranks
    x = inputs()
    for o in out:
        first, mid, last, done = o["async"]
        close(first, x.sum(0))  # the buffer was zeroed after submission
        close(mid, (3 * x).max(0))
        close(last, (5 * x).min(0))
        assert done


def test_destroy_reinit_and_typed_errors(ranks):
    out, _ = ranks
    for r, o in enumerate(out):
        assert o["destroyed"] == (False, -1)
        close(o["remade"], inputs().sum(0))
        e = o["errors"]
        assert e["uninitialized"][0] == "RuntimeError" and "'nope'" in e["uninitialized"][1]
        for name in ("wrong_rank", "too_big"):
            assert e[name][0] == "CollectiveError" and "initialize_host" in e[name][1]
        assert e["twice"][0] == "RuntimeError" and "already initialized" in e["twice"][1]
        for name in ("objstore", "actors"):
            assert e[name][0] == "NotImplementedError" and "ROADMAP" in e[name][1]
        assert e["reducescatter_shape"][0] == "ValueError"
        assert not o["c_initialized"]


@pytest.fixture
def world_of_one():
    """Groups of a world of one in the pytest process: the group brings
    up its own default process group and takes it down with the last
    group."""
    assert not dist.is_initialized()
    names = []
    yield names
    for n in names:
        col.destroy_collective_group(n)
    assert not dist.is_initialized()


def test_world_of_one_matches_xla_group(world_of_one):
    """A list of 8 parts against XLAGroup over the 8 CPU devices: SUM,
    MAX, MIN and MEAN allreduce, allgather and SUM reducescatter (where
    XLAGroup is not quirky)."""
    rng = np.random.RandomState(0)
    xs = [rng.standard_normal((16, 3)).astype(np.float32) for _ in range(8)]
    xla = XLAGroup(1, 0)
    col.init_collective_group(1, 0, "gloo", "one")
    world_of_one.append("one")
    for op in ("sum", "max", "min", "mean"):
        close(col.allreduce(xs, "one", op).numpy(),
              np.asarray(xla.allreduce(xs, JReduceOp(op))))
    np.testing.assert_array_equal(col.allgather(xs, "one").numpy(), np.asarray(xla.allgather(xs)))
    rs = col.reducescatter(xs, "one").numpy()
    assert rs.shape == (8, 2, 3)
    close(rs, np.asarray(xla.reducescatter(xs, JReduceOp.SUM)))
    # one tensor is one part, as XLAGroup's [None] stack
    close(col.allreduce(xs[0], "one").numpy(), np.asarray(xla.allreduce(xs[0])))
    np.testing.assert_array_equal(col.allgather(xs[0], "one").numpy(),
                                  np.asarray(xla.allgather(xs[0])))


def test_world_of_one_groups_share_and_release_the_default(world_of_one):
    col.init_collective_group(1, 0, "gloo", "p")
    col.init_collective_group(1, 0, "gloo", "q")
    assert dist.is_initialized()
    col.destroy_collective_group("p")
    assert dist.is_initialized()  # "q" still stands on it
    np.testing.assert_array_equal(col.allreduce(torch.ones(2), "q").numpy(), [1, 1])
    col.destroy_collective_group("q")
    assert not dist.is_initialized()
    world_of_one.append("r")
    col.init_collective_group(1, 0, "gloo", "r")
    np.testing.assert_array_equal(col.broadcast(np.arange(3), 0, "r").numpy(), [0, 1, 2])


def test_without_a_process_group_a_world_of_two_names_initialize_host():
    assert not dist.is_initialized()
    with pytest.raises(col.CollectiveError, match="initialize_host"):
        col.init_collective_group(2, 0, "gloo", "two")
    assert not col.is_group_initialized("two") and not dist.is_initialized()


def test_host_group_spec_fields_equal_jax():
    ours = [(f.name, f.default) for f in dataclasses.fields(bootstrap.HostGroupSpec)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(jbootstrap.HostGroupSpec)]
    assert ours == theirs


def test_bootstrap_single_process_and_megascale():
    spec = bootstrap.local_process_specs(1)[0]
    assert (spec.num_processes, spec.process_id) == (1, 0)
    bootstrap.initialize_host(spec, "gloo")  # a world of one needs no rendezvous
    bootstrap.initialize_host(spec, "gloo")  # idempotent
    assert not dist.is_initialized()
    bootstrap.shutdown_host()
    assert bootstrap.megascale_env(spec) == {} == jbootstrap.megascale_env(
        jbootstrap.HostGroupSpec(**dataclasses.asdict(spec)))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        bootstrap.megascale_env(dataclasses.replace(spec, num_slices=2))
    specs = bootstrap.local_process_specs(3, port=29999)
    assert [s.coordinator_address for s in specs] == ["127.0.0.1:29999"] * 3
