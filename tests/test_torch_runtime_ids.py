"""The port's runtime IDs against ray_tpu's, byte for byte.

The random part of each ID (``os.urandom``) is drawn from one seed and fed
to both packages, so the same inputs must give the same bytes.
"""

import os

import numpy as np
import pytest

from ray_tpu._private import fastpath as jax_fastpath
from ray_tpu._private import ids as J
from ray_tpu_torch._private import fastpath as port_fastpath
from ray_tpu_torch._private import ids as P


def seeded_urandom(monkeypatch, seed):
    """Make os.urandom draw from ``seed``; returns a function that restarts
    the stream, so each package's call sees the same bytes."""
    state = {}

    def restart():
        state["rng"] = np.random.default_rng(seed)

    monkeypatch.setattr(os, "urandom", lambda n: state["rng"].bytes(n))
    restart()
    return restart


def both(restart, make):
    out = []
    for mod in (J, P):
        restart()
        out.append(make(mod))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_ids_match_byte_for_byte(monkeypatch, seed):
    restart = seeded_urandom(monkeypatch, seed)
    job_int = int(np.random.default_rng(100 + seed).integers(0, 2**32))
    index = int(np.random.default_rng(200 + seed).integers(0, 2**32))

    def chain(m):
        job = m.JobID.from_int(job_int)
        actor = m.ActorID.of(job)
        normal = m.TaskID.for_normal_task(job)
        actor_task = m.TaskID.for_actor_task(actor)
        creation = m.TaskID.for_actor_creation(actor)
        obj = m.ObjectID.from_index(normal, index)
        ids = [job, actor, normal, actor_task, creation, obj,
               m.ObjectID.from_index(actor_task, 1),
               m.NodeID.from_random(), m.WorkerID.from_random(),
               m.PlacementGroupID.from_random(), m.UniqueID.from_random()]
        derived = (obj.index(), obj.task_id().binary(), normal.job_id().binary(),
                   actor.job_id().binary(), creation.actor_id().binary())
        return [(type(i).__name__, i.binary(), i.hex(), i.is_nil()) for i in ids], derived

    jax_ids, port_ids = both(restart, chain)
    assert port_ids == jax_ids
    ids, _ = port_ids
    assert [len(b) for _, b, _, _ in ids[:6]] == [4, 16, 24, 24, 24, 28]


def test_id_sizes_nil_and_errors():
    for name in ("UniqueID", "JobID", "NodeID", "WorkerID", "PlacementGroupID",
                 "ActorID", "TaskID", "ObjectID"):
        jcls, pcls = getattr(J, name), getattr(P, name)
        assert pcls.SIZE == jcls.SIZE
        assert pcls.nil().binary() == jcls.nil().binary() and pcls.nil().is_nil()
        h = "ab" * pcls.SIZE
        assert pcls.from_hex(h).binary() == jcls.from_hex(h).binary()
        with pytest.raises(ValueError) as je:
            jcls(b"x")
        with pytest.raises(ValueError) as pe:
            pcls(b"x")
        assert str(pe.value) == str(je.value)
    assert P.FunctionID is P.UniqueID


@pytest.mark.parametrize("size", [0, 4, 16, 24])
def test_id_from_index_matches_fastpath(size):
    rng = np.random.default_rng(size)
    for _ in range(8):
        prefix = rng.bytes(size)
        for index in (0, 1, 2**16 + 3, 1_000_001, 2**32 - 1):
            assert port_fastpath.id_from_index(prefix, index) == \
                jax_fastpath.id_from_index(prefix, index)
    with pytest.raises(Exception):  # struct.error: out of u32 range, in both
        port_fastpath.id_from_index(b"", 2**32)
