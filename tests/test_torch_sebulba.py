"""Sebulba on the port's cluster with its learners on the CPU
(tests/test_podracer.py TestSebulba, the same invariants): two pod
actors streaming into one learner, monotone updates, no order or app
errors, env steps trained equal to updates x fragment length, both
actors live; a learner killed and respawned from its checkpoint keeps
stepping; two learners' params bit-equal after a cross-learner sync over
the OBJSTORE backend; and the card path without a card: ``build()``
(device None) raises naming the cards, a TPU ``slice_topology`` raises
ValueError. The slow case kills a learner right before a cross-learner
broadcast.
"""

import time

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.rllib.podracer import Sebulba, SebulbaConfig


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4)
    try:
        yield
    finally:
        rt.shutdown()


def small(**kw):
    return SebulbaConfig(num_actors=2, rollout_fragment_length=32, updates_per_train=4,
                         seed=0, **kw)


def test_streams_and_updates(cluster):
    algo = small(num_learners=1).build(device="cpu")
    try:
        last = 0
        for _ in range(3):
            r = algo.train()
            assert r["num_updates"] > last
            last = r["num_updates"]
            assert r["order_errors"] == 0 and r["app_errors"] == 0
        assert r["num_env_steps_trained"] == last * 32
        assert sorted(r["live_actors"]) == [0, 1]
    finally:
        algo.stop()


def test_learner_restart_from_checkpoint(cluster):
    cfg = small(num_learners=1, checkpoint_interval=2)
    algo = cfg.build(device="cpu")
    try:
        algo.train()
        r_pre = algo.train()
        assert r_pre["num_updates"] >= 8
        algo.kill_learner(0)
        algo.train()  # detects the death, respawns from the checkpoint
        r_post = algo.train()
        assert r_post["learner_restarts"] == 1
        assert r_post["app_errors"] == 0 and r_post["order_errors"] == 0
        assert r_post["num_updates"] > r_pre["num_updates"] - cfg.checkpoint_interval
    finally:
        algo.stop()


def test_two_learners_sync_bit_equal(cluster):
    algo = small(num_learners=2, sync_every_iterations=1).build(device="cpu")
    try:
        r = algo.train()
        assert r["app_errors"] == 0 and r["order_errors"] == 0
        assert r["group_rotations"] == 0 and len(r["learners"]) == 2
        a, b = rt.get([ln.get_params_np.remote() for ln in algo.learners], timeout=60)
        for net in a:
            for k in a[net]:
                np.testing.assert_array_equal(a[net][k], b[net][k])
    finally:
        algo.stop()


@pytest.mark.parametrize("cfg,error", [
    (dict(), "each lease a card and the cluster has 0"),
    (dict(slice_topology="v5litepod-16"), "names a TPU slice")])
def test_card_path_without_a_card_raises(cluster, cfg, error):
    with pytest.raises((RuntimeError, ValueError), match=error):
        Sebulba(small(**cfg))


@pytest.mark.parametrize("device", ["cuda", "cuda:1", "meta"])
def test_device_other_than_a_lease_or_the_cpu_raises(cluster, device):
    """``device`` is None (each learner leases a card) or "cpu"; naming a
    card is refused rather than quietly replaced by the lease."""
    with pytest.raises(ValueError, match="takes None"):
        small().build(device=device)


@pytest.mark.slow
def test_cross_learner_sync_survives_mid_broadcast_kill(cluster):
    cfg = small(num_learners=2, sync_every_iterations=1, checkpoint_interval=2)
    algo = cfg.build(device="cpu")
    try:
        r = algo.train()
        assert r["group_rotations"] == 0 and r["app_errors"] == 0
        algo.kill_learner(1)
        t0 = time.monotonic()
        algo._sync_learners()  # broadcast with a dead counterpart
        assert time.monotonic() - t0 < 60, "mid-broadcast death stalled the driver"
        assert (algo.group_rotations, algo.learner_restarts, algo.app_errors) == (1, 1, 0)
        r = algo.train()
        assert r["app_errors"] == 0 and r["order_errors"] == 0
        assert (r["group_rotations"], r["learner_restarts"]) == (1, 1)
    finally:
        algo.stop()
