"""The port's RL algorithms over env-runner actors (ray_tpu_torch.rllib:
PPO, IMPALA, DQN, SAC and MultiAgentPPO) held against the JAX package's
on the CPU.

One iteration of each algorithm in the port's cluster (its runners
actors in worker processes, its learner on the CPU in the driver)
against the JAX package's algorithm in JAX's local mode, both from JAX's
initial params (``learner.set_weights``, rllib/convert.py) and the same
config and seed: the fragments the runners return are equal, array for
array (numpy inference on equal weights, the same RandomState draws),
and the learner's params and the iteration's metrics are within 2e-5
(absolute and relative, as tests/test_torch_rllib.py holds the
learners). IMPALA runs one runner here: with two, which fragment lands
first is a race, in either package. Then the checkpoint round trip
(tests/test_rllib.py's, through the port's ``train.checkpoint``: the
restored learner equal bit for bit, Adam's state included), and
``CoordinationGame``'s API step for step against JAX's. The learning
cases of tests/test_rllib.py run in
tests/test_torch_rllib_drivers_learn.py (split to keep each file under
20 s).

The cyclic collector stays paused while JAX's local mode runs (its
store's lock is not reentrant: ROADMAP.md Queue C).
"""

import contextlib

import numpy as np
import pytest

import ray_tpu
import ray_tpu.rllib as jrl
import ray_tpu_torch as rt
import ray_tpu_torch.rllib as trl
from test_torch_cluster_cases import collect_between_tests, collector_paused  # noqa: F401
from test_torch_rllib import assert_metrics_close, assert_trees_close
from ray_tpu_torch.rllib.adam import tree_leaves

HIDDEN = (16,)
CONFIGS = {  # name: (config class name, fields), each small
    "ppo": ("PPOConfig", dict(num_env_runners=2, rollout_fragment_length=64, num_epochs=2,
                              minibatch_size=32)),
    "impala": ("IMPALAConfig", dict(num_env_runners=1, rollout_fragment_length=32,
                                    fragments_per_iteration=2)),
    "dqn": ("DQNConfig", dict(num_env_runners=2, rollout_fragment_length=32, learning_starts=32,
                              train_batch_size=16, updates_per_iteration=4,
                              target_network_update_freq=2)),
    "sac": ("SACConfig", dict(num_env_runners=2, rollout_fragment_length=32, learning_starts=32,
                              train_batch_size=16, updates_per_iteration=4)),
}


@pytest.fixture(scope="module")
def runtimes():
    with collector_paused():
        ray_tpu.init(local_mode=True)
        try:
            rt.init(num_cpus=4)
            try:
                yield
            finally:
                rt.shutdown()
        finally:
            ray_tpu.shutdown()


@contextlib.contextmanager
def fragments(pkg):
    """The fragments ``pkg.get`` returns while open, in the order got."""
    seen, plain = [], pkg.get

    def get(refs, *args, **kwargs):
        out = plain(refs, *args, **kwargs)
        for v in out if isinstance(out, list) else [out]:
            if isinstance(v, dict) and "obs" in v:
                seen.append(v)
        return out

    pkg.get = get
    try:
        yield seen
    finally:
        pkg.get = plain


def build_pair(name, **extra):
    """The JAX algorithm and the port's, on the same config, the port's
    learner set to the JAX learner's initial params."""
    cls, fields = CONFIGS[name]
    kw = dict(fields, hidden=HIDDEN, seed=3, **extra)
    jalgo = getattr(jrl, cls)(**kw).build()
    talgo = getattr(trl, cls)(**kw).build(device="cpu")
    talgo.learner.set_weights(jalgo.learner.get_weights_np())
    return jalgo, talgo


@pytest.mark.parametrize("name", list(CONFIGS))
def test_one_iteration_matches_jax(runtimes, name):
    jalgo, talgo = build_pair(name)
    try:
        with fragments(ray_tpu) as jfrags:
            jres = jalgo.train()
        with fragments(rt) as tfrags:
            tres = talgo.train()
    finally:
        jalgo.stop()
        talgo.stop()
    want = CONFIGS[name][1].get("fragments_per_iteration") or CONFIGS[name][1]["num_env_runners"]
    assert len(tfrags) == len(jfrags) == want
    for t, j in zip(tfrags, jfrags):
        assert t.keys() == j.keys()
        for k in j:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
            assert np.asarray(t[k]).dtype == np.asarray(j[k]).dtype, k
    assert_metrics_close(tres, jres)
    assert_trees_close(talgo.learner.get_weights_np(), jalgo.learner.get_weights_np())


def test_runners_are_actors_in_worker_processes(runtimes):
    _, talgo = build_pair("sac")
    try:
        assert len(talgo.runners) == 2
        assert all(type(r).__name__ == "ActorHandle" for r in talgo.runners)
    finally:
        talgo.stop()
    with pytest.raises(TypeError, match="cannot be instantiated directly"):
        trl.SampleRunner("CartPole-v1", HIDDEN, 0)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_checkpoint_roundtrip(runtimes, tmp_path, name):
    """tests/test_rllib.py's round trip for each algorithm: the restored
    learner's params and Adam state (and target nets) bit-equal to the
    saved ones."""
    algo = getattr(trl, CONFIGS[name][0])(**dict(CONFIGS[name][1], hidden=HIDDEN)).build(
        device="cpu")
    try:
        algo.train()
        p = str(tmp_path / "ckpt")
        algo.save(p)
        before = [t.detach().clone() for t in tree_leaves(algo.learner.state())]
        algo2 = getattr(trl, CONFIGS[name][0])(**dict(CONFIGS[name][1], hidden=HIDDEN)).build(
            device="cpu")
        algo2.restore(p)
        after = tree_leaves(algo2.learner.state())
        assert len(after) == len(before)
        for a, b in zip(after, before):
            assert a.dtype == b.dtype and bool((a == b).all())
        assert all(t.requires_grad for t in tree_leaves(algo2.learner.params))
        algo2.train()  # a restored learner keeps training
        algo2.stop()
    finally:
        algo.stop()


def test_coordination_game_step_for_step():
    """tests/test_rllib.py's API case, then a seeded random walk through
    both packages' games: observations, rewards, terminations equal at
    every step, resets included."""
    env = trl.CoordinationGame(episode_len=3)
    obs, _ = env.reset()
    assert set(obs) == {"a0", "a1"}
    obs, rew, term, trunc, _ = env.step({"a0": 1, "a1": 1})
    assert rew == {"a0": 1.0, "a1": 1.0}
    obs, rew, term, trunc, _ = env.step({"a0": 0, "a1": 1})
    assert rew == {"a0": 0.0, "a1": 0.0}
    assert obs["a0"].tolist() == [0.0, 1.0] and obs["a1"].tolist() == [1.0, 0.0]
    _, _, term, _, _ = env.step({"a0": 0, "a1": 0})
    assert term["__all__"]
    games = (trl.CoordinationGame(episode_len=5), jrl.CoordinationGame(episode_len=5))
    assert games[0].observation_dims == games[1].observation_dims
    assert games[0].action_counts == games[1].action_counts
    assert games[0].agents == games[1].agents
    rng = np.random.RandomState(0)
    outs = [g.reset() for g in games]
    for _ in range(23):
        acts = {a: int(rng.randint(2)) for a in games[0].agents}
        outs = [g.step(acts) for g in games]
        t, j = outs
        for k in ("a0", "a1"):
            np.testing.assert_array_equal(t[0][k], j[0][k])
        assert t[1:4] == j[1:4]
        if t[2]["__all__"]:
            outs = [g.reset() for g in games]
            np.testing.assert_array_equal(outs[0][0]["a0"], outs[1][0]["a0"])


def test_multi_agent_one_iteration_matches_jax(runtimes):
    """MultiAgentPPO with separate policies: per-agent fragments from the
    runner actor, each policy's learner within 2e-5 of JAX's after one
    iteration from JAX's initial params."""
    kw = dict(num_env_runners=1, rollout_fragment_length=32, hidden=(8,), minibatch_size=32,
              num_epochs=1, seed=2)
    algos = [mod.MultiAgentPPOConfig(**kw).environment(
        lambda mod=mod: mod.CoordinationGame(episode_len=8)).multi_agent(
        policy_mapping_fn=lambda aid: aid).build(**extra)
        for mod, extra in ((jrl, {}), (trl, {"device": "cpu"}))]
    jalgo, talgo = algos
    try:
        for pid, learner in talgo.learners.items():
            learner.set_weights(jalgo.learners[pid].get_weights_np())
        jres, tres = jalgo.train(), talgo.train()
    finally:
        for a in algos:
            a.stop()
    assert set(talgo.learners) == set(jalgo.learners) == {"a0", "a1"}
    assert_metrics_close(tres, jres)
    for pid in ("a0", "a1"):
        assert_trees_close(talgo.learners[pid].get_weights_np(),
                           jalgo.learners[pid].get_weights_np())
