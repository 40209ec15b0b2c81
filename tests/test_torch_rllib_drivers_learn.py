"""tests/test_rllib.py's learning cases (:159-320) through the port's RL
algorithms on its cluster (runner actors in worker processes, learners
on the CPU): PPO, DQN, SAC and IMPALA on CartPole beat the JAX test's
thresholds, and multi-agent PPO's shared policy learns the coordination
game while separate policies train independent weights. Each learner
starts from the JAX package's initial params for the same config
(``set_weights``; the port cannot draw ``jax.random``'s bits), so the
port runs the case the JAX test runs, with the same seeds.
"""

import dataclasses

import numpy as np
import pytest

import ray_tpu_torch as rt
import ray_tpu_torch.rllib as trl
from ray_tpu.rllib import dqn as jdqn, impala as jimpala, ppo as jppo, sac as jsac

LEARNERS = {"PPO": (jppo.PPOConfig, jppo.PPOLearner), "IMPALA": (jimpala.IMPALAConfig,
                                                                 jimpala.IMPALALearner),
            "DQN": (jdqn.DQNConfig, jdqn.DQNLearner), "SAC": (jsac.SACConfig, jsac.SACLearner)}


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


def jax_init(name, cfg, obs_dim=4, num_actions=2):
    """The JAX learner's initial params for the port config ``cfg``."""
    jcfg_cls, jlearner = LEARNERS[name]
    jcfg = jcfg_cls(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(jcfg_cls)})
    return jlearner(jcfg, obs_dim, num_actions).get_weights_np()


def build(cfg, name):
    algo = cfg.build(device="cpu")
    algo.learner.set_weights(jax_init(name, cfg))
    return algo


def test_ppo_cartpole_improves(cluster):
    algo = build(trl.PPOConfig().environment("CartPole-v1")
                 .env_runners(2, rollout_fragment_length=256)
                 .training(lr=1e-3, num_epochs=4, minibatch_size=128), "PPO")
    try:
        first = algo.train()
        for _ in range(8):
            result = algo.train()
        assert result["training_iteration"] == 9
        assert result["episode_return_mean"] > first["episode_return_mean"]
        assert result["episode_return_mean"] > 30
    finally:
        algo.stop()


def test_dqn_cartpole_improves(cluster):
    algo = build(trl.DQNConfig().environment("CartPole-v1")
                 .env_runners(1, rollout_fragment_length=256)
                 .training(lr=1e-3, learning_starts=256, updates_per_iteration=32,
                           epsilon_decay_iters=6, target_network_update_freq=50), "DQN")
    try:
        first = algo.train()
        for _ in range(9):
            result = algo.train()
        assert result["training_iteration"] == 10
        assert result["replay_buffer_size"] > 256
        assert np.isfinite(result["loss"])
        assert result["epsilon"] < first["epsilon"]
        assert result["episode_return_mean"] > 25
    finally:
        algo.stop()


def test_sac_cartpole_runs_and_tunes_alpha(cluster):
    algo = build(trl.SACConfig().environment("CartPole-v1")
                 .env_runners(1, rollout_fragment_length=256)
                 .training(lr=3e-3, learning_starts=256, updates_per_iteration=32), "SAC")
    try:
        for _ in range(6):
            result = algo.train()
        assert np.isfinite(result["critic_loss"])
        assert np.isfinite(result["actor_loss"])
        assert result["alpha"] > 0
        assert result["episode_return_mean"] > 15
    finally:
        algo.stop()


def test_impala_cartpole_improves(cluster):
    algo = build(trl.IMPALAConfig().environment("CartPole-v1")
                 .env_runners(2, rollout_fragment_length=256)
                 .training(lr=1e-3, fragments_per_iteration=4), "IMPALA")
    try:
        for _ in range(8):
            result = algo.train()
        assert np.isfinite(result["total_loss"])
        assert 0 < result["mean_rho"] <= 1.0
        assert result["episode_return_mean"] > 30
    finally:
        algo.stop()


def multi_agent(mapping, episode_len, **kw):
    """MultiAgentPPO on the coordination game, each policy's learner from
    JAX's initial params."""
    cfg = (trl.MultiAgentPPOConfig(**kw)
           .environment(lambda: trl.CoordinationGame(episode_len=episode_len))
           .multi_agent(policy_mapping_fn=mapping))
    algo = cfg.build(device="cpu")
    for learner in algo.learners.values():
        learner.set_weights(jax_init("PPO", cfg, 2, 2))
    return algo


def test_shared_policy_learns_coordination(cluster):
    """Two agents share ONE policy; pooled experience learns the
    convention (reward_mean approaches the 1.0/step optimum)."""
    algo = multi_agent(lambda aid: "shared", 16, num_env_runners=1, rollout_fragment_length=128,
                       lr=0.02, hidden=(16,), minibatch_size=64, num_epochs=4,
                       entropy_coeff=0.0, seed=1)
    try:
        assert set(algo.learners) == {"shared"}
        result = {}
        for _ in range(25):
            result = algo.train()
            # optimum: both agents earn 1 per step × 16 steps × 2
            if result["episode_return_mean"] > 28.0:
                break
        assert result["episode_return_mean"] > 28.0, result
    finally:
        algo.stop()


def test_separate_policies_have_independent_weights(cluster):
    algo = multi_agent(lambda aid: aid, 8, num_env_runners=1, rollout_fragment_length=32,
                       hidden=(8,), minibatch_size=32, num_epochs=1, seed=2)
    try:
        assert set(algo.learners) == {"a0", "a1"}
        m = algo.train()
        assert any(k.startswith("a0/") for k in m)
        assert any(k.startswith("a1/") for k in m)
        w0 = algo.learners["a0"].get_weights_np()
        w1 = algo.learners["a1"].get_weights_np()
        diffs = [np.abs(a - b).max() for a, b in zip(w0["pi"].values(), w1["pi"].values())]
        assert max(diffs) > 0.0  # independent weights diverged
    finally:
        algo.stop()
