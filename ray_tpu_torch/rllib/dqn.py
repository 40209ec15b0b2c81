"""DQN's learner in process (PyTorch port of ray_tpu/rllib/dqn.py):
double Q-learning with a target network.

Reference: rllib/algorithms/dqn/dqn.py (`DQN`, training_step) and
dqn_rainbow_learner.py. The update (double-DQN target, Huber loss, Adam)
runs on the card; the target net is a copy of the params made every
``target_network_update_freq`` updates. The algorithm ``DQN`` samples
with epsilon-greedy ``SampleRunner`` actors into the numpy replay buffer
and takes its minibatch updates on the learner's device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch import default_device
from ray_tpu_torch.rllib.adam import clone
from ray_tpu_torch.rllib.algorithm import AlgorithmConfigBase
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.ppo import take
from ray_tpu_torch.rllib.rollout import (
    Learner, ReplayBuffer, RunnerAlgorithm, SampleRunner, floats, generator, init_mlp_params,
    mlp_apply, to_device, worker_seed,
)


def init_q_params(gen: torch.Generator, obs_dim: int, num_actions: int,
                  hidden: Tuple[int, ...]):
    return {"q": init_mlp_params(gen, obs_dim, hidden, num_actions)}


def q_values(params, obs, n_hidden: int):
    return mlp_apply(params["q"], obs, n_hidden)


@dataclasses.dataclass
class DQNConfig(AlgorithmConfigBase):
    """Builder-style config (reference: DQNConfig, dqn.py)."""

    env: Any = "CartPole-v1"
    num_env_runners: int = 1
    rollout_fragment_length: int = 64
    lr: float = 5e-4
    gamma: float = 0.99
    buffer_capacity: int = 50_000
    learning_starts: int = 500
    train_batch_size: int = 64
    updates_per_iteration: int = 16
    target_network_update_freq: int = 100  # in updates
    epsilon_initial: float = 1.0
    epsilon_final: float = 0.05
    epsilon_decay_iters: int = 30
    double_q: bool = True
    hidden: Tuple[int, ...] = (64, 64)
    seed: int = 0


class DQNLearner(Learner):
    def __init__(self, cfg: DQNConfig, obs_dim: int, num_actions: int, device=None):
        device = default_device(device)
        self.cfg = cfg
        self.n_hidden = len(cfg.hidden)
        gen = generator(device, worker_seed(cfg.seed, 0))
        self._setup(init_q_params(gen, obs_dim, num_actions, cfg.hidden), cfg.lr, device)
        self.target_params = clone(self.params)
        self.num_updates = 0

    def set_weights(self, params, opt_state=None) -> None:
        """As ``Learner.set_weights``; the target net a copy of the params."""
        super().set_weights(params, opt_state)
        self.target_params = clone(self.params)

    def loss_fn(self, params, target_params, batch):
        cfg, nh = self.cfg, self.n_hidden
        q_sel = take(q_values(params, batch["obs"], nh), batch["actions"])
        with torch.no_grad():
            q_next_t = q_values(target_params, batch["next_obs"], nh)
            if cfg.double_q:
                # double DQN: the online net selects (the first index of a
                # tie, as jnp.argmax), the target net evaluates
                a_star = torch.argmax(q_values(params, batch["next_obs"], nh), 1)
                q_next = take(q_next_t, a_star)
            else:
                q_next = q_next_t.max(1).values
            target = batch["rewards"] + cfg.gamma * q_next * (
                1.0 - batch["terminateds"].float())
        td = q_sel - target
        # Huber
        loss = torch.mean(torch.where(torch.abs(td) < 1.0, 0.5 * td * td, torch.abs(td) - 0.5))
        return loss, {"td_error_mean": torch.mean(torch.abs(td)), "qf_mean": torch.mean(q_sel)}

    def _update(self, batch) -> Dict[str, torch.Tensor]:
        loss, aux = self.loss_fn(self.params, self.target_params, batch)
        self._step(loss)
        self.num_updates += 1
        if self.num_updates % self.cfg.target_network_update_freq == 0:
            self.target_params = clone(self.params)
        return dict(aux, loss=loss)

    def update(self, batch_np: Dict[str, np.ndarray]) -> Dict[str, float]:
        return floats(self._update(to_device(batch_np, self.device)))

    def state(self) -> Dict[str, Any]:
        return {"params": self.params, "target": self.target_params,
                "opt_state": self.opt_state}

    def load_state(self, state: Dict[str, Any]) -> None:
        super().load_state(state)
        self.target_params = state["target"]


class DQN(RunnerAlgorithm):
    """Reference: rllib/algorithms/dqn/dqn.py `DQN.training_step`:
    sample → store in replay → N minibatch updates → sync target."""

    def __init__(self, cfg: DQNConfig, device=None):
        probe = make_env(cfg.env)
        self.cfg = cfg
        self.obs_dim = probe.observation_dim
        self.num_actions = probe.num_actions
        self.learner = DQNLearner(cfg, self.obs_dim, self.num_actions, device=device)
        # the buffer draws from the same fan-out, one index past the runners
        self.buffer = ReplayBuffer(
            cfg.buffer_capacity, self.obs_dim,
            worker_seed(cfg.seed, cfg.num_env_runners))
        self.runners = [
            SampleRunner.remote(cfg.env, cfg.hidden, worker_seed(cfg.seed, i),
                                mode="epsilon", net_key="q")
            for i in range(cfg.num_env_runners)
        ]
        self.iteration = 0
        self._recent_returns: List[float] = []

    def _epsilon(self) -> float:
        cfg = self.cfg
        frac = min(1.0, self.iteration / max(1, cfg.epsilon_decay_iters))
        return cfg.epsilon_initial + frac * (
            cfg.epsilon_final - cfg.epsilon_initial)

    def train(self) -> Dict[str, Any]:
        cfg = self.cfg
        weights = self.learner.get_weights_np()
        eps = self._epsilon()
        frags = ray_tpu_torch.get([
            r.sample.remote(weights, cfg.rollout_fragment_length, eps)
            for r in self.runners
        ])
        for f in frags:
            self.buffer.add_batch(f)
            self._recent_returns.extend(f["episode_returns"].tolist())
        metrics: Dict[str, float] = {}
        if len(self.buffer) >= cfg.learning_starts:
            for _ in range(cfg.updates_per_iteration):
                metrics = self.learner.update(
                    self.buffer.sample(cfg.train_batch_size))
        self.iteration += 1
        self._recent_returns = self._recent_returns[-100:]
        mean_ret = float(np.mean(self._recent_returns)) \
            if self._recent_returns else 0.0
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": mean_ret,
            "epsilon": eps,
            "replay_buffer_size": len(self.buffer),
            **metrics,
        }


DQNConfig.algo_cls = DQN
