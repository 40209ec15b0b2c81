"""SAC's learner in process (PyTorch port of ray_tpu/rllib/sac.py):
discrete SAC with twin soft Q-critics, an entropy-regularised policy
and a tuned temperature.

Reference: rllib/algorithms/sac/sac.py (`SAC`) and sac_learner.py; the
discrete-action formulation takes expectations over the categorical
policy instead of the reparameterization trick. One update trains the
actor, both critics and log α with Adam on the card; the target critics
track by Polyak averaging in the same step. The algorithm ``SAC`` is
DQN's loop (``SampleRunner`` actors sampling the categorical policy,
the numpy replay buffer, minibatch updates) with these losses.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

import ray_tpu_torch
from ray_tpu_torch import default_device
from ray_tpu_torch.rllib.adam import clone, tree_leaves
from ray_tpu_torch.rllib.algorithm import AlgorithmConfigBase
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.ppo import take
from ray_tpu_torch.rllib.rollout import (
    Learner, ReplayBuffer, RunnerAlgorithm, SampleRunner, floats, generator, init_mlp_params,
    mlp_apply as _mlp, to_device, worker_seed,
)


@dataclasses.dataclass
class SACConfig(AlgorithmConfigBase):
    """Builder-style config (reference: SACConfig, sac.py)."""

    env: Any = "CartPole-v1"
    num_env_runners: int = 1
    rollout_fragment_length: int = 64
    lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.01  # polyak rate for target critics
    buffer_capacity: int = 50_000
    learning_starts: int = 500
    train_batch_size: int = 64
    updates_per_iteration: int = 16
    initial_alpha: float = 0.2
    target_entropy: Optional[float] = None  # default 0.98*log(n_actions)
    hidden: Tuple[int, ...] = (64, 64)
    seed: int = 0


def _critics(params):
    return clone({"q1": params["q1"], "q2": params["q2"]})


class SACLearner(Learner):
    def __init__(self, cfg: SACConfig, obs_dim: int, num_actions: int, device=None):
        device = default_device(device)
        self.cfg = cfg
        self.n_hidden = len(cfg.hidden)
        gen = generator(device, worker_seed(cfg.seed, 0))
        params = {
            "pi": init_mlp_params(gen, obs_dim, cfg.hidden, num_actions),
            "q1": init_mlp_params(gen, obs_dim, cfg.hidden, num_actions),
            "q2": init_mlp_params(gen, obs_dim, cfg.hidden, num_actions),
            "log_alpha": torch.tensor(np.log(cfg.initial_alpha), dtype=torch.float32,
                                      device=device).requires_grad_(),
        }
        self._setup(params, cfg.lr, device)
        self.target = _critics(self.params)
        self.target_entropy = cfg.target_entropy if cfg.target_entropy \
            is not None else 0.98 * float(np.log(num_actions))

    def set_weights(self, params, opt_state=None) -> None:
        """As ``Learner.set_weights``; the target critics copies of the
        critics."""
        super().set_weights(params, opt_state)
        self.target = _critics(self.params)

    def loss_fn(self, params, target, batch):
        cfg, nh, h_target = self.cfg, self.n_hidden, self.target_entropy
        # categorical policy distribution at s and s'
        logp = F.log_softmax(_mlp(params["pi"], batch["obs"], nh), -1)
        p = torch.exp(logp)
        alpha = torch.exp(params["log_alpha"])
        with torch.no_grad():
            logp_n = F.log_softmax(_mlp(params["pi"], batch["next_obs"], nh), -1)
            p_n = torch.exp(logp_n)
            # soft Q target: E_{a'~pi}[min Q_t(s',a') - alpha log pi(a'|s')]
            q1_t = _mlp(target["q1"], batch["next_obs"], nh)
            q2_t = _mlp(target["q2"], batch["next_obs"], nh)
            v_next = torch.sum(p_n * (torch.minimum(q1_t, q2_t) - alpha * logp_n), 1)
            y = batch["rewards"] + cfg.gamma * v_next * (1.0 - batch["terminateds"].float())

        q1_all = _mlp(params["q1"], batch["obs"], nh)
        q2_all = _mlp(params["q2"], batch["obs"], nh)
        q1 = take(q1_all, batch["actions"])
        q2 = take(q2_all, batch["actions"])
        critic_loss = torch.mean((q1 - y) ** 2) + torch.mean((q2 - y) ** 2)

        # actor: E_s[ sum_a pi(a|s) (alpha log pi - min Q) ], Q frozen
        q_min = torch.minimum(q1_all, q2_all).detach()
        actor_loss = torch.mean(torch.sum(p * (alpha.detach() * logp - q_min), 1))

        # temperature: match the target entropy
        entropy = -torch.sum((p * logp).detach(), 1)
        alpha_loss = torch.mean(torch.exp(params["log_alpha"]) * (entropy - h_target))

        loss = critic_loss + actor_loss + alpha_loss
        return loss, {"critic_loss": critic_loss, "actor_loss": actor_loss,
                      "alpha": alpha.detach(), "entropy_mean": torch.mean(entropy)}

    def _update(self, batch) -> Dict[str, torch.Tensor]:
        loss, aux = self.loss_fn(self.params, self.target, batch)
        self._step(loss)
        # polyak target tracking, in the same step
        tau = self.cfg.tau
        with torch.no_grad():
            for net in ("q1", "q2"):
                t, o = tree_leaves(self.target[net]), tree_leaves(self.params[net])
                torch._foreach_mul_(t, 1 - tau)
                torch._foreach_add_(t, torch._foreach_mul(o, tau))
        return dict(aux, loss=loss)

    def update(self, batch_np: Dict[str, np.ndarray]) -> Dict[str, float]:
        return floats(self._update(to_device(batch_np, self.device)))

    def get_policy_np(self) -> Dict:
        """Only the actor net — all the runners need, 1/3 the payload."""
        return {"pi": self.get_weights_np()["pi"]}

    def state(self) -> Dict[str, Any]:
        return {"params": self.params, "target": self.target, "opt_state": self.opt_state}

    def load_state(self, state: Dict[str, Any]) -> None:
        super().load_state(state)
        self.target = state["target"]


class SAC(RunnerAlgorithm):
    """Reference: rllib/algorithms/sac/sac.py — training_step is DQN's
    (sample → replay → updates) with the SAC losses."""

    def __init__(self, cfg: SACConfig, device=None):
        probe = make_env(cfg.env)
        self.cfg = cfg
        self.obs_dim = probe.observation_dim
        self.num_actions = probe.num_actions
        self.learner = SACLearner(cfg, self.obs_dim, self.num_actions, device=device)
        # the buffer draws from the same fan-out, one index past the runners
        self.buffer = ReplayBuffer(
            cfg.buffer_capacity, self.obs_dim,
            worker_seed(cfg.seed, cfg.num_env_runners))
        self.runners = [
            SampleRunner.remote(cfg.env, cfg.hidden, worker_seed(cfg.seed, i),
                                mode="categorical", net_key="pi")
            for i in range(cfg.num_env_runners)
        ]
        self.iteration = 0
        self._recent_returns: List[float] = []

    def train(self) -> Dict[str, Any]:
        cfg = self.cfg
        weights = self.learner.get_policy_np()
        frags = ray_tpu_torch.get([
            r.sample.remote(weights, cfg.rollout_fragment_length)
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
            "replay_buffer_size": len(self.buffer),
            **metrics,
        }


SACConfig.algo_cls = SAC
