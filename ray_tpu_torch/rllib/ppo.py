"""PPO's learner in process (PyTorch port of ray_tpu/rllib/ppo.py).

Reference: rllib/algorithms/ppo/ppo.py:365 (`PPO`), Learner
(rllib/core/learner/learner.py:112). The policy and value MLPs, the
clipped-surrogate loss and Adam run on the card; ``compute_gae``, the
advantage normalisation and the minibatch shuffle by
``np.random.RandomState(cfg.seed)`` stay numpy, as in JAX. ``PPO`` and
its ``EnvRunner`` actors wait for the actor runtime and raise, and so
does ``PPOConfig.build()``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch import default_device
from ray_tpu_torch.rllib.algorithm import AlgorithmConfigBase, waits_for_runtime
from ray_tpu_torch.rllib.rollout import (
    Learner, floats, generator, init_mlp_params, mlp_apply, to_device, worker_seed,
)


# ---------------------------------------------------------------------------
# Policy/value network (shared MLP definition, rollout.py)
# ---------------------------------------------------------------------------
def init_policy(gen: torch.Generator, obs_dim: int, num_actions: int,
                hidden: Tuple[int, ...] = (64, 64)):
    return {"pi": init_mlp_params(gen, obs_dim, hidden, num_actions),
            "vf": init_mlp_params(gen, obs_dim, hidden, 1)}


def policy_logits(params, obs, n_hidden: int = 2):
    return mlp_apply(params["pi"], obs, n_hidden)


def value_fn(params, obs, n_hidden: int = 2):
    return mlp_apply(params["vf"], obs, n_hidden)[..., 0]


def take(logp_all: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """``logp_all[..., actions]`` along the last axis (take_along_axis)."""
    return logp_all.gather(-1, actions.long().unsqueeze(-1)).squeeze(-1)


def entropy_of(logp_all: torch.Tensor) -> torch.Tensor:
    """−Σ_a p log p along the last axis."""
    return -(torch.exp(logp_all) * logp_all).sum(-1)


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class PPOConfig(AlgorithmConfigBase):
    """Reference: AlgorithmConfig + PPOConfig (ppo.py). Builder-style:
    PPOConfig().environment("CartPole-v1").env_runners(2).training(lr=3e-4)."""

    env: Any = "CartPole-v1"
    num_env_runners: int = 2
    rollout_fragment_length: int = 256
    lr: float = 3e-4
    gamma: float = 0.99
    lambda_: float = 0.95
    clip_param: float = 0.2
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    num_epochs: int = 4
    minibatch_size: int = 128
    hidden: Tuple[int, ...] = (64, 64)
    seed: int = 0


EnvRunner = waits_for_runtime("EnvRunner", "PPO's env-runner actor")


def compute_gae(rewards, values, dones, last_value, gamma, lambda_,
                truncs=None, bootstrap_values=None):
    """Generalized advantage estimation (reference:
    rllib/evaluation/postprocessing.py compute_advantages).

    Truncated-but-not-terminated steps bootstrap from V(s_{t+1}) recorded
    before the env reset, and the lambda accumulation stops at the boundary
    (the following buffer row belongs to a different episode)."""
    T = len(rewards)
    adv = np.zeros(T, np.float32)
    last = 0.0
    next_v = last_value
    for t in reversed(range(T)):
        if truncs is not None and truncs[t]:
            delta = rewards[t] + gamma * float(bootstrap_values[t]) - values[t]
            last = delta
        else:
            nonterminal = 1.0 - float(dones[t])
            delta = rewards[t] + gamma * next_v * nonterminal - values[t]
            last = delta + gamma * lambda_ * nonterminal * last
        adv[t] = last
        next_v = values[t]
    returns = adv + values
    return adv, returns


# ---------------------------------------------------------------------------
# Learner (reference: learner.py:112)
# ---------------------------------------------------------------------------
class PPOLearner(Learner):
    def __init__(self, cfg: PPOConfig, obs_dim: int, num_actions: int, device=None):
        device = default_device(device)
        self.cfg = cfg
        self.n_hidden = len(cfg.hidden)
        gen = generator(device, worker_seed(cfg.seed, 0))
        self._setup(init_policy(gen, obs_dim, num_actions, cfg.hidden), cfg.lr, device)

    def loss_fn(self, params, batch):
        cfg, nh = self.cfg, self.n_hidden
        logp_all = F.log_softmax(policy_logits(params, batch["obs"], nh), -1)
        logp = take(logp_all, batch["actions"])
        ratio = torch.exp(logp - batch["logp"])
        adv = batch["adv"]
        surr = torch.minimum(
            ratio * adv, torch.clamp(ratio, 1 - cfg.clip_param, 1 + cfg.clip_param) * adv)
        v = value_fn(params, batch["obs"], nh)
        vf_loss = torch.mean((v - batch["returns"]) ** 2)
        entropy = torch.mean(entropy_of(logp_all))
        loss = -torch.mean(surr) + cfg.vf_coeff * vf_loss - cfg.entropy_coeff * entropy
        return loss, {"policy_loss": -torch.mean(surr), "vf_loss": vf_loss,
                      "entropy": entropy}

    def _update(self, batch) -> Dict[str, torch.Tensor]:
        loss, aux = self.loss_fn(self.params, batch)
        self._step(loss)
        return dict(aux, total_loss=loss)

    def update(self, batch_np: Dict[str, np.ndarray]) -> Dict[str, float]:
        cfg = self.cfg
        n = len(batch_np["obs"])
        idx = np.arange(n)
        metrics = {}
        adv = batch_np["adv"]
        batch_np = dict(batch_np, adv=(adv - adv.mean()) / (adv.std() + 1e-8))
        rng = np.random.RandomState(cfg.seed)
        mb = min(cfg.minibatch_size, n)
        for _ in range(cfg.num_epochs):
            rng.shuffle(idx)
            for s in range(0, n - mb + 1, mb):
                sel = idx[s : s + mb]
                mbatch = to_device({k: v[sel] for k, v in batch_np.items()
                                    if k in ("obs", "actions", "logp", "adv", "returns")},
                                   self.device)
                metrics = self._update(mbatch)
        return floats(metrics)


PPO = waits_for_runtime("PPO", "the PPO algorithm (env-runner actors)")
PPOConfig.algo_cls = PPO
