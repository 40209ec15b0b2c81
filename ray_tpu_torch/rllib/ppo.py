"""PPO — env-runner actors (CPU) + the learner on the card (PyTorch port
of ray_tpu/rllib/ppo.py).

Reference: rllib/algorithms/ppo/ppo.py:365 (`PPO`, training_step :391),
Learner (rllib/core/learner/learner.py:112), EnvRunner
(rllib/env/env_runner.py:36). The architecture survives: env-runner
actors collect trajectories in parallel with numpy inference (no card);
the policy and value MLPs, the clipped-surrogate loss and Adam run on
the learner's device (the card unless the caller asks for the CPU).
``compute_gae``, the advantage normalisation and the minibatch shuffle
by ``np.random.RandomState(cfg.seed)`` stay numpy, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

import ray_tpu_torch
from ray_tpu_torch import default_device
from ray_tpu_torch.rllib.algorithm import AlgorithmConfigBase
from ray_tpu_torch.rllib.env import Env, make_env
from ray_tpu_torch.rllib.rollout import (
    Learner, RunnerAlgorithm, floats, generator, init_mlp_params, mlp_apply, mlp_forward,
    to_device, worker_seed,
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


# ---------------------------------------------------------------------------
# Env runner actor (reference: SingleAgentEnvRunner)
# ---------------------------------------------------------------------------
@ray_tpu_torch.remote
class EnvRunner:
    def __init__(self, env_spec, hidden, seed: int):
        self.env: Env = make_env(env_spec)
        self.hidden = hidden
        self.n_hidden = len(hidden)
        self.rng = np.random.RandomState(seed)
        self.obs, _ = self.env.reset(seed=seed)
        self.episode_return = 0.0
        self.completed_returns: List[float] = []

    def _value(self, obs, params_np: Dict) -> float:
        return float(mlp_forward(params_np["vf"], obs, self.n_hidden)[0])

    def sample(self, params_np: Dict, num_steps: int) -> Dict[str, np.ndarray]:
        """Collect a fragment with the given policy weights (numpy inference
        on the CPU — tiny nets; the learner's device does the learning)."""
        obs_buf, act_buf, rew_buf, done_buf, logp_buf, val_buf = [], [], [], [], [], []
        trunc_buf, boot_buf = [], []
        for _ in range(num_steps):
            logits = mlp_forward(params_np["pi"], self.obs, self.n_hidden)
            z = logits - logits.max()
            p = np.exp(z) / np.exp(z).sum()
            a = int(self.rng.choice(len(p), p=p))
            val = self._value(self.obs, params_np)

            nobs, rew, term, trunc, _ = self.env.step(a)
            obs_buf.append(self.obs)
            act_buf.append(a)
            rew_buf.append(rew)
            done_buf.append(term)
            logp_buf.append(np.log(p[a] + 1e-10))
            val_buf.append(val)
            truncated = bool(trunc and not term)
            trunc_buf.append(truncated)
            # a truncated (not terminated) episode bootstraps from V(s_T)
            # of the state it was cut off at, computed BEFORE the reset
            # (reference rllib postprocessing: truncations bootstrap with
            # the value of the final observation)
            boot_buf.append(self._value(nobs, params_np) if truncated else 0.0)
            self.episode_return += rew
            if term or trunc:
                self.completed_returns.append(self.episode_return)
                self.episode_return = 0.0
                self.obs, _ = self.env.reset()
            else:
                self.obs = nobs
        # bootstrap value for the final state
        last_val = self._value(self.obs, params_np)
        rets = self.completed_returns
        self.completed_returns = []
        return {
            "obs": np.asarray(obs_buf, np.float32),
            "actions": np.asarray(act_buf, np.int32),
            "rewards": np.asarray(rew_buf, np.float32),
            "dones": np.asarray(done_buf, np.bool_),
            "truncs": np.asarray(trunc_buf, np.bool_),
            "bootstrap_values": np.asarray(boot_buf, np.float32),
            "logp": np.asarray(logp_buf, np.float32),
            "values": np.asarray(val_buf, np.float32),
            "last_value": np.float32(last_val),
            "episode_returns": np.asarray(rets, np.float32),
        }


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


# ---------------------------------------------------------------------------
# Algorithm (reference: algorithm.py:208; train() = :1169 step)
# ---------------------------------------------------------------------------
class PPO(RunnerAlgorithm):
    def __init__(self, cfg: PPOConfig, device=None):
        probe = make_env(cfg.env)
        self.cfg = cfg
        self.obs_dim = probe.observation_dim
        self.num_actions = probe.num_actions
        self.learner = PPOLearner(cfg, self.obs_dim, self.num_actions, device=device)
        self.runners = [
            EnvRunner.remote(cfg.env, cfg.hidden, worker_seed(cfg.seed, i))
            for i in range(cfg.num_env_runners)
        ]
        self.iteration = 0
        self._recent_returns: List[float] = []

    def train(self) -> Dict[str, Any]:
        """One training iteration (reference: ppo.py:391 training_step)."""
        cfg = self.cfg
        weights = self.learner.get_weights_np()
        frags = ray_tpu_torch.get(
            [r.sample.remote(weights, cfg.rollout_fragment_length) for r in self.runners]
        )
        parts = []
        for f in frags:
            adv, rets = compute_gae(
                f["rewards"], f["values"], f["dones"], f["last_value"],
                cfg.gamma, cfg.lambda_,
                truncs=f.get("truncs"), bootstrap_values=f.get("bootstrap_values"),
            )
            parts.append(dict(f, adv=adv, returns=rets))
            self._recent_returns.extend(f["episode_returns"].tolist())
        batch = {
            k: np.concatenate([p[k] for p in parts])
            for k in ("obs", "actions", "logp", "adv", "returns")
        }
        metrics = self.learner.update(batch)
        self.iteration += 1
        self._recent_returns = self._recent_returns[-100:]
        mean_ret = float(np.mean(self._recent_returns)) if self._recent_returns else 0.0
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": mean_ret,
            "num_env_steps_sampled": cfg.rollout_fragment_length * cfg.num_env_runners,
            **metrics,
        }


PPOConfig.algo_cls = PPO
