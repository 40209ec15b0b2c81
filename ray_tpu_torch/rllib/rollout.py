"""Shared rollout machinery (PyTorch port of ray_tpu/rllib/rollout.py).

``worker_seed``, the numpy ``mlp_forward``, ``ReplayBuffer`` and the
env-runner actor ``SampleRunner`` are copies: numpy, as the JAX package
has them (tiny nets, policy inference in the runner's process, no
card). ``init_mlp_params`` and ``mlp_apply`` are the torch twins of the
JAX package's, the one network definition every learner (PPO, DQN, SAC,
IMPALA, BC) and Anakin build from. ``RunnerAlgorithm`` is what the
drivers over runner actors share: stopping the runners, and saving and
restoring the learner through ``train.checkpoint``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.adam import Adam, tree_leaves, tree_map
from ray_tpu_torch.rllib.convert import adam_state_from_jax, params_from_jax, to_numpy
from ray_tpu_torch.rllib.env import Env, make_env


def worker_seed(base_seed: int, worker_index: int) -> int:
    """THE seed fan-out: every per-worker RNG in rllib (env runners,
    pod actors, replay buffers, learner ranks) derives its seed from
    the config seed and its worker index through this one function.
    A multiplicative split keeps streams distinct across BOTH axes —
    the naive ``seed + i`` collides (seed=0, i=1) with (seed=1, i=0),
    so two configs differing only in seed could share runner streams."""
    return (int(base_seed) * 1_000_003 + 15_485_863 * (int(worker_index) + 1)) \
        % (2 ** 31 - 1)


def generator(device: torch.device, seed: int) -> torch.Generator:
    """The explicit source of an entry point's random bits, on ``device``."""
    return torch.Generator(device=device).manual_seed(seed)


def to_device(arrays: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """numpy arrays as tensors on ``device``; floats in fp32, as
    ``jnp.asarray`` gives them without x64. A read-only array (a fragment
    read from the object store) is copied: a tensor never aliases it."""
    out = {}
    for k, a in arrays.items():
        a = np.asarray(a)
        if a.dtype.kind == "f":
            a = a.astype(np.float32, copy=False)
        a = np.ascontiguousarray(a)
        if not a.flags.writeable:
            a = a.copy()
        out[k] = torch.from_numpy(a).to(device)
    return out


def floats(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Metric tensors as Python floats (one host sync each)."""
    return {k: float(v.detach()) for k, v in metrics.items()}


def mlp_forward(layers: Dict, x: np.ndarray, n_hidden: int) -> np.ndarray:
    for i in range(n_hidden):
        x = np.tanh(x @ layers[f"w{i}"] + layers[f"b{i}"])
    return x @ layers["head_w"] + layers["head_b"]


def init_mlp_params(gen: torch.Generator, obs_dim: int, hidden: Tuple[int, ...],
                    out_dim: int) -> Dict[str, torch.Tensor]:
    """He-normal hidden weights (normal · √(2/fan_in)), zero biases and a
    zero head, fp32, on ``gen``'s device, as JAX's init draws them (the
    bits differ: the port draws from ``gen``). Each leaf requires grad."""
    sizes = (obs_dim,) + tuple(hidden)
    layers = {}
    for i in range(len(sizes) - 1):
        w = torch.randn((sizes[i], sizes[i + 1]), generator=gen, device=gen.device)
        layers[f"w{i}"] = w * (2.0 / sizes[i]) ** 0.5
        layers[f"b{i}"] = torch.zeros(sizes[i + 1], device=gen.device)
    layers["head_w"] = torch.zeros((sizes[-1], out_dim), device=gen.device)
    layers["head_b"] = torch.zeros(out_dim, device=gen.device)
    return {k: v.requires_grad_() for k, v in layers.items()}


def mlp_apply(layers: Dict[str, torch.Tensor], x: torch.Tensor, n_hidden: int) -> torch.Tensor:
    for i in range(n_hidden):
        x = torch.tanh(x @ layers[f"w{i}"] + layers[f"b{i}"])
    return x @ layers["head_w"] + layers["head_b"]


class Learner:
    """What the learners share: ``params`` (a tree of tensors on
    ``device``), ``optax.adam``'s counterpart ``tx`` and its
    ``opt_state``, one gradient step, and the weights in and out as
    numpy."""

    def _setup(self, params, lr: float, device: torch.device) -> None:
        self.device = device
        self.params = params
        self.tx = Adam(lr)
        self.opt_state = self.tx.init(params)

    def _step(self, loss: torch.Tensor) -> None:
        """Adam on the gradient of ``loss`` (zero for a leaf it does not
        read, as JAX's grad gives)."""
        leaves = tree_leaves(self.params)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        self.tx.update_(self.params, list(grads), self.opt_state)

    def set_weights(self, params, opt_state=None) -> None:
        """The params as numpy (a JAX learner's ``get_weights_np()``) and,
        to continue a run mid-training, optax.adam's state; without it
        Adam starts afresh."""
        self.params = params_from_jax(params, self.device)
        self.opt_state = (self.tx.init(self.params) if opt_state is None
                          else adam_state_from_jax(opt_state, self.device))

    def get_weights_np(self) -> Dict:
        return to_numpy(self.params)

    def state(self) -> Dict[str, Any]:
        """The tree a checkpoint holds (the JAX algorithms' ``save``)."""
        return {"params": self.params, "opt_state": self.opt_state}

    def load_state(self, state: Dict[str, Any]) -> None:
        self.params = tree_map(lambda t: t.requires_grad_(), state["params"])
        self.opt_state = state["opt_state"]


class RunnerAlgorithm:
    """What the algorithms over env-runner actors share: ``runners`` (actor
    handles) and a ``learner`` on its device."""

    runners: List[Any]
    learner: Learner

    def stop(self) -> None:
        for r in self.runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:  # noqa: BLE001
                pass  # runner already dead — kill is best-effort

    # checkpointing (reference: Checkpointable, algorithm.py:208)
    def save(self, path: str) -> None:
        from ray_tpu_torch.train.checkpoint import save_state

        save_state(self.learner.state(), path)

    def restore(self, path: str) -> None:
        from ray_tpu_torch.train.checkpoint import restore_state

        self.learner.load_state(restore_state(path, target=self.learner.state(),
                                              device=self.learner.device))


@ray_tpu_torch.remote
class SampleRunner:
    """Env-runner actor collecting transition fragments.

    mode="categorical": sample from softmax(logits of params[net_key]),
    also records behavior log-probs (IMPALA's v-trace needs them).
    mode="epsilon": epsilon-greedy argmax over params[net_key] outputs
    (Q-values; DQN).
    """

    def __init__(self, env_spec, hidden: Tuple[int, ...], seed: int,
                 mode: str = "categorical", net_key: str = "pi"):
        self.env: Env = make_env(env_spec)
        self.n_hidden = len(hidden)
        self.mode = mode
        self.net_key = net_key
        self.rng = np.random.RandomState(seed)
        self.obs, _ = self.env.reset(seed=seed)
        self.episode_return = 0.0
        self.completed_returns: List[float] = []

    def sample(self, params_np: Dict, num_steps: int,
               epsilon: float = 0.0) -> Dict[str, np.ndarray]:
        net = params_np[self.net_key]
        obs_b, act_b, rew_b, next_b, term_b, trunc_b, logp_b = \
            [], [], [], [], [], [], []
        for _ in range(num_steps):
            out = mlp_forward(net, self.obs, self.n_hidden)
            if self.mode == "epsilon":
                if self.rng.rand() < epsilon:
                    a = int(self.rng.randint(len(out)))
                else:
                    a = int(np.argmax(out))
                logp = 0.0
            else:
                z = out - out.max()
                p = np.exp(z) / np.exp(z).sum()
                a = int(self.rng.choice(len(p), p=p))
                logp = float(np.log(p[a] + 1e-10))
            nobs, rew, term, trunc, _ = self.env.step(a)
            obs_b.append(self.obs)
            act_b.append(a)
            rew_b.append(rew)
            next_b.append(nobs)
            term_b.append(term)
            trunc_b.append(bool(trunc and not term))
            logp_b.append(logp)
            self.episode_return += rew
            if term or trunc:
                self.completed_returns.append(self.episode_return)
                self.episode_return = 0.0
                self.obs, _ = self.env.reset()
            else:
                self.obs = nobs
        rets = self.completed_returns
        self.completed_returns = []
        return {
            "obs": np.asarray(obs_b, np.float32),
            "actions": np.asarray(act_b, np.int32),
            "rewards": np.asarray(rew_b, np.float32),
            "next_obs": np.asarray(next_b, np.float32),
            "terminateds": np.asarray(term_b, np.bool_),
            "truncs": np.asarray(trunc_b, np.bool_),
            "logp": np.asarray(logp_b, np.float32),
            # V(s_T) bootstrap obs for the fragment tail (IMPALA)
            "last_obs": np.asarray(self.obs, np.float32),
            "episode_returns": np.asarray(rets, np.float32),
        }


class ReplayBuffer:
    """Uniform ring buffer (reference:
    rllib/utils/replay_buffers/replay_buffer.py)."""

    def __init__(self, capacity: int, obs_dim: int, seed: int = 0):
        self.capacity = capacity
        self.obs = np.zeros((capacity, obs_dim), np.float32)
        self.next_obs = np.zeros((capacity, obs_dim), np.float32)
        self.actions = np.zeros(capacity, np.int32)
        self.rewards = np.zeros(capacity, np.float32)
        self.terminateds = np.zeros(capacity, np.bool_)
        self._idx = 0
        self._size = 0
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return self._size

    def add_batch(self, frag: Dict[str, np.ndarray]) -> None:
        n = len(frag["obs"])
        for k, buf in (("obs", self.obs), ("next_obs", self.next_obs),
                       ("actions", self.actions), ("rewards", self.rewards),
                       ("terminateds", self.terminateds)):
            data = frag[k]
            idx = (self._idx + np.arange(n)) % self.capacity
            buf[idx] = data
        self._idx = (self._idx + n) % self.capacity
        self._size = min(self._size + n, self.capacity)

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self._rng.randint(0, self._size, size=batch_size)
        return {
            "obs": self.obs[idx],
            "next_obs": self.next_obs[idx],
            "actions": self.actions[idx],
            "rewards": self.rewards[idx],
            "terminateds": self.terminateds[idx],
        }
