"""Shared rollout machinery (PyTorch port of ray_tpu/rllib/rollout.py).

``worker_seed``, the numpy ``mlp_forward`` and ``ReplayBuffer`` are
copies: numpy, as the JAX package has them. ``init_mlp_params`` and
``mlp_apply`` are the torch twins of the JAX package's, the one network
definition every learner (PPO, DQN, SAC, IMPALA, BC) and Anakin build
from. ``SampleRunner``, the env-runner actor, waits for the actor
runtime and raises.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ray_tpu_torch.rllib.adam import Adam, tree_leaves
from ray_tpu_torch.rllib.algorithm import waits_for_runtime
from ray_tpu_torch.rllib.convert import adam_state_from_jax, params_from_jax, to_numpy


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
    ``jnp.asarray`` gives them without x64."""
    out = {}
    for k, a in arrays.items():
        a = np.asarray(a)
        if a.dtype.kind == "f":
            a = a.astype(np.float32, copy=False)
        out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
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


SampleRunner = waits_for_runtime("SampleRunner", "the env-runner actor")


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
