"""Offline RL: experience writing/reading + behavior cloning (PyTorch
port of ray_tpu/rllib/offline.py).

Reference: rllib/offline/ — ``JsonWriter``/``JsonReader`` persist
SampleBatches as JSONL episodes, and offline algorithms (BC, CQL,
MARWIL) train from those files instead of a live env. The I/O pair and
``collect_offline_data`` are numpy copies of the JAX package's; ``BC``
(the canonical offline baseline: cross-entropy of the policy's action
distribution against the logged actions) fits the policy MLP that the
online learners share, with Adam on the card, in process, as in JAX:
``BCConfig(...).offline_data(path).build(device=...)`` reads the data.
"""

from __future__ import annotations

import dataclasses
import glob as _glob
import json
import os
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch import default_device
from ray_tpu_torch.rllib.algorithm import AlgorithmConfigBase
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.ppo import init_policy, policy_logits, take
from ray_tpu_torch.rllib.rollout import Learner, generator, mlp_forward, worker_seed
class JsonWriter:
    """Append SampleBatch dicts as JSONL (reference:
    rllib/offline/json_writer.py). One line per batch; arrays are
    listified. Rolls to a new file every ``max_file_size`` bytes."""

    def __init__(self, path: str, max_file_size: int = 64 << 20):
        self.path = path
        self.max_file_size = max_file_size
        os.makedirs(path, exist_ok=True)
        self._index = 0
        self._f = None

    def _file(self):
        if self._f is None or self._f.tell() > self.max_file_size:
            if self._f is not None:
                self._f.close()
            self._index += 1
            self._f = open(os.path.join(
                self.path, f"output-{self._index:05d}.jsonl"), "a")
        return self._f

    def write(self, batch: Dict[str, Any]) -> None:
        row = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
               for k, v in batch.items()}
        f = self._file()
        f.write(json.dumps(row) + "\n")
        f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class JsonReader:
    """Iterate SampleBatches back out of a JSONL directory or glob
    (reference: rllib/offline/json_reader.py)."""

    _ARRAY_KEYS = {"obs", "actions", "rewards", "dones", "logp",
                   "values", "adv", "returns"}

    def __init__(self, path: str):
        if os.path.isdir(path):
            self.files = sorted(
                _glob.glob(os.path.join(path, "*.jsonl")))
        else:
            self.files = sorted(_glob.glob(path))
        if not self.files:
            raise FileNotFoundError(f"no offline data under {path!r}")

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for fp in self.files:
            with open(fp) as f:
                for line in f:
                    row = json.loads(line)
                    yield {
                        k: (np.asarray(v) if k in self._ARRAY_KEYS
                            else v)
                        for k, v in row.items()
                    }

    def read_all(self) -> Dict[str, np.ndarray]:
        """Concatenate every batch into one big SampleBatch."""
        parts = list(self)
        keys = [k for k in parts[0] if k in self._ARRAY_KEYS]
        return {k: np.concatenate([np.atleast_1d(p[k]) for p in parts])
                for k in keys}


def collect_offline_data(env_spec, policy_fn, path: str,
                         num_episodes: int = 20,
                         seed: int = 0) -> str:
    """Roll ``policy_fn(obs) -> action`` in the env and log episodes —
    the 'historic data' generator for offline training and tests."""
    env = make_env(env_spec)
    writer = JsonWriter(path)
    rng = np.random.RandomState(seed)
    _ = rng
    for ep in range(num_episodes):
        obs, _info = env.reset(seed=seed + ep)
        done = False
        rows: Dict[str, List] = {"obs": [], "actions": [], "rewards": [],
                                 "dones": []}
        while not done:
            a = int(policy_fn(obs))
            nobs, rew, term, trunc, _ = env.step(a)
            rows["obs"].append(np.asarray(obs, np.float32).tolist())
            rows["actions"].append(a)
            rows["rewards"].append(float(rew))
            rows["dones"].append(bool(term))
            done = bool(term or trunc)
            obs = nobs
        writer.write({
            "type": "episode",
            "obs": np.asarray(rows["obs"], np.float32),
            "actions": np.asarray(rows["actions"], np.int32),
            "rewards": np.asarray(rows["rewards"], np.float32),
            "dones": np.asarray(rows["dones"], np.bool_),
        })
    writer.close()
    return path


@dataclasses.dataclass
class BCConfig(AlgorithmConfigBase):
    """Behavior cloning (reference: rllib/algorithms/bc). ``input_``
    names the offline data path (rllib's config key, trailing
    underscore and all)."""

    env: Any = "CartPole-v1"  # used for obs/action dims only
    input_: str = ""
    lr: float = 1e-3
    train_batch_size: int = 256
    hidden: Tuple[int, ...] = (64, 64)
    seed: int = 0

    def offline_data(self, input_: str) -> "BCConfig":
        self.input_ = input_
        return self


class BC(Learner):
    """Supervised π(a|s) fit to logged actions — one Adam step a train()."""

    def __init__(self, cfg: BCConfig, device=None):
        device = default_device(device)
        probe = make_env(cfg.env)
        self.cfg = cfg
        self.obs_dim = probe.observation_dim
        self.num_actions = probe.num_actions
        self.n_hidden = len(cfg.hidden)
        gen = generator(device, worker_seed(cfg.seed, 0))
        self._setup(init_policy(gen, self.obs_dim, self.num_actions, cfg.hidden),
                    cfg.lr, device)
        self.data = JsonReader(cfg.input_).read_all()
        self.rng = np.random.RandomState(cfg.seed)
        self.iteration = 0

    def loss_fn(self, params, obs, actions):
        logp = F.log_softmax(policy_logits(params, obs, self.n_hidden), -1)
        return torch.mean(-take(logp, actions))

    def train(self) -> Dict[str, Any]:
        n = len(self.data["actions"])
        idx = self.rng.randint(0, n, size=min(self.cfg.train_batch_size, n))
        obs = torch.from_numpy(np.asarray(self.data["obs"], np.float32)[idx]).to(self.device)
        acts = torch.from_numpy(np.asarray(self.data["actions"], np.int32)[idx]).to(self.device)
        loss = self.loss_fn(self.params, obs, acts)
        self._step(loss)
        self.iteration += 1
        return {"training_iteration": self.iteration, "bc_loss": float(loss.detach())}

    def compute_single_action(self, obs) -> int:
        logits = mlp_forward(self.get_weights_np()["pi"], np.asarray(obs, np.float32),
                             self.n_hidden)
        return int(np.argmax(logits))


BCConfig.algo_cls = BC
