"""Multi-agent RL: env API, per-policy module mapping, shared-or-
separate learners (PyTorch port of ray_tpu/rllib/multi_agent.py).

Reference: rllib/env/multi_agent_env.py:30 (MultiAgentEnv — dict-keyed
obs/action/reward spaces, "__all__" termination),
rllib/core/rl_module/multi_rl_module.py (one module per policy id) and
the ``policy_mapping_fn`` contract (agent id → policy id; N agents may
share one policy, pooling their experience into one learner batch).

Rollouts stay numpy-on-CPU in env-runner actors (tiny nets, many steps),
while each policy's PPO update is the same learner the single-agent
path uses, on the learner's device — policies are just entries in a
dict of learners, so "shared" vs "separate" is purely what the mapping
function returns.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.ppo import PPOConfig, PPOLearner, compute_gae
from ray_tpu_torch.rllib.rollout import mlp_forward


class MultiAgentEnv:
    """Dict-keyed env API (reference: multi_agent_env.py:30). step()
    returns (obs, rewards, terminateds, truncateds, infos), each a dict
    keyed by agent id; terminateds/truncateds carry an "__all__" key
    that ends the episode for everyone."""

    agents: List[str] = []

    def reset(self, seed: Optional[int] = None
              ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        raise NotImplementedError

    def step(self, action_dict: Dict[str, int]):
        raise NotImplementedError

    @property
    def observation_dims(self) -> Dict[str, int]:
        raise NotImplementedError

    @property
    def action_counts(self) -> Dict[str, int]:
        raise NotImplementedError


class CoordinationGame(MultiAgentEnv):
    """2-agent cooperative toy: both agents see the other's LAST action
    (one-hot) and are rewarded only when they pick the same action this
    step. Optimal play converges to a convention — learnable in a few
    hundred steps, deterministic, no external deps (the multi-agent
    analogue of CartPole-as-test-env)."""

    agents = ["a0", "a1"]
    _N = 2  # actions per agent

    def __init__(self, episode_len: int = 16):
        self.episode_len = episode_len
        self._t = 0
        self._last = [0, 0]

    def _obs(self) -> Dict[str, np.ndarray]:
        def one_hot(i):
            v = np.zeros(self._N, np.float32)
            v[i] = 1.0
            return v

        # each agent sees the OTHER agent's previous action
        return {"a0": one_hot(self._last[1]), "a1": one_hot(self._last[0])}

    def reset(self, seed: Optional[int] = None):
        self._t = 0
        self._last = [0, 0]
        return self._obs(), {}

    def step(self, action_dict: Dict[str, int]):
        a0, a1 = int(action_dict["a0"]), int(action_dict["a1"])
        self._last = [a0, a1]
        self._t += 1
        r = 1.0 if a0 == a1 else 0.0
        rewards = {"a0": r, "a1": r}
        done = self._t >= self.episode_len
        terms = {"a0": done, "a1": done, "__all__": done}
        truncs = {"a0": False, "a1": False, "__all__": False}
        return self._obs(), rewards, terms, truncs, {}

    @property
    def observation_dims(self) -> Dict[str, int]:
        return {"a0": self._N, "a1": self._N}

    @property
    def action_counts(self) -> Dict[str, int]:
        return {"a0": self._N, "a1": self._N}


@ray_tpu_torch.remote
class MultiAgentEnvRunner:
    """Samples fragments from one multi-agent env with per-policy
    weights (reference: MultiAgentEnvRunner). Buffers are kept per
    AGENT (each agent is its own GAE stream) and tagged with the
    policy id that acted for it."""

    def __init__(self, env_creator_bytes: bytes, mapping_bytes: bytes,
                 hidden, seed: int):
        from ray_tpu_torch._private.serialization import loads_function

        self.env: MultiAgentEnv = loads_function(env_creator_bytes)()
        self.mapping: Callable[[str], str] = loads_function(mapping_bytes)
        self.n_hidden = len(hidden)
        self.rng = np.random.RandomState(seed)
        self.obs, _ = self.env.reset(seed=seed)
        self.ep_return = 0.0
        self.completed: List[float] = []

    def _forward(self, weights, policy_id, obs):
        w = weights[policy_id]
        logits = mlp_forward(w["pi"], obs, self.n_hidden)
        value = float(mlp_forward(w["vf"], obs, self.n_hidden)[0])
        return logits, value

    def sample(self, weights: Dict[str, Dict], num_steps: int
               ) -> Dict[str, Dict[str, np.ndarray]]:
        """num_steps env steps; returns per-AGENT fragments (the
        algorithm groups them by policy for the learners)."""
        bufs: Dict[str, Dict[str, list]] = {}

        def buf(aid):
            if aid not in bufs:
                bufs[aid] = {k: [] for k in
                             ("obs", "actions", "rewards", "dones",
                              "truncs", "bootstrap_values", "logp",
                              "values")}
            return bufs[aid]

        for _ in range(num_steps):
            acts: Dict[str, int] = {}
            step_info: Dict[str, Tuple] = {}
            for aid, ob in self.obs.items():
                pid = self.mapping(aid)
                logits, val = self._forward(weights, pid, ob)
                z = logits - logits.max()
                p = np.exp(z) / np.exp(z).sum()
                a = int(self.rng.choice(len(p), p=p))
                acts[aid] = a
                step_info[aid] = (ob, a, float(np.log(p[a] + 1e-10)), val)
            nobs, rewards, terms, truncs, _ = self.env.step(acts)
            done_all = terms.get("__all__", False)
            trunc_all = truncs.get("__all__", False)
            for aid, (ob, a, logp, val) in step_info.items():
                b = buf(aid)
                term = bool(terms.get(aid, False) or done_all)
                trunc = bool((truncs.get(aid, False) or trunc_all)
                             and not term)
                b["obs"].append(ob)
                b["actions"].append(a)
                b["rewards"].append(float(rewards.get(aid, 0.0)))
                b["dones"].append(term)
                b["truncs"].append(trunc)
                b["logp"].append(logp)
                b["values"].append(val)
                if trunc and aid in nobs:
                    pid = self.mapping(aid)
                    _, bv = self._forward(weights, pid, nobs[aid])
                    b["bootstrap_values"].append(bv)
                else:
                    b["bootstrap_values"].append(0.0)
                self.ep_return += float(rewards.get(aid, 0.0))
            if done_all or trunc_all:
                self.completed.append(self.ep_return)
                self.ep_return = 0.0
                self.obs, _ = self.env.reset()
            else:
                self.obs = nobs
        out: Dict[str, Dict[str, np.ndarray]] = {}
        for aid, b in bufs.items():
            pid = self.mapping(aid)
            last_val = 0.0
            if aid in self.obs:
                _, last_val = self._forward(weights, pid, self.obs[aid])
            out[aid] = {
                "policy_id": pid,
                "obs": np.asarray(b["obs"], np.float32),
                "actions": np.asarray(b["actions"], np.int32),
                "rewards": np.asarray(b["rewards"], np.float32),
                "dones": np.asarray(b["dones"], np.bool_),
                "truncs": np.asarray(b["truncs"], np.bool_),
                "bootstrap_values": np.asarray(b["bootstrap_values"],
                                               np.float32),
                "logp": np.asarray(b["logp"], np.float32),
                "values": np.asarray(b["values"], np.float32),
                "last_value": np.float32(last_val),
            }
        rets = self.completed
        self.completed = []
        out["__episode_returns__"] = {
            "policy_id": "", "returns": np.asarray(rets, np.float32)}
        return out


class MultiAgentPPOConfig(PPOConfig):
    """Builder additions (reference: AlgorithmConfig.multi_agent()):
    ``policies`` maps policy id -> (obs_dim, num_actions) — None infers
    both from the env — and ``policy_mapping_fn`` routes agents."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.policies: Optional[Dict[str, Tuple[int, int]]] = None
        self.policy_mapping_fn: Callable[[str], str] = lambda aid: aid
        self.env_creator: Optional[Callable[[], MultiAgentEnv]] = None

    def multi_agent(self, *, policies=None, policy_mapping_fn=None
                    ) -> "MultiAgentPPOConfig":
        if policies is not None:
            self.policies = policies
        if policy_mapping_fn is not None:
            self.policy_mapping_fn = policy_mapping_fn
        return self

    def environment(self, env) -> "MultiAgentPPOConfig":
        self.env_creator = env if callable(env) else None
        if not callable(env):
            raise ValueError(
                "multi-agent environment must be a creator callable")
        return self


class MultiAgentPPO:
    """PPO over a dict of policies (reference: algorithm.py +
    multi_rl_module.py). Shared policies (mapping several agents to one
    id) pool experience into one learner update; separate policies
    learn independently — the same PPOLearner per policy either way, on
    ``device``."""

    def __init__(self, cfg: MultiAgentPPOConfig, device=None):
        from ray_tpu_torch._private.serialization import dumps_function

        if cfg.env_creator is None:
            raise ValueError("config.environment(creator) is required")
        self.cfg = cfg
        probe = cfg.env_creator()
        obs_dims = probe.observation_dims
        act_counts = probe.action_counts
        if cfg.policies is None:
            pols: Dict[str, Tuple[int, int]] = {}
            for aid in probe.agents:
                pid = cfg.policy_mapping_fn(aid)
                pols[pid] = (obs_dims[aid], act_counts[aid])
            cfg.policies = pols
        self.learners: Dict[str, PPOLearner] = {
            pid: PPOLearner(cfg, obs_dim, n_act, device=device)
            for pid, (obs_dim, n_act) in cfg.policies.items()
        }
        env_b = dumps_function(cfg.env_creator)
        map_b = dumps_function(cfg.policy_mapping_fn)
        self.runners = [
            MultiAgentEnvRunner.remote(env_b, map_b, cfg.hidden,
                                       cfg.seed + i)
            for i in range(cfg.num_env_runners)
        ]
        self.iteration = 0
        self._recent: List[float] = []

    def train(self) -> Dict[str, Any]:
        cfg = self.cfg
        weights = {pid: ln.get_weights_np()
                   for pid, ln in self.learners.items()}
        frags = ray_tpu_torch.get([
            r.sample.remote(weights, cfg.rollout_fragment_length)
            for r in self.runners
        ])
        per_policy: Dict[str, List[Dict]] = {}
        for frag in frags:
            for aid, f in frag.items():
                if aid == "__episode_returns__":
                    self._recent.extend(f["returns"].tolist())
                    continue
                adv, rets = compute_gae(
                    f["rewards"], f["values"], f["dones"],
                    f["last_value"], cfg.gamma, cfg.lambda_,
                    truncs=f["truncs"],
                    bootstrap_values=f["bootstrap_values"])
                per_policy.setdefault(f["policy_id"], []).append(
                    dict(f, adv=adv, returns=rets))
        metrics: Dict[str, Any] = {}
        for pid, parts in per_policy.items():
            batch = {k: np.concatenate([p[k] for p in parts])
                     for k in ("obs", "actions", "logp", "adv", "returns")}
            m = self.learners[pid].update(batch)
            metrics.update({f"{pid}/{k}": v for k, v in m.items()})
        self.iteration += 1
        self._recent = self._recent[-100:]
        metrics.update({
            "training_iteration": self.iteration,
            "episode_return_mean": float(np.mean(self._recent))
            if self._recent else 0.0,
        })
        return metrics

    def stop(self) -> None:
        for r in self.runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:  # noqa: BLE001
                pass


MultiAgentPPOConfig.algo_cls = MultiAgentPPO
