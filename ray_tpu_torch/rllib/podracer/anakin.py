"""Anakin — colocated actor/learner: rollout AND update on the card,
with no host round-trip in between (PyTorch port of
ray_tpu/rllib/podracer/anakin.py; reference: Podracer architectures,
arXiv 2104.06272 §2).

JAX's one jitted program becomes two steps of eager device code:
``rollout`` steps the batched torch CartPole (podracer.torch_env) T
times, sampling actions from the policy with the Anakin's generator, and
``learn`` takes the V-trace loss of every env's fragment (the same loss
as the host-side ``IMPALALearner``), its gradient and an Adam step.
Only the metrics and the finished episodes' returns come back to the
host, once a step.

The data axis: JAX shards the envs over local devices with ``pmap`` and
averages with ``lax.pmean``. Here, when a default process group of world
W is up (and ``max_devices != 1``), each rank steps ``num_envs / W``
envs, averages its loss over them, and one all-reduce gives every rank
the mean of the ranks' gradients, loss and metrics: the mean of equal
shards' means, as pmean. Without a group, or at ``max_devices=1``, an
Anakin runs alone.

Loss parity with ``IMPALALearner`` is a tested contract: with one env
and a fixed seed, the loss Anakin reports for a fragment equals what
``IMPALALearner`` computes on that same fragment
(tests/test_torch_anakin.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ray_tpu_torch import default_device
from ray_tpu_torch.rllib.adam import Adam, tree_leaves, tree_map
from ray_tpu_torch.rllib.algorithm import AlgorithmConfigBase
from ray_tpu_torch.rllib.impala import vtrace_loss
from ray_tpu_torch.rllib.podracer import torch_env
from ray_tpu_torch.rllib.podracer.obs import STAGE_UPDATE, StageTimes
from ray_tpu_torch.rllib.ppo import init_policy, policy_logits, take
from ray_tpu_torch.rllib.rollout import generator, worker_seed

METRICS = ("pg_loss", "vf_loss", "entropy")


def fragment_loss(params, batch, *, gamma: float, vf_coeff: float,
                  entropy_coeff: float, rho_bar: float, c_bar: float,
                  n_hidden: int):
    """V-trace loss of a fragment ``[T]`` (0-d results) or of each of B
    fragments ``[T, B]`` (results ``[B]``) — the math of
    ``IMPALALearner``'s loss, shared with it (``impala.vtrace_loss``)."""
    loss, aux = vtrace_loss(params, batch, gamma=gamma, vf_coeff=vf_coeff,
                            entropy_coeff=entropy_coeff, rho_bar=rho_bar, c_bar=c_bar,
                            n_hidden=n_hidden)
    return loss, {k: aux[k] for k in METRICS}


def categorical(logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """One int32 sample from softmax(logits) along the last axis, by
    Gumbel-max (as ``jax.random.categorical``), from ``gen``'s bits."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    u = u.clamp_min(torch.finfo(u.dtype).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), -1).int()


@dataclasses.dataclass
class AnakinConfig(AlgorithmConfigBase):
    """Colocated-fleet config. `num_envs` environments step in lockstep
    on the card; under a process group they are split evenly over the
    ranks (the data axis)."""

    env: Any = "CartPole-v1"
    num_envs: int = 16
    rollout_fragment_length: int = 16
    lr: float = 5e-4
    gamma: float = 0.99
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    rho_bar: float = 1.0
    c_bar: float = 1.0
    iterations_per_train: int = 4
    hidden: Tuple[int, ...] = (64, 64)
    seed: int = 0
    # cap on the data axis's ranks (0 = every rank of the default
    # process group); 1 runs alone even under a group — needed wherever
    # single-program semantics matter (loss-parity extraction, debugging)
    max_devices: int = 0


def data_axis(max_devices: int) -> Tuple[int, int]:
    """(world, rank) of the data axis: the default process group's, or
    (1, 0) without one or at ``max_devices=1``."""
    if max_devices == 1 or not (dist.is_available() and dist.is_initialized()):
        return 1, 0
    world = dist.get_world_size()
    if max_devices and max_devices < world:
        raise NotImplementedError(
            f"max_devices={max_devices} under a process group of {world}: the data axis "
            "spans the whole default group (or 1 rank)")
    return world, dist.get_rank()


class Anakin:
    """Per train step: a T-step rollout over the batched env, then the
    V-trace loss and an Adam step, all on the card."""

    def __init__(self, cfg: AnakinConfig, device=None):
        if cfg.env not in ("CartPole-v1",):
            raise ValueError(
                "Anakin requires an env that steps on the device; built-in support "
                f"is CartPole-v1 (got {cfg.env!r})")
        self.device = default_device(device)
        self.cfg = cfg
        self.obs_dim = 4
        self.num_actions = 2
        self.n_hidden = len(cfg.hidden)
        self.num_devices, self.rank = data_axis(cfg.max_devices)
        if cfg.num_envs % self.num_devices:
            raise ValueError(
                f"num_envs={cfg.num_envs} must divide evenly across "
                f"{self.num_devices} ranks of the data axis")
        self.params = init_policy(generator(self.device, worker_seed(cfg.seed, 0)),
                                  self.obs_dim, self.num_actions, cfg.hidden)
        if self.num_devices > 1:  # one init on every rank, as pmap replicates it
            with torch.no_grad():
                for t in tree_leaves(self.params):
                    dist.broadcast(t, 0)
        self.tx = Adam(cfg.lr)
        self.opt_state = self.tx.init(self.params)

        self._gen = generator(self.device, worker_seed(cfg.seed, 1 + self.rank))
        per = cfg.num_envs // self.num_devices
        obs0, t0 = torch_env.reset(per, self._gen)
        self._env = (obs0, t0, torch.zeros(per, device=self.device))  # + episode ret

        self.iteration = 0
        self.total_env_steps = 0
        self._recent_returns: List[float] = []
        self._stages = StageTimes()
        self.last_fragment: Dict[str, np.ndarray] = {}

    # -- the device step ------------------------------------------------
    @torch.no_grad()
    def rollout(self, params, env, gen: torch.Generator):
        """T steps of every env under the policy ``params``: the env state
        after them and the trajectory ``[T, B]`` (obs, actions, rewards,
        terminateds, truncs = trunc & ~term, logp, ret_done = the episode
        return where an episode ended, else NaN), with last_obs ``[B, 4]``
        (after the auto-reset, as SampleRunner's tails)."""
        obs_b, t_b, ret_b = env
        steps: Dict[str, list] = {k: [] for k in ("obs", "actions", "rewards", "terminateds",
                                                  "truncs", "logp", "ret_done")}
        for _ in range(self.cfg.rollout_fragment_length):
            logits = policy_logits(params, obs_b, self.n_hidden)
            actions = categorical(logits, gen)
            logp = take(F.log_softmax(logits, -1), actions)
            reset = torch_env.reset_obs(obs_b.shape[0], gen)
            (nobs, nt), rew, term, trunc = torch_env.step_autoreset((obs_b, t_b), actions, reset)
            done = term | trunc
            for k, v in (("obs", obs_b), ("actions", actions), ("rewards", rew),
                         ("terminateds", term), ("truncs", trunc & ~term), ("logp", logp),
                         ("ret_done", torch.where(done, ret_b + rew, math.nan))):
                steps[k].append(v)
            obs_b, t_b, ret_b = nobs, nt, torch.where(done, 0.0, ret_b + rew)
        traj = {k: torch.stack(v) for k, v in steps.items()}
        traj["last_obs"] = obs_b
        return (obs_b, t_b, ret_b), traj

    def learn(self, params, opt_state, traj) -> Dict[str, torch.Tensor]:
        """The loss averaged over the trajectory's envs, its gradient (the
        mean over the data axis's ranks), and an Adam step on ``params``
        and ``opt_state`` in place. Returns the metrics of the params
        before the step, averaged over the ranks."""
        cfg = self.cfg
        batch = {"obs": traj["obs"], "actions": traj["actions"], "rewards": traj["rewards"],
                 "dones": traj["terminateds"] | traj["truncs"], "logp": traj["logp"],
                 "last_obs": traj["last_obs"]}
        losses, auxs = fragment_loss(params, batch, gamma=cfg.gamma, vf_coeff=cfg.vf_coeff,
                                     entropy_coeff=cfg.entropy_coeff, rho_bar=cfg.rho_bar,
                                     c_bar=cfg.c_bar, n_hidden=self.n_hidden)
        loss = torch.mean(losses)
        leaves = tree_leaves(params)
        grads = list(torch.autograd.grad(loss, leaves, allow_unused=True,
                                         materialize_grads=True))
        metrics = {k: torch.mean(v).detach() for k, v in auxs.items()}
        metrics["total_loss"] = loss.detach()
        if self.num_devices > 1:  # lax.pmean: one all-reduce of grads and metrics
            flat = torch.cat([g.reshape(-1) for g in grads] + [torch.stack(list(metrics.values()))])
            dist.all_reduce(flat)
            flat.div_(self.num_devices)
            parts = flat.split([g.numel() for g in grads] + [len(metrics)])
            grads = [p.view_as(g) for p, g in zip(parts, grads)]
            metrics = dict(zip(metrics, parts[-1].unbind()))
        self.tx.update_(params, grads, opt_state)
        return metrics

    def _one_step(self):
        self._env, traj = self.rollout(self.params, self._env, self._gen)
        metrics = self.learn(self.params, self.opt_state, traj)
        return metrics, traj, traj.pop("ret_done")

    def _all_envs(self, t: torch.Tensor) -> torch.Tensor:
        """``t [T, B/W]`` of every rank, as ``[T, B]``."""
        if self.num_devices == 1:
            return t
        parts = [torch.empty_like(t) for _ in range(self.num_devices)]
        dist.all_gather(parts, t.contiguous())
        return torch.cat(parts, 1)

    # -- the algorithm's API -------------------------------------------
    def train(self) -> Dict[str, Any]:
        cfg = self.cfg
        metrics: Dict[str, float] = {}
        # env stepping and update run back to back on the card — the whole
        # step is attributed to STAGE_UPDATE, as in the JAX package
        for _ in range(cfg.iterations_per_train):
            with self._stages.track(STAGE_UPDATE):
                m, frag, ret_done = self._one_step()
            self.total_env_steps += cfg.num_envs * cfg.rollout_fragment_length
            metrics = {k: float(v) for k, v in m.items()}
            rets = self._all_envs(ret_done).cpu().numpy().ravel()
            self._recent_returns.extend(rets[~np.isnan(rets)].tolist())
        self.last_fragment = {k: v.cpu().numpy() for k, v in frag.items()}
        self.iteration += 1
        self._recent_returns = self._recent_returns[-100:]
        mean_ret = float(np.mean(self._recent_returns)) \
            if self._recent_returns else 0.0
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": mean_ret,
            "num_env_steps_sampled": self.total_env_steps,
            "stage_s": self._stages.snapshot(),
            **metrics,
        }

    def fragment_for_env(self, b: int = 0) -> Dict[str, np.ndarray]:
        """The most recent fragment of env `b`, in the host IMPALA
        learner's batch layout (parity-test hook)."""
        f = self.last_fragment
        if not f:
            raise RuntimeError("no fragment yet — call train() first")
        if self.num_devices > 1:
            raise NotImplementedError(
                "parity extraction is single-rank only")
        return {
            "obs": f["obs"][:, b],
            "actions": f["actions"][:, b],
            "rewards": f["rewards"][:, b],
            "terminateds": f["terminateds"][:, b],
            "truncs": f["truncs"][:, b],
            "logp": f["logp"][:, b],
            "last_obs": f["last_obs"][b],
            "episode_returns": np.zeros(0, np.float32),
        }

    def stop(self) -> None:  # API symmetry with the fleet algorithms
        pass

    def _state(self):
        return tree_map(lambda t: t.detach(), {"params": self.params,
                                               "opt_state": self.opt_state})

    def save(self, path: str) -> None:
        from ray_tpu_torch.train.checkpoint import save_state

        save_state(self._state(), path)

    def restore(self, path: str) -> None:
        from ray_tpu_torch.train.checkpoint import restore_state

        mine = self._state()
        state = restore_state(path, target=mine, device=self.device)
        with torch.no_grad():
            tree_map(lambda t, s: t.copy_(s), mine, state)


AnakinConfig.algo_cls = Anakin
