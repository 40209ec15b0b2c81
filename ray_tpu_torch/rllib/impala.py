"""IMPALA's learner in process (PyTorch port of ray_tpu/rllib/impala.py):
V-trace off-policy correction (Espeholt et al., public algorithm).

Reference: rllib/algorithms/impala/impala.py:643 (`IMPALA`). ``vtrace``
is the reverse recurrence of the JAX package's ``lax.scan`` V-trace as a
loop over the leading T axis, batched over any trailing axes (Anakin's
envs), with fp32 carries; ``vtrace_np`` is the numpy reference, copied.
``IMPALALearner`` runs the V-trace policy-gradient, value and entropy
loss and Adam on the card. The async algorithm ``IMPALA`` (env-runner
actors) waits for the actor runtime and raises.

Mid-fragment truncations are treated as terminations for the discount
(small value bias at time-limit boundaries; the fragment TAIL always
bootstraps from V(last_obs)).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch import default_device
from ray_tpu_torch.rllib.algorithm import AlgorithmConfigBase, waits_for_runtime
from ray_tpu_torch.rllib.ppo import entropy_of, init_policy, policy_logits, take, value_fn
from ray_tpu_torch.rllib.rollout import Learner, floats, generator, to_device, worker_seed


def vtrace_np(values, next_values, rewards, discounts, rhos, cs,
              rho_bar: float = 1.0, c_bar: float = 1.0):
    """Naive numpy V-trace (reference implementation for tests).

    values/next_values/rewards/discounts/rhos/cs: [T].
    Returns (vs, pg_advantages)."""
    T = len(values)
    rhos_c = np.minimum(rho_bar, rhos)
    cs_c = np.minimum(c_bar, cs)
    vs = np.zeros(T, np.float64)
    acc = 0.0  # carries vs_{t+1} - V(x_{t+1})
    for t in reversed(range(T)):
        delta = rhos_c[t] * (
            rewards[t] + discounts[t] * next_values[t] - values[t])
        acc = delta + discounts[t] * cs_c[t] * acc
        vs[t] = values[t] + acc
    vs_next = np.concatenate([vs[1:], [next_values[-1]]])
    pg_adv = rhos_c * (rewards + discounts * vs_next - values)
    return vs, pg_adv


@torch.no_grad()
def vtrace(values, next_values, rewards, discounts, rhos, cs,
           rho_bar: float = 1.0, c_bar: float = 1.0):
    """V-trace over the leading T axis of fp32 tensors ``[T, ...]``:
    returns (vs, pg_advantages), no gradient. The accumulator
    acc_t = δ_t + γ_t c_t acc_{t+1} starts at 0 after the last step."""
    rhos_c = torch.clamp(rhos, max=rho_bar)
    cs_c = torch.clamp(cs, max=c_bar)
    deltas = rhos_c * (rewards + discounts * next_values - values)
    disc_c = discounts * cs_c
    acc = torch.zeros_like(deltas[0])
    accs = []
    for t in reversed(range(deltas.shape[0])):
        acc = deltas[t] + disc_c[t] * acc
        accs.append(acc)
    vs = values + torch.stack(accs[::-1])
    vs_next = torch.cat([vs[1:], next_values[-1:]])
    pg_adv = rhos_c * (rewards + discounts * vs_next - values)
    return vs, pg_adv


def vtrace_loss(params, batch, *, gamma: float, vf_coeff: float, entropy_coeff: float,
                rho_bar: float, c_bar: float, n_hidden: int):
    """The V-trace loss of fragments ``[T]`` or ``[T, B...]`` (obs
    ``[T, B..., obs_dim]``, last_obs ``[B..., obs_dim]``): the loss and
    its parts per fragment (0-d for one), with ``mean_rho``. The math of
    JAX's ``IMPALALearner`` loss and of Anakin's ``fragment_loss``."""
    logp_all = F.log_softmax(policy_logits(params, batch["obs"], n_hidden), -1)
    logp = take(logp_all, batch["actions"])
    values = value_fn(params, batch["obs"], n_hidden)
    # V(x_{t+1}): next value within the fragment; the tail bootstraps
    # from V(last_obs)
    last_v = value_fn(params, batch["last_obs"], n_hidden)
    next_values = torch.cat([values[1:], last_v[None]])
    ratios = torch.exp(logp - batch["logp"])
    discounts = gamma * (1.0 - batch["dones"].float())
    vs, pg_adv = vtrace(values.detach(), next_values.detach(), batch["rewards"], discounts,
                        ratios.detach(), ratios.detach(), rho_bar=rho_bar, c_bar=c_bar)
    pg_loss = -torch.mean(logp * pg_adv, 0)
    vf_loss = 0.5 * torch.mean((values - vs) ** 2, 0)
    entropy = torch.mean(entropy_of(logp_all), 0)
    loss = pg_loss + vf_coeff * vf_loss - entropy_coeff * entropy
    return loss, {"pg_loss": pg_loss, "vf_loss": vf_loss, "entropy": entropy,
                  "mean_rho": torch.mean(torch.clamp(ratios, max=rho_bar), 0)}


@dataclasses.dataclass
class IMPALAConfig(AlgorithmConfigBase):
    """Builder-style config (reference: IMPALAConfig, impala.py)."""

    env: Any = "CartPole-v1"
    num_env_runners: int = 2
    rollout_fragment_length: int = 128
    lr: float = 5e-4
    gamma: float = 0.99
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    rho_bar: float = 1.0  # V-trace importance clips
    c_bar: float = 1.0
    fragments_per_iteration: int = 4
    hidden: Tuple[int, ...] = (64, 64)
    seed: int = 0


class IMPALALearner(Learner):
    def __init__(self, cfg: IMPALAConfig, obs_dim: int, num_actions: int, device=None):
        device = default_device(device)
        self.cfg = cfg
        self.n_hidden = len(cfg.hidden)
        gen = generator(device, worker_seed(cfg.seed, 0))
        self._setup(init_policy(gen, obs_dim, num_actions, cfg.hidden), cfg.lr, device)

    def loss_fn(self, params, batch):
        cfg = self.cfg
        return vtrace_loss(params, batch, gamma=cfg.gamma, vf_coeff=cfg.vf_coeff,
                           entropy_coeff=cfg.entropy_coeff, rho_bar=cfg.rho_bar,
                           c_bar=cfg.c_bar, n_hidden=self.n_hidden)

    def _update(self, batch) -> Dict[str, torch.Tensor]:
        loss, aux = self.loss_fn(self.params, batch)
        self._step(loss)
        return dict(aux, total_loss=loss)

    def update(self, frag: Dict[str, np.ndarray]) -> Dict[str, float]:
        batch = to_device({
            "obs": frag["obs"], "actions": frag["actions"], "rewards": frag["rewards"],
            "dones": np.logical_or(frag["terminateds"], frag["truncs"]),
            "logp": frag["logp"], "last_obs": frag["last_obs"]}, self.device)
        return floats(self._update(batch))

    def get_policy_np(self) -> Dict:
        """Only the actor net — the runners don't read the vf head."""
        return {"pi": self.get_weights_np()["pi"]}


IMPALA = waits_for_runtime("IMPALA", "the async IMPALA algorithm (env-runner actors)")
IMPALAConfig.algo_cls = IMPALA
