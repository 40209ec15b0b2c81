"""Batched torch CartPole for the Anakin architecture (PyTorch port of
ray_tpu/rllib/podracer/jax_env.py).

Anakin (arXiv 2104.06272) steps the environment on the device beside
the learner, so the environment is tensor code. This module has the
math of ``ray_tpu.rllib.env.CartPole`` and of the JAX package's
``jax_env`` (same constants, termination thresholds and 500-step
truncation), batched by nature where JAX vmaps one env.

State: ``(obs [B, 4] fp32, t [B] int32)``. Nothing here draws ambient
randomness: ``reset`` takes a generator, and ``step_autoreset`` the
reset observations, where JAX takes a key.
"""

from __future__ import annotations

from typing import Tuple

import torch

GRAVITY = 9.8
MASSCART = 1.0
MASSPOLE = 0.1
LENGTH = 0.5
FORCE_MAG = 10.0
TAU = 0.02
X_THRESHOLD = 2.4
THETA_THRESHOLD = 12 * 2 * 3.141592653589793 / 360
MAX_STEPS = 500

State = Tuple[torch.Tensor, torch.Tensor]


def reset_obs(n: int, gen: torch.Generator) -> torch.Tensor:
    """``n`` fresh observations, U(−0.05, 0.05), on ``gen``'s device."""
    u = torch.rand((n, 4), generator=gen, device=gen.device)
    return u * (0.05 - -0.05) + -0.05


def reset(n: int, gen: torch.Generator) -> State:
    """``n`` fresh (obs, t) states."""
    return reset_obs(n, gen), torch.zeros(n, dtype=torch.int32, device=gen.device)


def step(state: State, action: torch.Tensor):
    """One dynamics step of every env. Returns (next_state, reward,
    terminated, truncated) — the math of env.CartPole.step."""
    obs, t = state
    x, x_dot, theta, theta_dot = obs.unbind(-1)
    force = torch.where(action == 1, FORCE_MAG, -FORCE_MAG).to(obs.dtype)
    costheta, sintheta = torch.cos(theta), torch.sin(theta)
    total_mass = MASSCART + MASSPOLE
    polemass_length = MASSPOLE * LENGTH
    temp = (force + polemass_length * theta_dot**2 * sintheta) / total_mass
    thetaacc = (GRAVITY * sintheta - costheta * temp) / (
        LENGTH * (4.0 / 3.0 - MASSPOLE * costheta**2 / total_mass))
    xacc = temp - polemass_length * thetaacc * costheta / total_mass
    x = x + TAU * x_dot
    x_dot = x_dot + TAU * xacc
    theta = theta + TAU * theta_dot
    theta_dot = theta_dot + TAU * thetaacc
    nobs = torch.stack([x, x_dot, theta, theta_dot], -1)
    t = t + 1
    terminated = (torch.abs(x) > X_THRESHOLD) | (torch.abs(theta) > THETA_THRESHOLD)
    truncated = t >= MAX_STEPS
    return (nobs, t), torch.ones_like(x), terminated, truncated


def step_autoreset(state: State, action: torch.Tensor, reset_obs: torch.Tensor):
    """Step, then reset in place the envs whose episode ended, to
    ``reset_obs [B, 4]`` (the Anakin rollout never leaves the device to
    reset). Returns (next_state, reward, terminated, truncated), where
    next_state is the reset state on done."""
    (nobs, t), reward, terminated, truncated = step(state, action)
    done = terminated | truncated
    nxt = (torch.where(done[:, None], reset_obs, nobs), torch.where(done, 0, t))
    return nxt, reward, terminated, truncated
