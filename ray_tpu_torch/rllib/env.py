"""Environment API (gymnasium-compatible subset) + built-in envs: a copy
of ray_tpu/rllib/env.py, which is numpy and imports nothing of JAX.

The framework ships a gymnasium-compatible interface and a numpy
CartPole (the reference's canonical smoke-test env); external gymnasium
envs plug in unchanged (same reset/step signature). The batched torch
CartPole that Anakin steps on the card is ``podracer/torch_env.py``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np


class Env:
    """gymnasium-style: reset() -> (obs, info); step(a) ->
    (obs, reward, terminated, truncated, info)."""

    observation_dim: int
    num_actions: int

    def reset(self, seed: Optional[int] = None):
        raise NotImplementedError

    def step(self, action: int):
        raise NotImplementedError


class CartPole(Env):
    """Classic control, numpy port of the standard dynamics (public
    Barto-Sutton-Anderson equations; matches gymnasium CartPole-v1
    termination: |x|>2.4, |theta|>12deg, 500-step truncation)."""

    observation_dim = 4
    num_actions = 2

    def __init__(self):
        self.gravity = 9.8
        self.masscart = 1.0
        self.masspole = 0.1
        self.length = 0.5
        self.force_mag = 10.0
        self.tau = 0.02
        self.x_threshold = 2.4
        self.theta_threshold = 12 * 2 * np.pi / 360
        self.max_steps = 500
        # deterministic default: an unseeded RandomState made runs that
        # never pass an explicit seed to reset() unreproducible
        self._rng = np.random.RandomState(0)
        self.state = None
        self.t = 0

    def reset(self, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.RandomState(seed)
        self.state = self._rng.uniform(-0.05, 0.05, size=4).astype(np.float32)
        self.t = 0
        return self.state.copy(), {}

    def step(self, action: int):
        x, x_dot, theta, theta_dot = self.state
        force = self.force_mag if action == 1 else -self.force_mag
        costheta, sintheta = np.cos(theta), np.sin(theta)
        total_mass = self.masscart + self.masspole
        polemass_length = self.masspole * self.length
        temp = (force + polemass_length * theta_dot**2 * sintheta) / total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * costheta**2 / total_mass)
        )
        xacc = temp - polemass_length * thetaacc * costheta / total_mass
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        self.state = np.array([x, x_dot, theta, theta_dot], dtype=np.float32)
        self.t += 1
        terminated = bool(
            abs(x) > self.x_threshold or abs(theta) > self.theta_threshold
        )
        truncated = self.t >= self.max_steps
        return self.state.copy(), 1.0, terminated, truncated, {}


_ENV_REGISTRY: Dict[str, Callable[[], Env]] = {"CartPole-v1": CartPole}


def register_env(name: str, creator: Callable[[], Env]) -> None:
    """Reference: ray.tune.register_env."""
    _ENV_REGISTRY[name] = creator


def make_env(spec) -> Env:
    if callable(spec):
        return spec()
    if isinstance(spec, str):
        if spec in _ENV_REGISTRY:
            return _ENV_REGISTRY[spec]()
        try:  # external gymnasium, if present
            import gymnasium

            env = gymnasium.make(spec)

            class _Wrap(Env):
                observation_dim = int(np.prod(env.observation_space.shape))
                num_actions = int(env.action_space.n)

                def reset(self, seed=None):
                    return env.reset(seed=seed)

                def step(self, a):
                    return env.step(int(a))

            return _Wrap()
        except ImportError:
            raise ValueError(f"Unknown env {spec!r} (no gymnasium installed)")
    raise TypeError(spec)
