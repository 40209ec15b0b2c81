"""Podracer RL architectures (PyTorch port of ray_tpu/rllib/podracer;
reference: arXiv 2104.06272).

- ``Anakin`` — colocated: env stepping + V-trace update on the card,
  the envs split over a process group's ranks (podracer/anakin.py), on
  the batched torch CartPole (podracer/torch_env.py).
- ``Sebulba`` — split fleets of actors streaming into learners: waits
  for the actor runtime (ROADMAP.md Queue A item 8c); its names raise,
  and its fragment codec is not ported.
"""

from ray_tpu_torch.rllib.podracer.anakin import Anakin, AnakinConfig, fragment_loss
from ray_tpu_torch.rllib.podracer.obs import StageTimes
from ray_tpu_torch.rllib.podracer.sebulba import (
    FleetManager,
    PodActor,
    PodLearner,
    Sebulba,
    SebulbaConfig,
)

__all__ = [
    "Anakin",
    "AnakinConfig",
    "FleetManager",
    "PodActor",
    "PodLearner",
    "Sebulba",
    "SebulbaConfig",
    "StageTimes",
    "fragment_loss",
]
