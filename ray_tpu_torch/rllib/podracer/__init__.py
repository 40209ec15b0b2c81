"""Podracer RL architectures (PyTorch port of ray_tpu/rllib/podracer;
reference: arXiv 2104.06272).

- ``Anakin`` — colocated: env stepping + V-trace update on the card,
  the envs split over a process group's ranks (podracer/anakin.py), on
  the batched torch CartPole (podracer/torch_env.py).
- ``Sebulba`` — split fleets: SampleRunner-derived pod actors stream
  fixed-shape fragments through double-buffered TensorChannel slots
  into batched learners, each on a card it leases
  (podracer/sebulba.py), with elastic membership under node drains
  (podracer/fleet.py).
"""

from ray_tpu_torch.rllib.podracer.anakin import Anakin, AnakinConfig, fragment_loss
from ray_tpu_torch.rllib.podracer.codec import (
    FragmentSpec,
    flat_param_size,
    pack_params,
    unpack_params,
)
from ray_tpu_torch.rllib.podracer.fleet import FleetManager
from ray_tpu_torch.rllib.podracer.obs import StageTimes
from ray_tpu_torch.rllib.podracer.sebulba import (
    PodActor,
    PodLearner,
    Sebulba,
    SebulbaConfig,
)

__all__ = [
    "Anakin",
    "AnakinConfig",
    "FleetManager",
    "FragmentSpec",
    "PodActor",
    "PodLearner",
    "Sebulba",
    "SebulbaConfig",
    "StageTimes",
    "flat_param_size",
    "fragment_loss",
    "pack_params",
    "unpack_params",
]
