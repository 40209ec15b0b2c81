"""ray_tpu_torch.rllib — reinforcement learning on the card (PyTorch port
of ray_tpu.rllib; reference: rllib/).

The learners of PPO, IMPALA
(V-trace), DQN (double Q), SAC (discrete, tuned α) and BC, each an MLP
update with Adam on the card, fed numpy batches; Anakin
(``podracer``), whose rollout over a batched torch CartPole, V-trace loss
and Adam step all run on the card, its envs split over a process group's
ranks. The gymnasium-style env API, the numpy CartPole, GAE, the replay
buffer and the offline JSON reader and writer are numpy copies.

The algorithms ``PPO``, ``IMPALA``, ``DQN``, ``SAC`` and
``MultiAgentPPO`` (``XConfig.build()``) drive their env-runner actors
(``SampleRunner``, PPO's ``EnvRunner``, ``MultiAgentEnvRunner``: numpy
inference, no card) on the actor runtime and feed their learners.
``Sebulba`` (``podracer``) streams its pod actors' fragments through
shared-memory tensor channels into learners that each lease a card, and
syncs several learners over the OBJSTORE collective backend. Every entry
point takes ``device``: None means the card.
"""

from ray_tpu_torch.rllib.dqn import DQN, DQNConfig
from ray_tpu_torch.rllib.env import CartPole, Env, make_env, register_env
from ray_tpu_torch.rllib.impala import IMPALA, IMPALAConfig, vtrace_np
from ray_tpu_torch.rllib.multi_agent import (
    CoordinationGame,
    MultiAgentEnv,
    MultiAgentPPO,
    MultiAgentPPOConfig,
)
from ray_tpu_torch.rllib.offline import (
    BC,
    BCConfig,
    JsonReader,
    JsonWriter,
    collect_offline_data,
)
from ray_tpu_torch.rllib.podracer import Anakin, AnakinConfig, Sebulba, SebulbaConfig
from ray_tpu_torch.rllib.ppo import PPO, PPOConfig, PPOLearner, compute_gae
from ray_tpu_torch.rllib.rollout import ReplayBuffer, SampleRunner, worker_seed
from ray_tpu_torch.rllib.sac import SAC, SACConfig

__all__ = [
    "Anakin",
    "AnakinConfig",
    "BC",
    "BCConfig",
    "CoordinationGame",
    "JsonReader",
    "JsonWriter",
    "MultiAgentEnv",
    "MultiAgentPPO",
    "MultiAgentPPOConfig",
    "collect_offline_data",
    "CartPole",
    "DQN",
    "DQNConfig",
    "Env",
    "IMPALA",
    "IMPALAConfig",
    "PPO",
    "PPOConfig",
    "PPOLearner",
    "ReplayBuffer",
    "SAC",
    "SACConfig",
    "SampleRunner",
    "Sebulba",
    "SebulbaConfig",
    "compute_gae",
    "make_env",
    "register_env",
    "vtrace_np",
    "worker_seed",
]
