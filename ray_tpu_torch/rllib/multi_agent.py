"""Multi-agent RL (PyTorch port of ray_tpu/rllib/multi_agent.py): not
ported. Its env runners are actors and its policies PPO learners fed by
them; all of it waits for the actor runtime (ROADMAP.md Queue A item
8c), and every name here raises when used.
"""

from __future__ import annotations

from ray_tpu_torch.rllib.algorithm import waits_for_runtime

MultiAgentEnv = waits_for_runtime("MultiAgentEnv", "the multi-agent env API")
CoordinationGame = waits_for_runtime("CoordinationGame", "the 2-agent coordination game")
MultiAgentPPOConfig = waits_for_runtime("MultiAgentPPOConfig", "multi-agent PPO")
MultiAgentPPO = waits_for_runtime("MultiAgentPPO", "multi-agent PPO")
