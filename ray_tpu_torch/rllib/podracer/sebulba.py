"""Sebulba (PyTorch port of ray_tpu/rllib/podracer/sebulba.py): not
ported. Its pod actors stream fragments through shared-memory tensor
channels (the JAX package's ``experimental/channel.py``
``TensorChannel``, not ported yet) into learner actors; every name here
raises when used, naming ROADMAP.md Queue A item 8c, 'Sebulba'.
"""

from __future__ import annotations

from ray_tpu_torch.rllib.algorithm import waits_for_runtime

SebulbaConfig = waits_for_runtime("SebulbaConfig", "Sebulba (split actor and learner fleets)")
Sebulba = waits_for_runtime("Sebulba", "Sebulba (split actor and learner fleets)")
PodActor = waits_for_runtime("PodActor", "Sebulba's pod actor")
PodLearner = waits_for_runtime("PodLearner", "Sebulba's learner actor")
FleetManager = waits_for_runtime("FleetManager", "Sebulba's elastic actor fleet")
