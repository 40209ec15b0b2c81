"""Shared algorithm-config surface (copy of ray_tpu/rllib/algorithm.py;
reference: rllib/algorithms/algorithm_config.py `AlgorithmConfig`).

The config methods (environment / env_runners / training / build) are
the same for every algorithm; each config dataclass inherits them and
sets ``algo_cls`` after its algorithm class is defined. ``build`` passes
keyword arguments on to the algorithm (the port's ``device=``).

``waits_for_runtime`` makes the stand-in for a name of Sebulba (its
actor and learner fleets over the shared-memory tensor channel,
``experimental/channel.py``'s ``TensorChannel``), which is not ported
yet: using it raises, naming ROADMAP.md's row.
"""

from __future__ import annotations

from typing import Any, Optional

ITEM_8C = "ROADMAP.md Queue A item 8c, 'Sebulba'"


class AlgorithmConfigBase:
    algo_cls: Any = None  # set by each algorithm module

    def environment(self, env):
        self.env = env
        return self

    def env_runners(self, num_env_runners: int,
                    rollout_fragment_length: Optional[int] = None):
        self.num_env_runners = num_env_runners
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, **kw):
        for k, v in kw.items():
            # "lambda" is a Python keyword; configs store it as lambda_
            setattr(self, "lambda_" if k == "lambda" else k, v)
        return self

    def build(self, **kw):
        return self.algo_cls(self, **kw)


def waits_for_runtime(name: str, what: str) -> type:
    """A class named ``name`` whose construction raises
    NotImplementedError: ``what`` is not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"{name}: {what} is not ported to ray_tpu_torch yet ({ITEM_8C})")

    return type(name, (), {"__init__": __init__, "__doc__": f"Not ported: {what}."})
