"""Search spaces + basic variant generation (copy of ray_tpu/tune/search.py).

Reference: python/ray/tune/search/ — BasicVariantGenerator (grid +
random sampling), sample domains (tune/search/sample.py). Advanced
searchers (Optuna/HyperOpt/...) plug in behind the same Searcher
interface; the built-ins here cover grid/random/hyperband workflows.
"""

from __future__ import annotations

import itertools
import random
from typing import Any, Dict, Iterator, List, Optional


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Categorical(Domain):
    def __init__(self, categories):
        self.categories = list(categories)

    def sample(self, rng):
        return rng.choice(self.categories)


class Uniform(Domain):
    def __init__(self, low, high):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.uniform(self.low, self.high)


class LogUniform(Domain):
    def __init__(self, low, high):
        import math

        self.low, self.high = low, high  # original bounds
        self.lo, self.hi = math.log(low), math.log(high)

    def sample(self, rng):
        import math

        return math.exp(rng.uniform(self.lo, self.hi))


class Randint(Domain):
    def __init__(self, low, high):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.randrange(self.low, self.high)


class QUniform(Domain):
    def __init__(self, low, high, q):
        self.low, self.high, self.q = low, high, q

    def sample(self, rng):
        v = rng.uniform(self.low, self.high)
        return round(v / self.q) * self.q


class GridSearch:
    def __init__(self, values):
        self.values = list(values)


# public constructors (reference: ray.tune.{choice,uniform,...})
def choice(categories) -> Categorical:
    return Categorical(categories)


def uniform(low, high) -> Uniform:
    return Uniform(low, high)


def loguniform(low, high) -> LogUniform:
    return LogUniform(low, high)


def randint(low, high) -> Randint:
    return Randint(low, high)


def quniform(low, high, q) -> QUniform:
    return QUniform(low, high, q)


def grid_search(values) -> GridSearch:
    return GridSearch(values)


def generate_variants(
    param_space: Dict[str, Any], num_samples: int, seed: Optional[int] = None
) -> List[Dict[str, Any]]:
    """Expand grid axes (cross product), sample stochastic domains
    num_samples times (reference: BasicVariantGenerator semantics —
    num_samples multiplies the grid)."""
    rng = random.Random(seed)
    grid_keys = [k for k, v in param_space.items() if isinstance(v, GridSearch)]
    grid_values = [param_space[k].values for k in grid_keys]
    grids = list(itertools.product(*grid_values)) if grid_keys else [()]

    variants: List[Dict[str, Any]] = []
    for _ in range(num_samples):
        for combo in grids:
            cfg: Dict[str, Any] = {}
            for k, v in param_space.items():
                if isinstance(v, GridSearch):
                    cfg[k] = combo[grid_keys.index(k)]
                elif isinstance(v, Domain):
                    cfg[k] = v.sample(rng)
                else:
                    cfg[k] = v
            variants.append(cfg)
    return variants
