"""Model-based search: native Tree-structured Parzen Estimator (copy of
ray_tpu/tune/tpe.py).

Reference surface: tune/search/searcher.py (Searcher.suggest /
on_trial_complete) and tune/search/optuna/optuna_search.py:87, whose
default sampler is TPE. The reference delegates the model to Optuna;
this is a self-contained implementation of the same algorithm
(Bergstra et al., "Algorithms for Hyper-Parameter Optimization",
NeurIPS 2011): split observed trials into a good quantile and the
rest, fit a Parzen (kernel-density) estimator to each side per
dimension, and suggest the candidate maximizing the density ratio
l(x)/g(x) — sample where good configs cluster, away from bad ones.

No external dependencies; math is plain Python + math.exp.
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.tune.search import (
    Categorical,
    Domain,
    GridSearch,
    LogUniform,
    QUniform,
    Randint,
    Uniform,
)


class Searcher:
    """Sequential config proposer (reference: tune/search/searcher.py).

    ``suggest(trial_id)`` returns the next config to try (None =
    budget exhausted); ``on_trial_complete`` feeds the final metric
    back so the model can learn.
    """

    def set_search_properties(self, metric: Optional[str], mode: str,
                              config: Dict[str, Any]) -> None:
        raise NotImplementedError

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]] = None,
                          error: bool = False) -> None:
        raise NotImplementedError


def _gaussian_kde_logpdf(x: float, points: List[float], widths: List[float],
                         lo: float, hi: float) -> float:
    """Log density of a Parzen mixture of Gaussians truncated to
    [lo, hi] (each point is one kernel; a flat prior kernel over the
    whole range keeps density nonzero everywhere)."""
    comps = []
    # uniform prior component — weight like one extra observation
    comps.append(-math.log(hi - lo))
    for p, w in zip(points, widths):
        z = (x - p) / w
        comps.append(-0.5 * z * z - math.log(w * math.sqrt(2 * math.pi)))
    # log-mean-exp over components
    m = max(comps)
    return m + math.log(sum(math.exp(c - m) for c in comps) / len(comps))


def _kde_widths(points: List[float], lo: float, hi: float) -> List[float]:
    """Per-kernel bandwidths: distance to the nearest neighbor, clamped
    to [span/100, span] (hyperopt's adaptive Parzen widths)."""
    span = hi - lo
    n = len(points)
    if n == 1:
        return [span / 2.0]
    order = sorted(range(n), key=lambda i: points[i])
    widths = [0.0] * n
    for rank, i in enumerate(order):
        left = points[i] - points[order[rank - 1]] if rank > 0 else span
        right = points[order[rank + 1]] - points[i] if rank < n - 1 else span
        widths[i] = min(max(min(left, right), span / 100.0), span)
    return widths


class _NumericDim:
    """One continuous/integer dimension with optional log warp."""

    def __init__(self, lo: float, hi: float, log: bool = False,
                 integer: bool = False, q: Optional[float] = None):
        self.log = log
        self.integer = integer
        self.q = q
        self.orig_lo, self.orig_hi = lo, hi
        self.lo = math.log(lo) if log else lo
        self.hi = math.log(hi) if log else hi

    def warp(self, v: float) -> float:
        return math.log(v) if self.log else float(v)

    def unwarp(self, x: float) -> Any:
        v = math.exp(x) if self.log else x
        # exp(log(hi)) can land an ulp past hi — clamp to the declared
        # bounds, not their warped round-trip
        v = min(max(v, self.orig_lo), self.orig_hi)
        if self.q is not None:
            v = round(v / self.q) * self.q
        if self.integer:
            # Randint semantics: high is exclusive (randrange)
            v = int(min(max(round(v), int(self.orig_lo)),
                        int(self.orig_hi) - 1))
        return v

    def sample_prior(self, rng: random.Random) -> float:
        return rng.uniform(self.lo, self.hi)

    def suggest(self, good: List[float], bad: List[float],
                rng: random.Random, n_candidates: int) -> float:
        """Draw candidates from the good-side KDE, keep the one with the
        best l(x)/g(x) ratio (TPE's EI-proportional acquisition)."""
        gw = _kde_widths(good, self.lo, self.hi)
        bw = _kde_widths(bad, self.lo, self.hi) if bad else []
        best_x, best_score = None, -math.inf
        for _ in range(n_candidates):
            # mixture draw: prior kernel or one good-observation kernel
            k = rng.randrange(len(good) + 1)
            if k == 0:
                x = rng.uniform(self.lo, self.hi)
            else:
                x = rng.gauss(good[k - 1], gw[k - 1])
                x = min(max(x, self.lo), self.hi)
            score = (_gaussian_kde_logpdf(x, good, gw, self.lo, self.hi)
                     - _gaussian_kde_logpdf(x, bad, bw, self.lo, self.hi))
            if score > best_score:
                best_x, best_score = x, score
        return best_x


class _CategoricalDim:
    def __init__(self, categories: List[Any]):
        self.categories = categories

    def suggest(self, good: List[int], bad: List[int],
                rng: random.Random, n_candidates: int) -> int:
        n = len(self.categories)

        def _probs(idxs: List[int]) -> List[float]:
            counts = [1.0] * n  # add-one smoothing
            for i in idxs:
                counts[i] += 1.0
            tot = sum(counts)
            return [c / tot for c in counts]

        pg, pb = _probs(good), _probs(bad)
        scores = [pg[i] / pb[i] for i in range(n)]
        # sample proportionally to the ratio (keeps exploration alive)
        tot = sum(scores)
        r = rng.uniform(0, tot)
        acc = 0.0
        for i, s in enumerate(scores):
            acc += s
            if r <= acc:
                return i
        return n - 1


class TpeSearcher(Searcher):
    """Tree-structured Parzen Estimator over a tune param_space.

    Grid axes are not supported (a model-based searcher replaces
    exhaustive grids); constants pass through untouched.
    """

    def __init__(self, metric: Optional[str] = None, mode: str = "min",
                 n_startup_trials: int = 10, gamma: float = 0.25,
                 n_candidates: int = 24, seed: Optional[int] = None,
                 max_trials: Optional[int] = None):
        self._metric = metric
        self._mode = mode
        self._n_startup = n_startup_trials
        self._gamma = gamma
        self._n_candidates = n_candidates
        self._rng = random.Random(seed)
        self._max_trials = max_trials
        self._space: Dict[str, Any] = {}
        self._dims: Dict[str, Any] = {}
        self._suggested: Dict[str, Dict[str, float]] = {}  # tid -> warped
        self._observed: List[Tuple[Dict[str, float], float]] = []
        self._n_suggested = 0

    # -- setup ---------------------------------------------------------
    def set_search_properties(self, metric: Optional[str], mode: str,
                              config: Dict[str, Any]) -> None:
        self._metric = self._metric or metric
        self._mode = mode or self._mode
        self._space = dict(config)
        for k, v in config.items():
            if isinstance(v, GridSearch):
                raise ValueError(
                    "TpeSearcher does not expand grid_search axes — use "
                    "tune.choice for a modeled categorical instead")
            if isinstance(v, Uniform):
                self._dims[k] = _NumericDim(v.low, v.high)
            elif isinstance(v, LogUniform):
                self._dims[k] = _NumericDim(v.low, v.high, log=True)
            elif isinstance(v, Randint):
                self._dims[k] = _NumericDim(v.low, v.high, integer=True)
            elif isinstance(v, QUniform):
                self._dims[k] = _NumericDim(v.low, v.high, q=v.q)
            elif isinstance(v, Categorical):
                self._dims[k] = _CategoricalDim(v.categories)
            # plain constants: passed through in suggest()

    # -- core ----------------------------------------------------------
    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if self._max_trials is not None and \
                self._n_suggested >= self._max_trials:
            return None
        self._n_suggested += 1
        warped: Dict[str, float] = {}
        cfg: Dict[str, Any] = {}
        modeled = len(self._observed) >= self._n_startup
        good, bad = self._split() if modeled else ([], [])
        for k, v in self._space.items():
            dim = self._dims.get(k)
            if dim is None:
                cfg[k] = v.sample(self._rng) if isinstance(v, Domain) else v
                continue
            if isinstance(dim, _CategoricalDim):
                if modeled:
                    idx = dim.suggest([o[0][k] for o in good],
                                      [o[0][k] for o in bad],
                                      self._rng, self._n_candidates)
                else:
                    idx = self._rng.randrange(len(dim.categories))
                warped[k] = idx
                cfg[k] = dim.categories[int(idx)]
            else:
                if modeled:
                    x = dim.suggest([o[0][k] for o in good],
                                    [o[0][k] for o in bad],
                                    self._rng, self._n_candidates)
                else:
                    x = dim.sample_prior(self._rng)
                warped[k] = x
                cfg[k] = dim.unwarp(x)
        self._suggested[trial_id] = warped
        return cfg

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]] = None,
                          error: bool = False) -> None:
        warped = self._suggested.pop(trial_id, None)
        if warped is None or error or not result:
            return
        value = result.get(self._metric)
        if value is None:
            return
        loss = float(value) if self._mode == "min" else -float(value)
        self._observed.append((warped, loss))

    def _split(self):
        """Top-gamma observations are 'good', the rest 'bad' (TPE's
        l/g split); at least one on each side."""
        srt = sorted(self._observed, key=lambda o: o[1])
        n_good = max(1, min(len(srt) - 1,
                            int(math.ceil(self._gamma * len(srt)))))
        return srt[:n_good], srt[n_good:]
