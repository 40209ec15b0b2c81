"""Trial schedulers (copy of ray_tpu/tune/schedulers.py; reference:
python/ray/tune/schedulers/).

FIFO runs everything to completion; ASHA (async successive halving,
reference async_hyperband.py) stops under-performing trials at rung
boundaries so the budget concentrates on the best configs — the key
scheduler for expensive TPU trials.
"""

from __future__ import annotations

import math
import random
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Tuple

CONTINUE = "CONTINUE"
STOP = "STOP"
# PBT: stop the trial and restart it from a better trial's checkpoint
# with a perturbed config (reference: tune/schedulers/pbt.py).
EXPLOIT = "EXPLOIT"


class FIFOScheduler:
    def on_result(self, trial_id: str, result: Dict) -> str:
        return CONTINUE


class ASHAScheduler:
    """Async Successive Halving (reference:
    tune/schedulers/async_hyperband.py AsyncHyperBandScheduler)."""

    def __init__(
        self,
        metric: str = "loss",
        mode: str = "min",
        time_attr: str = "training_iteration",
        max_t: int = 100,
        grace_period: int = 1,
        reduction_factor: int = 4,
    ):
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.max_t = max_t
        self.grace = grace_period
        self.rf = reduction_factor
        # rung milestones: grace, grace*rf, grace*rf^2, ... < max_t
        self.rungs: List[int] = []
        t = grace_period
        while t < max_t:
            self.rungs.append(t)
            t *= reduction_factor
        # recorded metric per rung
        self._rung_scores: Dict[int, List[float]] = defaultdict(list)

    def _better(self, a: float, b: float) -> bool:
        return a < b if self.mode == "min" else a > b

    def on_result(self, trial_id: str, result: Dict) -> str:
        t = result.get(self.time_attr)
        score = result.get(self.metric)
        if t is None or score is None:
            return CONTINUE
        if t >= self.max_t:
            return STOP  # budget exhausted (trial done)
        for rung in self.rungs:
            if t == rung:
                scores = self._rung_scores[rung]
                scores.append(float(score))
                if len(scores) < self.rf:
                    return CONTINUE  # async: early trials pass through
                k = max(1, len(scores) // self.rf)
                top = sorted(scores, reverse=(self.mode == "max"))[:k]
                keep = top[-1]
                if not self._better(float(score), keep) and float(score) != keep:
                    return STOP
        return CONTINUE


class HyperBandScheduler:
    """Synchronous HyperBand approximated as bracketed successive halving
    (reference: tune/schedulers/hyperband.py HyperBandScheduler).

    Trials are assigned round-robin to brackets; bracket ``s`` gives its
    trials a grace period of ``max_t / rf^s`` before the first halving —
    so one bracket explores aggressively (short grace) while another is
    conservative (long grace), hedging ASHA's grace-period choice."""

    def __init__(
        self,
        metric: str = "loss",
        mode: str = "min",
        time_attr: str = "training_iteration",
        max_t: int = 81,
        reduction_factor: int = 3,
    ):
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.max_t = max_t
        self.rf = reduction_factor
        # integer bracket count (math.log floats drop a bracket at exact
        # powers, e.g. log(243, 3) == 4.999...)
        s_max, t = 0, max_t
        while t >= reduction_factor:
            t //= reduction_factor
            s_max += 1
        s_max = max(1, s_max)
        self._brackets = [
            ASHAScheduler(
                metric=metric, mode=mode, time_attr=time_attr, max_t=max_t,
                grace_period=max(1, max_t // (reduction_factor ** s)),
                reduction_factor=reduction_factor,
            )
            for s in range(s_max + 1)
        ]
        self._assignment: Dict[str, int] = {}
        self._next_bracket = 0

    def register(self, trial_id: str, config: Optional[Dict] = None) -> None:
        if trial_id not in self._assignment:
            self._assignment[trial_id] = self._next_bracket
            self._next_bracket = (self._next_bracket + 1) % len(self._brackets)

    def on_result(self, trial_id: str, result: Dict) -> str:
        self.register(trial_id)
        return self._brackets[self._assignment[trial_id]].on_result(trial_id, result)


class PopulationBasedTraining:
    """PBT (reference: tune/schedulers/pbt.py PopulationBasedTraining).

    Every ``perturbation_interval`` steps, a trial in the bottom quantile
    of the population EXPLOITs: the controller restarts it from a top-
    quantile trial's latest checkpoint with that trial's config perturbed
    (``hyperparam_mutations``). The trial function must tolerate restart:
    read ``tune.get_checkpoint()`` and resume.

    Decision protocol with the controller: ``on_result`` returns EXPLOIT;
    the controller then calls ``exploit_info(trial_id)`` for the donor
    trial id and the mutated config.
    """

    def __init__(
        self,
        metric: str = "loss",
        mode: str = "min",
        time_attr: str = "training_iteration",
        perturbation_interval: int = 1,
        hyperparam_mutations: Optional[Dict[str, Any]] = None,
        quantile_fraction: float = 0.25,
        resample_probability: float = 0.25,
        perturbation_factors: Tuple[float, float] = (1.2, 0.8),
        seed: Optional[int] = None,
    ):
        if not hyperparam_mutations:
            raise ValueError("hyperparam_mutations is required for PBT")
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations
        self.quantile = min(quantile_fraction, 0.5)
        self.resample_prob = resample_probability
        self.factors = perturbation_factors
        self._rng = random.Random(seed)
        self._scores: Dict[str, float] = {}
        self._configs: Dict[str, Dict] = {}
        self._last_perturb: Dict[str, float] = {}
        self._pending_exploit: Dict[str, Tuple[str, Dict]] = {}
        self.num_perturbations = 0

    def register(self, trial_id: str, config: Optional[Dict] = None) -> None:
        if config is not None:
            self._configs[trial_id] = dict(config)

    def _quantiles(self) -> Tuple[List[str], List[str]]:
        trials = [t for t in self._scores]
        if len(trials) < 2:
            return [], []
        trials.sort(key=lambda t: self._scores[t],
                    reverse=(self.mode == "max"))  # best first
        k = max(1, int(len(trials) * self.quantile))
        if len(trials) <= k:
            return [], []
        return trials[:k], trials[-k:]

    def _mutate(self, config: Dict) -> Dict:
        from ray_tpu_torch.tune.search import Domain

        out = dict(config)
        for key, spec in self.mutations.items():
            resample = self._rng.random() < self.resample_prob or key not in out
            if resample:
                if isinstance(spec, Domain):
                    out[key] = spec.sample(self._rng)
                elif callable(spec):
                    out[key] = spec()
                elif isinstance(spec, (list, tuple)):
                    out[key] = self._rng.choice(list(spec))
                continue
            if isinstance(spec, Domain):
                # continuous perturbation around the current value
                cur = out[key]
                if isinstance(cur, (int, float)):
                    factor = self._rng.choice(self.factors)
                    out[key] = type(cur)(cur * factor) if isinstance(cur, float) \
                        else max(1, int(cur * factor))
                else:
                    out[key] = spec.sample(self._rng)
                continue
            cur = out[key]
            if isinstance(spec, (list, tuple)) and cur in spec:
                # shift to a neighboring categorical value
                i = list(spec).index(cur)
                j = max(0, min(len(spec) - 1, i + self._rng.choice((-1, 1))))
                out[key] = list(spec)[j]
            elif isinstance(cur, (int, float)):
                factor = self._rng.choice(self.factors)
                out[key] = type(cur)(cur * factor) if isinstance(cur, float) \
                    else max(1, int(cur * factor))
        return out

    def on_result(self, trial_id: str, result: Dict) -> str:
        t = result.get(self.time_attr)
        score = result.get(self.metric)
        if t is None or score is None:
            return CONTINUE
        self._scores[trial_id] = float(score)
        if t - self._last_perturb.get(trial_id, 0) < self.interval:
            return CONTINUE
        top, bottom = self._quantiles()
        if not top:
            # population too small to rank yet — retry on the next report
            # rather than burning this interval boundary
            return CONTINUE
        self._last_perturb[trial_id] = t
        if trial_id in bottom and trial_id not in top:
            donor = self._rng.choice(top)
            donor_cfg = self._configs.get(donor, {})
            new_cfg = self._mutate(donor_cfg)
            self._configs[trial_id] = dict(new_cfg)
            self._pending_exploit[trial_id] = (donor, new_cfg)
            self.num_perturbations += 1
            return EXPLOIT
        return CONTINUE

    def exploit_info(self, trial_id: str) -> Tuple[str, Dict]:
        return self._pending_exploit.pop(trial_id)


class MedianStoppingRule:
    """Stop trials below the median of completed averages
    (reference: tune/schedulers/median_stopping_rule.py)."""

    def __init__(self, metric: str = "loss", mode: str = "min",
                 time_attr: str = "training_iteration", grace_period: int = 1):
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.grace = grace_period
        self._history: Dict[str, List[float]] = defaultdict(list)

    def on_result(self, trial_id: str, result: Dict) -> str:
        t = result.get(self.time_attr, 0)
        score = result.get(self.metric)
        if score is None:
            return CONTINUE
        self._history[trial_id].append(float(score))
        if t < self.grace or len(self._history) < 3:
            return CONTINUE
        means = [sum(v) / len(v) for k, v in self._history.items() if k != trial_id]
        if not means:
            return CONTINUE
        med = sorted(means)[len(means) // 2]
        mine = sum(self._history[trial_id]) / len(self._history[trial_id])
        if self.mode == "min" and mine > med:
            return STOP
        if self.mode == "max" and mine < med:
            return STOP
        return CONTINUE
