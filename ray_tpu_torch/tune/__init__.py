"""ray_tpu_torch.tune — hyperparameter tuning (PyTorch port of
ray_tpu.tune; reference: python/ray/tune).

Tuner runs trials as actors of the local-mode runtime (a trial asks for
cards as ``resources_per_trial={"GPU": n}``); searchers expand
grid/random spaces or suggest them (TPE); ASHA, HyperBand, PBT and
median-stopping schedulers stop or restart weak trials.
"""

from ray_tpu_torch.tune.schedulers import (
    ASHAScheduler,
    FIFOScheduler,
    HyperBandScheduler,
    MedianStoppingRule,
    PopulationBasedTraining,
)
from ray_tpu_torch.tune.search import (
    choice,
    grid_search,
    loguniform,
    quniform,
    randint,
    uniform,
)
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.session import get_checkpoint
from ray_tpu_torch.tune.tpe import Searcher, TpeSearcher
from ray_tpu_torch.tune.tuner import ResultGrid, TrialResult, TuneConfig, Tuner, report

__all__ = [
    "Searcher",
    "TpeSearcher",
    "ASHAScheduler",
    "FIFOScheduler",
    "HyperBandScheduler",
    "MedianStoppingRule",
    "PopulationBasedTraining",
    "Checkpoint",
    "get_checkpoint",
    "ResultGrid",
    "TrialResult",
    "TuneConfig",
    "Tuner",
    "choice",
    "grid_search",
    "loguniform",
    "quniform",
    "randint",
    "report",
    "uniform",
]
