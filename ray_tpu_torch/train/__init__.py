"""ray_tpu_torch.train — training on the card (PyTorch port of
ray_tpu.train).

The public surface mirrors the JAX package's Train v2: TorchTrainer (its
JaxTrainer), ScalingConfig/RunConfig/FailureConfig/CheckpointConfig,
report/get_context/get_checkpoint, Checkpoint and CheckpointManager,
save_state/restore_state over torch.distributed.checkpoint; and the
train step on one device or over a mesh of any of its seven axes, the
pipeline's ``stage`` among them (``train.step``)."""

from ray_tpu_torch.train.checkpoint import (
    Checkpoint,
    CheckpointManager,
    restore_state,
    save_state,
)
from ray_tpu_torch.train.config import (
    CheckpointConfig,
    FailureConfig,
    Result,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.session import get_checkpoint, get_context, report
from ray_tpu_torch.train.step import (
    AdamW,
    batch_sharding,
    default_optimizer,
    init_state,
    make_attn_fn,
    make_eval_step,
    make_train_step,
    state_shardings,
    value_and_grad,
)
from ray_tpu_torch.train.torch_trainer import TorchTrainer

__all__ = [
    "AdamW",
    "Checkpoint",
    "CheckpointManager",
    "CheckpointConfig",
    "FailureConfig",
    "Result",
    "RunConfig",
    "ScalingConfig",
    "TorchTrainer",
    "batch_sharding",
    "default_optimizer",
    "get_checkpoint",
    "get_context",
    "init_state",
    "make_attn_fn",
    "make_eval_step",
    "make_train_step",
    "report",
    "restore_state",
    "save_state",
    "state_shardings",
    "value_and_grad",
]
