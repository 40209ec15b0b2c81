"""Collective types (PyTorch port of ray_tpu/util/collective/types.py).

Backends:
- NCCL: collectives over a ``torch.distributed`` NCCL group, tensors on
        the card. The counterpart of the JAX package's XLA backend.
- GLOO: the same group over gloo, tensors on the CPU.
- OBJSTORE: the JAX package's host collectives through the object store;
        the object store is not ported, so choosing it raises.
"""

from __future__ import annotations

import enum


class Backend(str, enum.Enum):
    NCCL = "nccl"
    GLOO = "gloo"
    OBJSTORE = "objstore"

    @classmethod
    def resolve(cls, name) -> "Backend":
        b = cls(name) if not isinstance(name, cls) else name
        if b == cls.OBJSTORE:
            raise NotImplementedError(
                "the OBJSTORE backend needs the object store, which "
                "ray_tpu_torch does not port yet (ROADMAP.md Queue A item 5, "
                "'create_collective_group and OBJSTORE'); use 'nccl' on the "
                "card or 'gloo' on the CPU")
        return b


class ReduceOp(str, enum.Enum):
    SUM = "sum"
    PRODUCT = "product"
    MAX = "max"
    MIN = "min"
    MEAN = "mean"


class CollectiveError(RuntimeError):
    """Base for typed collective failures. Both subclasses are
    retriable signals: the group either resized (retry joins the new
    epoch) or a peer is suspect (retry after the membership authority
    confirms the death and bumps the epoch)."""


class CollectiveTimeoutError(CollectiveError):
    """An op leg exceeded the group-agreed deadline without any peer
    being provably dead. Carries enough structure for callers (and the
    flight recorder) to say *where* the group wedged."""

    def __init__(self, op: str, phase: str, deadline_s: float,
                 suspected_ranks=(), group_name: str = ""):
        self.op = op
        self.phase = phase
        self.deadline_s = float(deadline_s)
        self.suspected_ranks = tuple(suspected_ranks)
        self.group_name = group_name
        sus = (f", suspected ranks {list(self.suspected_ranks)}"
               if self.suspected_ranks else "")
        super().__init__(
            f"collective {op}/{phase} exceeded the group deadline "
            f"({deadline_s:.1f}s) in group '{group_name}'{sus}")

    def __reduce__(self):
        # exceptions cross process boundaries: default BaseException
        # pickling replays __init__ with .args (the formatted message),
        # which does not match this signature
        return (self.__class__, (self.op, self.phase, self.deadline_s,
                                 self.suspected_ranks, self.group_name))


class CollectiveRankFailure(CollectiveError):
    """A peer rank's actor is DEAD (confirmed against GCS actor state).
    Raised within the detection window instead of letting the op hang
    to the full deadline. ``epoch`` is the membership epoch the failure
    was observed at; retrying after the authority resizes joins the
    survivor epoch."""

    def __init__(self, dead_ranks, epoch: int = 0, group_name: str = "",
                 op: str = "", phase: str = ""):
        self.dead_ranks = tuple(dead_ranks)
        self.epoch = int(epoch)
        self.group_name = group_name
        self.op = op
        self.phase = phase
        where = f" during {op}/{phase}" if op else ""
        super().__init__(
            f"collective rank(s) {list(self.dead_ranks)} dead at epoch "
            f"{epoch} in group '{group_name}'{where}")

    def __reduce__(self):
        return (self.__class__, (self.dead_ranks, self.epoch,
                                 self.group_name, self.op, self.phase))
