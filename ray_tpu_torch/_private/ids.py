"""Binary IDs of the runtime (copy of ray_tpu/_private/ids.py).

Mirrors the reference's ID layout (reference: src/ray/common/id.h,
src/ray/common/id_def.h) so that deterministic object IDs can be derived
from (task id, return index) — required for lineage reconstruction:

- ``JobID``:    4 bytes.
- ``ActorID``:  16 bytes = 12 random + 4 job.
- ``TaskID``:   24 bytes = 8 random + 16 actor (zeros for normal tasks'
  actor part beyond the job suffix).
- ``ObjectID``: 28 bytes = 24 task + 4 little-endian index.
- ``NodeID``/``WorkerID``/``PlacementGroupID``: random fixed-length.
"""

from __future__ import annotations

import os
import struct

from ray_tpu_torch._private import fastpath


class BaseID:
    SIZE = 16
    __slots__ = ("_bytes",)

    def __init__(self, id_bytes: bytes) -> None:
        if len(id_bytes) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} must be {self.SIZE} bytes, got {len(id_bytes)}"
            )
        self._bytes = bytes(id_bytes)

    @classmethod
    def from_random(cls) -> "BaseID":
        return cls(os.urandom(cls.SIZE))

    @classmethod
    def nil(cls) -> "BaseID":
        return cls(b"\xff" * cls.SIZE)

    @classmethod
    def from_hex(cls, h: str) -> "BaseID":
        return cls(bytes.fromhex(h))

    def is_nil(self) -> bool:
        return self._bytes == b"\xff" * self.SIZE

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def __eq__(self, other: object) -> bool:
        return type(other) is type(self) and other._bytes == self._bytes  # type: ignore[attr-defined]

    def __hash__(self) -> int:
        return hash((type(self).__name__, self._bytes))

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self._bytes.hex()})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class UniqueID(BaseID):
    SIZE = 16


class JobID(BaseID):
    SIZE = 4

    @classmethod
    def from_int(cls, v: int) -> "JobID":
        return cls(struct.pack("<I", v))


class NodeID(BaseID):
    SIZE = 16


class WorkerID(BaseID):
    SIZE = 16


class PlacementGroupID(BaseID):
    SIZE = 16


class ActorID(BaseID):
    SIZE = 16
    UNIQUE_BYTES = 12

    @classmethod
    def of(cls, job_id: JobID) -> "ActorID":
        return cls(os.urandom(cls.UNIQUE_BYTES) + job_id.binary())

    def job_id(self) -> JobID:
        return JobID(self._bytes[self.UNIQUE_BYTES :])


class TaskID(BaseID):
    SIZE = 24
    UNIQUE_BYTES = 8

    @classmethod
    def for_normal_task(cls, job_id: JobID) -> "TaskID":
        # actor part = 12 zero bytes + job id, like the reference's
        # TaskID::ForNormalTask (driver/normal tasks carry job in the suffix).
        actor_part = b"\x00" * ActorID.UNIQUE_BYTES + job_id.binary()
        return cls(os.urandom(cls.UNIQUE_BYTES) + actor_part)

    @classmethod
    def for_actor_task(cls, actor_id: ActorID) -> "TaskID":
        return cls(os.urandom(cls.UNIQUE_BYTES) + actor_id.binary())

    @classmethod
    def for_actor_creation(cls, actor_id: ActorID) -> "TaskID":
        # Deterministic: the actor creation task id is the actor id
        # prefixed with zeros (reference: TaskID::ForActorCreationTask).
        return cls(b"\x00" * cls.UNIQUE_BYTES + actor_id.binary())

    def actor_id(self) -> ActorID:
        return ActorID(self._bytes[self.UNIQUE_BYTES :])

    def job_id(self) -> JobID:
        return self.actor_id().job_id()


class ObjectID(BaseID):
    SIZE = 28
    INDEX_BYTES = 4

    @classmethod
    def from_index(cls, task_id: TaskID, index: int) -> "ObjectID":
        """Deterministic return/put object id (reference: ObjectID::FromIndex).
        Derived on every submit/return — runs on the fastpath codec."""
        return cls(fastpath.id_from_index(task_id.binary(), index))

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[: TaskID.SIZE])

    def index(self) -> int:
        return struct.unpack("<I", self._bytes[TaskID.SIZE :])[0]


FunctionID = UniqueID
