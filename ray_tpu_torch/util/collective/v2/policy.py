"""Adaptive algorithm + chunk selection for the v2 collective stack (copy of
ray_tpu/util/collective/v2/policy.py).

The 100k+-GPU collectives lesson (arXiv 2510.20171): no single
algorithm wins across message sizes and scales — the winning design is
a *selector* over hierarchical compositions, adaptive to (message size,
rank count, topology), with an operator override.

Selection table (mirrored in the README):

    world == 1                          -> object   (degenerate)
    channels disabled by any rank       -> object
    non-numeric dtype                   -> object
    multi-host, non-uniform hosts       -> object   (flat rendezvous)
    multi-host, uniform, >= hier_min    -> hier
    multi-host, uniform, <  hier_min    -> object   (one exchange beats
                                                     three phases)
    single-host, world == 2, <= channel_max -> channel   (v1 plane)
    single-host, world == 2             -> pipe          (v1 ring)
    single-host, world > 2, <= small_max -> channel  (all-to-all seqlock,
                                                      latency regime)
    single-host, world > 2              -> hier      (shm arena)

Op-specific rows: reducescatter/broadcast have no channel/pipe
implementation — they ride the arena on one host, the full hierarchy
across uniform hosts at >= hier_min, and otherwise (incl. algo=flat)
the object path (their v1 semantics); multi-host allgather is always
the object path (hierarchy can't reduce its wire bytes).

``RAY_TPU_COLLECTIVE_ALGO=flat|hier`` overrides "auto" (flat = the v1
planes everywhere; hier = hierarchical wherever it is well-defined,
including world == 2). Quantization (``RAY_TPU_COLLECTIVE_QUANT=int8``)
rides the hier path only, for SUM/MEAN over float tensors at
>= quant_min bytes — smaller messages keep the exact sum (the latency
regime gains nothing from 4x fewer bytes, and small-message accuracy
is disproportionately visible).

Every knob is agreed ACROSS the group at first use (same contract as
the v1 channel policy): per-rank env divergence degrades throughput,
never splits the per-op routing decision.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np

from ray_tpu_torch.util.collective.types import ReduceOp
from ray_tpu_torch.util.collective.v2 import quant as quant_mod
from ray_tpu_torch.util.collective.v2.topology import Topology


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, str(default)))
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, str(default)))
    except ValueError:
        return default


@dataclasses.dataclass(frozen=True)
class GroupPolicy:
    """The group-agreed knob set (one instance per ObjStoreGroup)."""

    channels_enabled: bool
    channel_max_bytes: int
    pipe_chunk_bytes: int
    algo: str               # "auto" | "flat" | "hier"
    quant_mode: str         # "off" | "int8"
    quant_min_bytes: int
    quant_block: int
    small_max_bytes: int
    hier_min_bytes: int
    # fault model + overlap knobs. Defaults keep old
    # positionally-constructed policies valid.
    op_timeout_s: float = 120.0     # group deadline for any op leg
    wan_gbps: float = 0.0           # >0: simulated cross-host bandwidth cap
    overlap: bool = True            # chunked async xh overlap
    overlap_block_bytes: int = 256 << 10
    overlap_min_bytes: int = 256 << 10


def local_knobs() -> Tuple:
    """This rank's env-derived knob tuple (exchanged group-wide; the
    order is part of the rendezvous wire contract — append only)."""
    enabled = os.environ.get("RAY_TPU_COLLECTIVE_CHANNELS", "1") != "0"
    algo = os.environ.get("RAY_TPU_COLLECTIVE_ALGO", "auto")
    if algo not in ("auto", "flat", "hier"):
        algo = "auto"
    qmode = os.environ.get("RAY_TPU_COLLECTIVE_QUANT", "off")
    if qmode not in ("off", "int8"):
        qmode = "off"
    return (
        enabled,
        _env_int("RAY_TPU_COLLECTIVE_CHANNEL_MAX_BYTES", 2 << 20),
        max(4096, _env_int("RAY_TPU_COLLECTIVE_PIPE_CHUNK_BYTES", 1 << 20)),
        algo,
        qmode,
        _env_int("RAY_TPU_COLLECTIVE_QUANT_MIN_BYTES", 1 << 20),
        max(16, _env_int("RAY_TPU_COLLECTIVE_QUANT_BLOCK",
                         quant_mod.DEFAULT_BLOCK)),
        _env_int("RAY_TPU_COLLECTIVE_SMALL_MAX_BYTES", 64 << 10),
        _env_int("RAY_TPU_COLLECTIVE_HIER_MIN_BYTES", 256 << 10),
        max(0.1, _env_float("RAY_TPU_COLLECTIVE_OP_TIMEOUT_S", 120.0)),
        max(0.0, _env_float("RAY_TPU_COLLECTIVE_WAN_GBPS", 0.0)),
        os.environ.get("RAY_TPU_COLLECTIVE_OVERLAP", "1") != "0",
        max(4096, _env_int("RAY_TPU_COLLECTIVE_OVERLAP_BLOCK_BYTES",
                           256 << 10)),
        _env_int("RAY_TPU_COLLECTIVE_OVERLAP_MIN_BYTES", 256 << 10),
    )


def merge_knobs(infos) -> GroupPolicy:
    """Combine every rank's knob tuple into one agreed policy. All
    reductions are deterministic and direction-conservative: features
    activate only when every rank enables them; thresholds take the
    value that routes FEWER ops onto the newer plane."""
    infos = [tuple(i) for i in infos]
    algos = [i[3] for i in infos]
    if any(a == "flat" for a in algos):
        algo = "flat"
    elif any(a == "hier" for a in algos):
        algo = "hier"
    else:
        algo = "auto"
    return GroupPolicy(
        channels_enabled=all(i[0] for i in infos),
        channel_max_bytes=min(i[1] for i in infos),
        pipe_chunk_bytes=min(i[2] for i in infos),
        algo=algo,
        quant_mode="int8" if all(i[4] == "int8" for i in infos) else "off",
        quant_min_bytes=max(i[5] for i in infos),
        quant_block=max(i[6] for i in infos),
        # ops <= small_max ride the OLD channel plane: max() keeps ops
        # off the newer hier plane unless every rank lowers the knob
        small_max_bytes=max(i[7] for i in infos),
        hier_min_bytes=max(i[8] for i in infos),
        # a rank wanting to fail faster wins (min); WAN sim only runs
        # when every rank simulates it (the slowest simulated link
        # caps the group); overlap needs unanimity, and the largest
        # block/threshold chunks the least (conservative direction)
        op_timeout_s=min(i[9] for i in infos),
        wan_gbps=min(i[10] for i in infos)
        if all(i[10] > 0 for i in infos) else 0.0,
        overlap=all(i[11] for i in infos),
        overlap_block_bytes=max(i[12] for i in infos),
        overlap_min_bytes=max(i[13] for i in infos),
    )


def select_algorithm(nbytes: int, dtype, topo: Topology,
                     policy: GroupPolicy,
                     op: str = "allreduce") -> str:
    """The table above — the SINGLE source of routing truth. Pure
    function of group-agreed inputs, so every rank lands on the same
    plane for the same op. ``op`` matters because not every op exists
    on every plane: reducescatter and broadcast have no channel/pipe
    implementation (their v1 semantics are the object path; the arena
    serves them on one host, the full hierarchy across uniform hosts),
    and cross-host allgather gains nothing from hierarchy (every byte
    crosses the wire either way)."""
    world = topo.world_size
    if world <= 1 or not policy.channels_enabled \
            or np.dtype(dtype).kind not in "biufc":
        return "object"
    if op in ("reducescatter", "broadcast"):
        if policy.algo == "flat":
            return "object"  # the documented v1 kill switch
        if topo.single_host:
            return "hier"
        if topo.uniform and (policy.algo == "hier"
                             or nbytes >= policy.hier_min_bytes):
            return "hier"
        return "object"
    if policy.algo == "flat":
        return "channel" if nbytes <= policy.channel_max_bytes else "pipe"
    if not topo.single_host:
        if op == "allgather" or not topo.uniform:
            return "object"
        if policy.algo != "hier" and nbytes < policy.hier_min_bytes:
            return "object"
        return "hier"
    if policy.algo == "hier":
        return "hier"
    if world == 2:
        return "channel" if nbytes <= policy.channel_max_bytes else "pipe"
    return "channel" if nbytes <= policy.small_max_bytes else "hier"


def chunk_bytes_for(nbytes: int, world: int, policy: GroupPolicy) -> int:
    """Adaptive pipeline-chunk size: roughly nbytes/(4*world) so each
    ring stage keeps ~4 chunks in flight, clamped to [64 KiB,
    pipe_chunk] and rounded to a power of two (identical on every rank
    — pure function of meta-agreed inputs)."""
    target = max(1, nbytes // (4 * max(1, world)))
    size = 64 << 10
    while size * 2 <= target and size * 2 <= policy.pipe_chunk_bytes:
        size *= 2
    return min(size, policy.pipe_chunk_bytes)


def quant_codec_for(nbytes: int, dtype, op, topo: Topology,
                    policy: GroupPolicy) -> Optional[quant_mod.Int8BlockCodec]:
    """The int8 codec when this op qualifies for quantization, else
    None (exact). Small messages always take the exact sum."""
    if policy.quant_mode != "int8" or nbytes < policy.quant_min_bytes:
        return None
    if np.dtype(dtype).kind != "f":
        return None
    if ReduceOp(op) not in (ReduceOp.SUM, ReduceOp.MEAN):
        return None
    return quant_mod.Int8BlockCodec(dtype, block=policy.quant_block)
