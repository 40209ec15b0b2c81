"""Multi-host bootstrap (PyTorch port of ray_tpu/parallel/bootstrap.py).

Every host process calls ``initialize_host(spec)``: process 0's address
is the TCP rendezvous of ``torch.distributed.init_process_group``, which
brings up the default process group the mesh (``build_mesh``) and the
collective API (``ray_tpu_torch.util.collective``) run on. A single
process skips it: a world of one needs no rendezvous.

Multi-slice (the JAX package's MEGASCALE DCN transport) has no port yet:
``megascale_env`` raises for more than one slice.
"""

from __future__ import annotations

import dataclasses
import socket
from typing import Dict, List, Optional

import torch.distributed as dist

from ray_tpu_torch import default_device

_DIST_INITIALIZED = False


@dataclasses.dataclass
class HostGroupSpec:
    """One entry per participating host process."""

    coordinator_address: str  # "host:port" of process 0
    num_processes: int
    process_id: int
    # Multi-slice (MEGASCALE / DCN) fields:
    num_slices: int = 1
    slice_id: int = 0
    megascale_coordinator: Optional[str] = None  # slice-0 host addr
    # Bumped when a slice is replaced after preemption so the transport
    # re-keys instead of waiting on dead peers.
    replacement_epoch: int = 0


def check_slices(num_slices: int) -> None:
    """More than one slice raises: multi-slice DCN is not ported
    (ROADMAP.md Queue A item 7, 'multi-slice megascale_env')."""
    if num_slices > 1:
        raise NotImplementedError(
            f"{num_slices} slices: multi-slice (DCN) bring-up is not ported "
            "to ray_tpu_torch yet (ROADMAP.md Queue A item 7, 'multi-slice "
            "megascale_env')")


def megascale_env(spec: HostGroupSpec) -> Dict[str, str]:
    """Env vars for cross-slice transport: none for one slice; more than
    one raises (``check_slices``)."""
    check_slices(spec.num_slices)
    return {}


def initialize_host(spec: HostGroupSpec, backend: str = "nccl") -> None:
    """Set up this host process for multi-process SPMD: the default
    process group over ``backend`` ("nccl" on the card, raising without
    one; "gloo" on the CPU), rank ``spec.process_id`` of
    ``spec.num_processes``, rendezvous at ``spec.coordinator_address``.
    Idempotent within a process. Single-process groups skip it."""
    global _DIST_INITIALIZED
    megascale_env(spec)
    if backend == "nccl":
        default_device(None)
    if spec.num_processes <= 1 or _DIST_INITIALIZED:
        return
    dist.init_process_group(
        backend, init_method=f"tcp://{spec.coordinator_address}",
        world_size=spec.num_processes, rank=spec.process_id)
    _DIST_INITIALIZED = True


def shutdown_host() -> None:
    global _DIST_INITIALIZED
    if _DIST_INITIALIZED:
        dist.destroy_process_group()
        _DIST_INITIALIZED = False


def local_process_specs(num_processes: int, port: int = 0) -> List[HostGroupSpec]:
    """Specs for spawning N processes on one machine (tests / local mode)."""
    if port == 0:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
    addr = f"127.0.0.1:{port}"
    return [
        HostGroupSpec(coordinator_address=addr, num_processes=num_processes, process_id=i)
        for i in range(num_processes)
    ]
