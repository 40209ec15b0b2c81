"""Device mesh of the port (PyTorch port of ray_tpu/parallel/mesh.py).

The JAX package builds a ``jax.sharding.Mesh`` over its devices; the port
builds a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the process group, one device a rank, with the same seven axis names in
the same order (outer to inner):

    replica   : cross-slice data parallelism
    data      : data parallelism / batch sharding (DP)
    fsdp      : parameter and optimizer sharding (FSDP)
    stage     : pipeline stages (PP)
    expert    : mixture-of-experts expert sharding (EP)
    sequence  : sequence parallelism (ring attention)
    tensor    : tensor parallelism (TP)

The ranks are laid out as JAX lays out its CPU devices, a plain reshape
of ``0 .. world-1`` in AXIS_ORDER, so rank r holds the shard of a leaf or
a batch that JAX's device r holds. The process group's backend follows
the device: NCCL for ``cuda``, gloo for ``cpu``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ray_tpu_torch import default_device

# Canonical axis order. Outer axes get the slower interconnect.
AXIS_ORDER: Tuple[str, ...] = (
    "replica",
    "data",
    "fsdp",
    "stage",
    "expert",
    "sequence",
    "tensor",
)

# Axes whose collectives are expected to cross slices (hosts).
DCN_AXES: Tuple[str, ...] = ("replica",)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape. -1 on at most one axis means "absorb the
    remaining devices" (like numpy reshape).

    Examples::

        MeshSpec(data=-1)                       # pure DP over all ranks
        MeshSpec(data=2, expert=4)              # DP x EP on 8 ranks
    """

    replica: int = 1
    data: int = 1
    fsdp: int = 1
    stage: int = 1
    expert: int = 1
    sequence: int = 1
    tensor: int = 1

    def sizes(self) -> Dict[str, int]:
        return {a: getattr(self, a) for a in AXIS_ORDER}

    def resolve(self, n_devices: int) -> "MeshSpec":
        """Fill in a single -1 axis so the product equals n_devices."""
        sizes = self.sizes()
        wild = [a for a, s in sizes.items() if s == -1]
        if len(wild) > 1:
            raise ValueError(f"At most one axis may be -1, got {wild}")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if wild:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes product {fixed}"
                )
            sizes[wild[0]] = n_devices // fixed
        else:
            if fixed != n_devices:
                raise ValueError(
                    f"MeshSpec product {fixed} != device count {n_devices}"
                )
        return MeshSpec(**sizes)

    @property
    def num_devices(self) -> int:
        p = math.prod(self.sizes().values())
        if p < 0:
            raise ValueError("resolve() the spec first")
        return p


def backend_for(device) -> str:
    """The process group backend a mesh on ``device`` runs its
    collectives on: NCCL on the card, gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def build_mesh(spec: MeshSpec, device=None) -> DeviceMesh:
    """A DeviceMesh over every rank of the process group, shaped by
    ``spec`` (a -1 axis absorbs the world size) with dims named
    AXIS_ORDER. ``device`` as ``default_device``: None means the card.
    Raises RuntimeError when no process group is up or its backend does
    not serve ``device``, ValueError when the spec does not cover the
    world."""
    if not dist.is_initialized():
        raise RuntimeError(
            "build_mesh needs a process group: call "
            "torch.distributed.init_process_group first (or single_device_mesh)")
    device = default_device(device)
    backend = backend_for(device)
    if backend not in dist.get_backend():
        raise RuntimeError(f"a mesh on {device.type} runs on {backend}; the "
                           f"process group's backend is {dist.get_backend()}")
    world = dist.get_world_size()
    spec = spec.resolve(world)
    shape = tuple(spec.sizes()[a] for a in AXIS_ORDER)
    return DeviceMesh(device.type, torch.arange(world).reshape(shape),
                      mesh_dim_names=AXIS_ORDER)


def single_device_mesh(device=None) -> DeviceMesh:
    """A one-rank mesh with the full axis set (all sizes 1), so sharded
    code paths run unmodified on one device. Brings up a world of one
    (an in-process store) when no process group exists."""
    device = default_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend_for(device), store=dist.HashStore(),
                                rank=0, world_size=1)
    return build_mesh(MeshSpec(), device)


MeshLike = Union[DeviceMesh, MeshSpec, Mapping[str, int], None]


def mesh_sizes(mesh: MeshLike) -> Dict[str, int]:
    """Axis name → size of a DeviceMesh, a MeshSpec or a mapping (the
    role ``jax.sharding.Mesh.shape`` plays); {} for None."""
    if mesh is None:
        return {}
    if isinstance(mesh, DeviceMesh):
        return {a: mesh.size(i) for i, a in enumerate(mesh.mesh_dim_names)}
    if isinstance(mesh, MeshSpec):
        return mesh.sizes()
    return dict(mesh)


def mesh_axis_size(mesh: MeshLike, axis: str) -> int:
    return mesh_sizes(mesh).get(axis, 1)


def flat_axes(mesh: MeshLike, *axes: str) -> List[str]:
    """The subset of `axes` with size > 1 in this mesh (useful for
    building minimal partition specs)."""
    return [a for a in axes if mesh_axis_size(mesh, a) > 1]


def mesh_device(mesh, device=None) -> torch.device:
    """The device an entry point given ``mesh`` and ``device`` runs on:
    the mesh's own device type when ``device`` is None (a mesh is built
    on an explicit device), else ``device``, which must match it.
    Without a mesh, ``default_device(device)``."""
    if not isinstance(mesh, DeviceMesh):
        return default_device(device)
    if device is None:
        return torch.device(mesh.device_type)
    device = torch.device(device)
    if device.type != mesh.device_type:
        raise ValueError(f"device {device} is not on the mesh's {mesh.device_type}")
    return device
