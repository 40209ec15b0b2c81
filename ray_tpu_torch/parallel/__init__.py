"""ray_tpu_torch.parallel — the device mesh, sharding rules and the
collectives of the sharded step (PyTorch port of ray_tpu.parallel).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the JAX
package's seven axis names; the port runs every axis, ``stage`` (the
pipeline, ray_tpu_torch/ops/pipeline.py) among them. ``bootstrap``
brings up the default process group across host processes
(``initialize_host``).
"""

from ray_tpu_torch.parallel.bootstrap import (
    HostGroupSpec,
    initialize_host,
    local_process_specs,
    megascale_env,
    shutdown_host,
)
from ray_tpu_torch.parallel.collectives import (
    MeshGroups,
    mesh_groups,
    read_collectives,
    reset_collectives,
)
from ray_tpu_torch.parallel.mesh import (
    AXIS_ORDER,
    DCN_AXES,
    MeshSpec,
    build_mesh,
    flat_axes,
    mesh_axis_size,
    single_device_mesh,
)
from ray_tpu_torch.parallel.sharding import (
    DEFAULT_RULES,
    local_shard,
    shard_batch,
    shard_tree,
    spec_for,
)

__all__ = [
    "HostGroupSpec",
    "initialize_host",
    "shutdown_host",
    "local_process_specs",
    "megascale_env",
    "AXIS_ORDER",
    "DCN_AXES",
    "MeshSpec",
    "build_mesh",
    "single_device_mesh",
    "mesh_axis_size",
    "flat_axes",
    "DEFAULT_RULES",
    "spec_for",
    "local_shard",
    "shard_tree",
    "shard_batch",
    "MeshGroups",
    "mesh_groups",
    "read_collectives",
    "reset_collectives",
]
