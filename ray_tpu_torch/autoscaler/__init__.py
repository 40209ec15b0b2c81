"""ray_tpu_torch.autoscaler — demand-driven cluster scaling (PyTorch port
of ray_tpu/autoscaler; reference: python/ray/autoscaler/v2).

The GCS aggregates queued lease shapes from raylet heartbeats plus
pending actors; the autoscaler bin-packs unmet demand onto configured
node types and drives a NodeProvider. Multi-host slices scale atomically
(slice_hosts hosts per unit, terminated only when every host is idle).
``GCEGpuNodeProvider`` takes the place of the JAX package's
``GCETpuNodeProvider``.
"""

from ray_tpu_torch.autoscaler.autoscaler import (
    Autoscaler,
    NodeTypeConfig,
    compute_scaling_decision,
)
from ray_tpu_torch.autoscaler.node_provider import (
    FakeNodeProvider,
    GCEGpuNodeProvider,
    LocalNodeProvider,
    NodeProvider,
)

__all__ = [
    "Autoscaler",
    "FakeNodeProvider",
    "GCEGpuNodeProvider",
    "LocalNodeProvider",
    "NodeProvider",
    "NodeTypeConfig",
    "compute_scaling_decision",
]
