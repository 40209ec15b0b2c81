"""ray_tpu_torch.serve — model serving (PyTorch port of ray_tpu.serve;
reference: python/ray/serve).

Deployments are replicated actors; handles route with power-of-two-
choices; @serve.batch keeps the card's batches full; a stdlib HTTP proxy
and a generic gRPC service provide ingress (``grpc`` is imported only
when the gRPC proxy starts). A replica asks for a card through its actor
options (``num_gpus`` or ``resources={"GPU": 1}``) and runs on the leased
one.
"""

from ray_tpu_torch.serve import slo
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.multiplex import get_multiplexed_model_id, multiplexed
from ray_tpu_torch.serve.controller import (
    delete,
    get_app_handle,
    run,
    shutdown,
    status,
)
from ray_tpu_torch.serve.grpc_proxy import (
    grpc_proxy_stats,
    start_grpc_proxy,
    stop_grpc_proxy,
)
from ray_tpu_torch.serve.deployment import (
    Application,
    Deployment,
    DeploymentHandle,
    DeploymentResponse,
    deployment,
)
from ray_tpu_torch.serve.http_proxy import (
    http_proxy_stats,
    start_http_proxy,
    stop_http_proxy,
)
from ray_tpu_torch.serve.slo import (
    DeadlineExceededError,
    OverloadedError,
    ReplicasUnavailableError,
    request_deadline,
)

__all__ = [
    "Application",
    "DeadlineExceededError",
    "Deployment",
    "DeploymentHandle",
    "DeploymentResponse",
    "OverloadedError",
    "ReplicasUnavailableError",
    "batch",
    "delete",
    "deployment",
    "get_app_handle",
    "get_multiplexed_model_id",
    "grpc_proxy_stats",
    "http_proxy_stats",
    "multiplexed",
    "request_deadline",
    "run",
    "shutdown",
    "slo",
    "start_grpc_proxy",
    "start_http_proxy",
    "status",
    "stop_grpc_proxy",
    "stop_http_proxy",
]
