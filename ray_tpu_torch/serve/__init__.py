"""ray_tpu_torch.serve — model serving (PyTorch port of ray_tpu.serve;
reference: python/ray/serve).

Deployments are replicated actors; handles route with power-of-two-
choices; @serve.batch keeps the card's batches full; a stdlib HTTP proxy
provides ingress. A replica asks for a card through its actor options
(``num_gpus`` or ``resources={"GPU": 1}``) and runs on the leased one.

The gRPC ingress (``start_grpc_proxy``, ``grpc_proxy_stats``,
``stop_grpc_proxy``) is not ported: each raises NotImplementedError
naming its ROADMAP.md row.
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

GRPC_INGRESS_ROW = "ROADMAP.md Queue A, 'Serve's gRPC ingress'"


def _grpc_waits(name: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"serve.{name}: the gRPC ingress is not ported to ray_tpu_torch "
            f"yet; it waits for {GRPC_INGRESS_ROW}")

    fn.__name__ = fn.__qualname__ = name
    fn.__doc__ = f"Not ported: raises NotImplementedError ({GRPC_INGRESS_ROW})."
    return fn


start_grpc_proxy = _grpc_waits("start_grpc_proxy")
grpc_proxy_stats = _grpc_waits("grpc_proxy_stats")
stop_grpc_proxy = _grpc_waits("stop_grpc_proxy")

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
