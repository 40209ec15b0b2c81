"""ray_tpu_torch.util.client — remote drivers over TCP (copy of
ray_tpu/util/client; reference:
python/ray/util/client, `ray://` connections).

A normal driver shares the head node's unix-socket object store, so it
must run ON a cluster machine. Client mode lifts that: the driver's
entire CoreRuntime is an RPC proxy to a ClientServer process running on
the head, which owns the real objects/actors on the client's behalf.

    ray_tpu_torch.init(address="ray://head:10001")   # full API, remote machine

Start the server with the head (``python -m ray_tpu_torch.scripts.scripts start
--head`` does it) or manually:
``python -m ray_tpu_torch.util.client.server --gcs host:port``.

A CUDA tensor in a result arrives on the CPU, as it does across
processes in cluster mode.
"""

from ray_tpu_torch.util.client.client import ClientRuntime

__all__ = ["ClientRuntime"]
