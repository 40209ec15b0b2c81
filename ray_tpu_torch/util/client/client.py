"""ClientRuntime — the driver-side CoreRuntime proxy for `ray://`
connections (copy of ray_tpu/util/client/client.py, with ``num_gpus``
where JAX's has ``num_tpus``; reference: python/ray/util/client/worker.py).

Every public API call (remote/get/put/wait/actors/...) flows through the
same CoreRuntime interface the in-cluster runtime implements, so client
mode is transparent: ``ray_tpu_torch.init(address="ray://head:10001")``
and the full API works from a machine outside the cluster. A put value
crosses the wire as task arguments do (``dumps_with_refs``: refs inside
it resolve on the server, a CUDA tensor goes as a host tensor).
"""

from __future__ import annotations

import pickle
import threading
import uuid
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch._private.core import ActorOptions, CoreRuntime, TaskOptions
from ray_tpu_torch._private.ids import ActorID, ObjectID
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch.util.client.common import dumps_with_refs


def _opts_dict(opts: TaskOptions | ActorOptions) -> Dict[str, Any]:
    """Re-expressed as .options(...) keywords for the server side."""
    out: Dict[str, Any] = {}
    res = dict(opts.resources or {})
    cpu = res.pop("CPU", None)
    gpu = res.pop("GPU", None)
    if cpu is not None:
        out["num_cpus"] = cpu
    if gpu is not None:
        out["num_gpus"] = gpu
    if res:
        out["resources"] = res
    if getattr(opts, "num_returns", 1) not in (1, None):
        out["num_returns"] = opts.num_returns
    if getattr(opts, "max_retries", 0):
        out["max_retries"] = opts.max_retries
    if getattr(opts, "max_restarts", 0):
        out["max_restarts"] = opts.max_restarts
    if getattr(opts, "max_concurrency", 1) not in (1, None):
        out["max_concurrency"] = opts.max_concurrency
    if getattr(opts, "name", ""):
        out["name"] = opts.name
    if getattr(opts, "lifetime", None):
        out["lifetime"] = opts.lifetime
    if getattr(opts, "runtime_env", None):
        out["runtime_env"] = opts.runtime_env
    return out


class ClientRuntime(CoreRuntime):
    def __init__(self, address: str):
        """address: "host:port" of a ClientServer."""
        from ray_tpu_torch._private.rpc import RpcClient

        host, port_s = address.rsplit(":", 1)
        self._client = RpcClient(host, int(port_s))
        self._client_id = uuid.uuid4().hex
        self._lock = threading.Lock()
        if self._client.call("Ping", timeout=10) != "pong":
            raise ConnectionError(f"no client server at {address}")
        self.node_id = "client"
        self.job_runtime_env: Dict[str, Any] = {}

    # -- internals ------------------------------------------------------
    def _call(self, method: str, **kw) -> dict:
        reply = self._client.call(method, client_id=self._client_id,
                                  timeout=kw.pop("timeout_rpc", 60), **kw)
        if isinstance(reply, dict) and reply.get("error"):
            raise ValueError(reply["error"])
        return reply

    def _refs_from(self, hexes: List[str]) -> List[ObjectRef]:
        return [ObjectRef(ObjectID.from_hex(h)) for h in hexes]

    def _merged_opts(self, opts) -> Dict[str, Any]:
        """Task/actor options with the job-level runtime env merged
        underneath (the server applies them via .options(...))."""
        from ray_tpu_torch._private.runtime_env import merge_runtime_envs

        out = _opts_dict(opts)
        if self.job_runtime_env:
            out["runtime_env"] = merge_runtime_envs(
                self.job_runtime_env, out.get("runtime_env"))
        return out

    # -- CoreRuntime ----------------------------------------------------
    def put(self, value: Any) -> ObjectRef:
        reply = self._call("Put", data=dumps_with_refs(value))
        return self._refs_from([reply["ref"]])[0]

    def get(self, refs: Sequence[ObjectRef],
            timeout: Optional[float] = None) -> List[Any]:
        reply = self._call(
            "GetValues", ref_hexes=[r.hex() for r in refs],
            get_timeout=timeout,
            timeout_rpc=(timeout + 30) if timeout else -1)
        if "exception" in reply:
            raise pickle.loads(reply["exception"])
        return pickle.loads(reply["values"])

    def wait(self, refs, num_returns, timeout, fetch_local=True):
        reply = self._call(
            "WaitRefs", ref_hexes=[r.hex() for r in refs],
            num_returns=num_returns, wait_timeout=timeout,
            fetch_local=fetch_local,
            timeout_rpc=(timeout + 30) if timeout else -1)
        by_hex = {r.hex(): r for r in refs}
        return ([by_hex[h] for h in reply["ready"]],
                [by_hex[h] for h in reply["not_ready"]])

    def submit_task(self, remote_function, args, kwargs,
                    opts: TaskOptions) -> List[ObjectRef]:
        from ray_tpu_torch._private.serialization import dumps_function

        reply = self._call(
            "SubmitTask",
            fn_bytes=dumps_function(remote_function._function),
            args_bytes=dumps_with_refs((args, dict(kwargs))),
            opts_bytes=pickle.dumps(self._merged_opts(opts)),
        )
        return self._refs_from(reply["refs"])

    def create_actor(self, actor_class, args, kwargs,
                     opts: ActorOptions) -> ActorID:
        from ray_tpu_torch._private.serialization import dumps_function

        reply = self._call(
            "CreateActor",
            cls_bytes=dumps_function(actor_class._cls),
            args_bytes=dumps_with_refs((args, dict(kwargs))),
            opts_bytes=pickle.dumps(self._merged_opts(opts)),
        )
        return ActorID.from_hex(reply["actor_id"])

    def submit_actor_task(self, handle, method_name, args, kwargs,
                          opts: TaskOptions) -> List[ObjectRef]:
        reply = self._call(
            "CallMethod", actor_hex=handle._actor_id.hex(),
            method_name=method_name,
            args_bytes=dumps_with_refs((args, dict(kwargs))),
            opts_bytes=pickle.dumps(self._merged_opts(opts)),
        )
        return self._refs_from(reply["refs"])

    def kill_actor(self, actor_id, no_restart: bool = True) -> None:
        self._call("KillActor", actor_hex=actor_id.hex(),
                   no_restart=no_restart)

    def cancel(self, ref, force=False, recursive=True) -> None:
        self._call("CancelRef", ref_hex=ref.hex(), force=force)

    def as_future(self, ref: ObjectRef) -> Future:
        fut: Future = Future()

        def _poll():
            try:
                fut.set_result(self.get([ref], timeout=None)[0])
            except Exception as e:  # noqa: BLE001
                fut.set_exception(e)

        threading.Thread(target=_poll, daemon=True).start()
        return fut

    def free_object(self, oid) -> None:
        try:
            self._client.call_oneway("Release",
                                     client_id=self._client_id,
                                     ref_hexes=[oid.hex()])
        except Exception:  # noqa: BLE001
            pass

    def get_actor(self, name: str, namespace: Optional[str] = None):
        reply = self._call("GetNamedActor", name=name, namespace=namespace)
        return ActorID.from_hex(reply["actor_id"])

    def cluster_resources(self) -> Dict[str, float]:
        return self._call("ClusterInfo")["cluster_resources"]

    def available_resources(self) -> Dict[str, float]:
        return self._call("ClusterInfo")["available_resources"]

    def nodes(self) -> List[Dict[str, Any]]:
        return self._call("ClusterInfo")["nodes"]

    def shutdown(self) -> None:
        try:
            self._call("Disconnect")
        except Exception:  # noqa: BLE001
            pass
        try:
            self._client.close()
        except Exception:  # noqa: BLE001
            pass
