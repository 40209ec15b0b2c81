"""ClientServer — the head-side proxy that owns objects/actors for
remote drivers (copy of ray_tpu/util/client/server.py; reference:
python/ray/util/client/server/).

Runs as a process on (or beside) the head node: connects to the cluster
as a driver, serves client RPCs over the framework's RPC layer, and
keeps a per-client registry of live ObjectRefs so the remote driver's
garbage collection (Release) and disconnects free cluster memory.
It never touches the card: the values it holds and returns are host
objects, as a driver's are across processes in cluster mode.

    python -m ray_tpu_torch.util.client.server --gcs HOST:PORT --port N
"""

from __future__ import annotations

import logging
import pickle
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.util.client.common import resolver_scope

logger = logging.getLogger("ray_tpu_torch.client_server")


class ClientServer:
    def __init__(self, gcs_addr: Tuple[str, int], port: int = 10001,
                 host: str = "0.0.0.0"):
        import ray_tpu_torch
        from ray_tpu_torch._private.rpc import RpcServer

        ray_tpu_torch.init(address=f"{gcs_addr[0]}:{gcs_addr[1]}",
                     ignore_reinit_error=True)
        self._lock = threading.Lock()
        # client_id -> {ref_hex: ObjectRef}
        self._refs: Dict[str, Dict[str, Any]] = {}
        # client_id -> {actor_hex: ActorHandle}
        self._actors: Dict[str, Dict[str, Any]] = {}
        # client_id -> actor hexes created NON-detached by that client
        self._owned_actors: Dict[str, set] = {}
        self.server = RpcServer(host=host, port=port, name="client-server")
        self.server.register_instance(self)
        self.server.start()
        self.port = self.server.port
        logger.info("client server on :%d", self.port)

    # -- helpers --------------------------------------------------------
    def _track(self, client_id: str, refs: List[Any]) -> List[str]:
        with self._lock:
            table = self._refs.setdefault(client_id, {})
            out = []
            for r in refs:
                table[r.hex()] = r
                out.append(r.hex())
        return out

    def _load_args(self, client_id: str, args_bytes: bytes) -> Any:
        # ref markers inside resolve against THIS client's table only —
        # per-client isolation, no cross-client ref guessing. The live
        # table is bound without copying: dict reads are GIL-atomic and
        # Release only pops keys (a concurrent release reads as the same
        # KeyError a released ref would raise anyway).
        with self._lock:
            table = self._refs.setdefault(client_id, {})
        with resolver_scope(table):
            return pickle.loads(args_bytes)

    # -- RPC surface ----------------------------------------------------
    def Put(self, client_id: str, data: bytes) -> dict:
        import ray_tpu_torch

        value = self._load_args(client_id, data)
        ref = ray_tpu_torch.put(value)
        return {"ref": self._track(client_id, [ref])[0]}

    def GetValues(self, client_id: str, ref_hexes: List[str],
                  get_timeout: Optional[float] = None) -> dict:
        import ray_tpu_torch

        with self._lock:
            table = self._refs.get(client_id, {})
            refs = [table.get(h) for h in ref_hexes]
        missing = [h for h, r in zip(ref_hexes, refs) if r is None]
        if missing:
            return {"error": f"unknown refs {missing}"}
        try:
            values = ray_tpu_torch.get(refs, timeout=get_timeout)
        except Exception as e:  # noqa: BLE001
            return {"exception": pickle.dumps(e)}
        return {"values": pickle.dumps(values, protocol=5)}

    def WaitRefs(self, client_id: str, ref_hexes: List[str],
                 num_returns: int, wait_timeout: Optional[float],
                 fetch_local: bool = True) -> dict:
        import ray_tpu_torch

        with self._lock:
            table = self._refs.get(client_id, {})
            refs = [table.get(h) for h in ref_hexes]
        missing = [h for h, r in zip(ref_hexes, refs) if r is None]
        if missing:
            return {"error": f"unknown refs {missing} (already released?)"}
        ready, rest = ray_tpu_torch.wait(refs, num_returns=num_returns,
                                   timeout=wait_timeout,
                                   fetch_local=fetch_local)
        return {"ready": [r.hex() for r in ready],
                "not_ready": [r.hex() for r in rest]}

    def SubmitTask(self, client_id: str, fn_bytes: bytes, args_bytes: bytes,
                   opts_bytes: bytes) -> dict:
        import ray_tpu_torch
        from ray_tpu_torch._private.serialization import loads_function

        fn = loads_function(fn_bytes)
        args, kwargs = self._load_args(client_id, args_bytes)
        opts: dict = pickle.loads(opts_bytes)
        remote_fn = ray_tpu_torch.remote(fn) if not opts else \
            ray_tpu_torch.remote(fn).options(**opts)
        out = remote_fn.remote(*args, **kwargs)
        refs = out if isinstance(out, list) else [out]
        return {"refs": self._track(client_id, refs)}

    def CreateActor(self, client_id: str, cls_bytes: bytes, args_bytes: bytes,
                    opts_bytes: bytes) -> dict:
        import ray_tpu_torch
        from ray_tpu_torch._private.serialization import loads_function

        cls = loads_function(cls_bytes)
        args, kwargs = self._load_args(client_id, args_bytes)
        opts: dict = pickle.loads(opts_bytes)
        actor_cls = ray_tpu_torch.remote(cls)
        if opts:
            actor_cls = actor_cls.options(**opts)
        handle = actor_cls.remote(*args, **kwargs)
        with self._lock:
            self._actors.setdefault(client_id, {})[
                handle._actor_id.hex()] = handle
            # non-detached actors die with their (remote) driver, like a
            # normal driver's actors — remember which ones we must reap
            if opts.get("lifetime") != "detached":
                self._owned_actors.setdefault(client_id, set()).add(
                    handle._actor_id.hex())
        return {"actor_id": handle._actor_id.hex()}

    def GetNamedActor(self, client_id: str, name: str,
                      namespace: Optional[str] = None) -> dict:
        import ray_tpu_torch

        try:
            handle = ray_tpu_torch.get_actor(name, namespace)
        except Exception as e:  # noqa: BLE001
            return {"error": str(e)}
        with self._lock:
            self._actors.setdefault(client_id, {})[
                handle._actor_id.hex()] = handle
        return {"actor_id": handle._actor_id.hex()}

    def CallMethod(self, client_id: str, actor_hex: str, method_name: str,
                   args_bytes: bytes, opts_bytes: bytes = b"") -> dict:
        with self._lock:
            handle = self._actors.get(client_id, {}).get(actor_hex)
        if handle is None:
            return {"error": f"unknown actor {actor_hex}"}
        args, kwargs = self._load_args(client_id, args_bytes)
        opts: dict = pickle.loads(opts_bytes) if opts_bytes else {}
        if opts.get("num_returns") == "streaming":
            return {"error": "streaming generators are not supported "
                             "over ray:// connections"}
        method = getattr(handle, method_name)
        if opts:
            method = method.options(**opts)
        out = method.remote(*args, **kwargs)
        refs = out if isinstance(out, list) else [out]
        return {"refs": self._track(client_id, refs)}

    def KillActor(self, client_id: str, actor_hex: str,
                  no_restart: bool = True) -> dict:
        import ray_tpu_torch

        with self._lock:
            handle = self._actors.get(client_id, {}).pop(actor_hex, None)
        if handle is not None:
            ray_tpu_torch.kill(handle, no_restart=no_restart)
        return {"ok": handle is not None}

    def CancelRef(self, client_id: str, ref_hex: str,
                  force: bool = False) -> dict:
        import ray_tpu_torch

        with self._lock:
            ref = self._refs.get(client_id, {}).get(ref_hex)
        if ref is not None:
            ray_tpu_torch.cancel(ref, force=force)
        return {"ok": ref is not None}

    def Release(self, client_id: str, ref_hexes: List[str]) -> dict:
        with self._lock:
            table = self._refs.get(client_id, {})
            for h in ref_hexes:
                table.pop(h, None)
        return {"ok": True}

    def ClusterInfo(self, client_id: str) -> dict:
        import ray_tpu_torch
        from ray_tpu_torch.util import state

        return {
            "cluster_resources": ray_tpu_torch.cluster_resources(),
            "available_resources": ray_tpu_torch.available_resources(),
            "nodes": state.list_nodes(),
        }

    def Disconnect(self, client_id: str) -> dict:
        """Free everything the client held (reference: client data
        servicer cleanup on channel close)."""
        import ray_tpu_torch

        with self._lock:
            table = self._refs.pop(client_id, {})
            actors = self._actors.pop(client_id, {})
            owned = self._owned_actors.pop(client_id, set())
        killed = 0
        for hx in owned:
            handle = actors.get(hx)
            if handle is not None:
                try:
                    ray_tpu_torch.kill(handle)
                    killed += 1
                except Exception:  # noqa: BLE001
                    pass
        logger.info("client %s disconnected (%d refs freed, %d actors "
                    "killed)", client_id[:8], len(table), killed)
        return {"ok": True}

    def Ping(self) -> str:
        return "pong"


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--gcs", required=True, help="GCS host:port")
    ap.add_argument("--port", type=int, default=10001)
    ap.add_argument("--host", default="0.0.0.0")
    a = ap.parse_args(argv)
    logging.basicConfig(level="INFO",
                        format="[client-server] %(levelname)s %(message)s")
    h, p = a.gcs.rsplit(":", 1)
    srv = ClientServer((h, int(p)), port=a.port, host=a.host)
    print(f"client server ready on :{srv.port}", flush=True)
    while True:
        time.sleep(3600)


if __name__ == "__main__":
    raise SystemExit(main())
