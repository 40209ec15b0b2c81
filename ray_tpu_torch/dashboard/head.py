"""Dashboard head — HTTP API over cluster state + job submission (copy of
ray_tpu/dashboard/head.py; its daemon stops its jobs on SIGTERM).

Reference: python/ray/dashboard/head.py:49 (DashboardHead) and
dashboard/modules/job/job_head.py (the REST routes). Dependency-free
asyncio HTTP server (same pattern as serve/http_proxy.py) running in a
background thread; reads state from the GCS, owns a JobManager.

Routes:
    GET  /                     minimal HTML overview
    GET  /api/version          {"version": ...}
    GET  /api/nodes            node table
    GET  /api/actors           actor table
    GET  /api/jobs/            submission records (+ driver jobs)
    POST /api/jobs/            {"entrypoint": ..., "runtime_env": {...}}
    GET  /api/jobs/<id>        one submission record
    POST /api/jobs/<id>/stop   terminate the job subprocess
    GET  /api/jobs/<id>/logs   {"logs": "..."}
    GET  /api/tasks            recent task events
    GET  /api/cluster_status   resources + demand summary
    GET  /api/v0/events        cluster event bus (observability/)
    GET  /api/v0/traces/<job>  a job's span tree (distributed tracing)
    GET  /api/v0/node_stats    per-node reporter samples
"""

from __future__ import annotations

import asyncio
import json
import threading
from typing import Dict, Optional, Tuple

from ray_tpu_torch import __version__
from ray_tpu_torch.dashboard.job_manager import JobManager


def _json_bytes(obj) -> bytes:
    return json.dumps(obj, default=str).encode()


class DashboardHead:
    def __init__(self, gcs_addr: Tuple[str, int], host: str = "127.0.0.1",
                 port: int = 8265, log_dir: Optional[str] = None):
        self.gcs_addr = tuple(gcs_addr)
        self.host = host
        self.port = port
        self.job_manager = JobManager(self.gcs_addr, log_dir=log_dir)
        self._gcs_client = None  # one persistent connection (thread-safe)
        self._loop = asyncio.new_event_loop()
        self._server: Optional[asyncio.AbstractServer] = None
        self._started = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ray-tpu-torch-dashboard")
        self._thread.start()
        if not self._started.wait(timeout=10):
            raise RuntimeError("dashboard failed to start")

    @property
    def address(self) -> str:
        return f"http://{self.host}:{self.port}"

    def _run(self) -> None:
        asyncio.set_event_loop(self._loop)
        self._loop.run_until_complete(self._start())
        self._started.set()
        self._loop.run_forever()

    async def _start(self) -> None:
        self._server = await asyncio.start_server(
            self._on_client, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    def _gcs(self):
        if self._gcs_client is None:
            from ray_tpu_torch._private.rpc import RpcClient

            self._gcs_client = RpcClient(*self.gcs_addr)
        return self._gcs_client

    # -- HTTP plumbing -------------------------------------------------
    async def _on_client(self, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter) -> None:
        try:
            line = await reader.readline()
            if not line:
                return
            parts = line.decode().split()
            if len(parts) < 2:
                return
            method, path = parts[0], parts[1]
            clen = 0
            while True:
                h = await reader.readline()
                if h in (b"\r\n", b"\n", b""):
                    break
                if h.lower().startswith(b"content-length:"):
                    clen = int(h.split(b":", 1)[1])
            body = await reader.readexactly(clen) if clen else b""
            status, ctype, payload = await asyncio.get_event_loop()\
                .run_in_executor(None, self._dispatch, method, path, body)
            writer.write(
                f"HTTP/1.1 {status} {'OK' if status < 400 else 'ERR'}\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {len(payload)}\r\n"
                f"Connection: close\r\n\r\n".encode() + payload)
            await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        except Exception:  # noqa: BLE001
            pass
        finally:
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass

    # -- routing (runs in executor thread; RPC calls block) ------------
    def _dispatch(self, method: str, path: str,
                  body: bytes) -> Tuple[int, str, bytes]:
        try:
            path = path.split("?", 1)[0].rstrip("/") or "/"
            if method == "GET" and path == "/":
                return 200, "text/html", self._html().encode()
            if method == "GET" and path == "/api/version":
                return 200, "application/json", _json_bytes(
                    {"version": __version__})
            if method == "GET" and path == "/api/nodes":
                return 200, "application/json", _json_bytes(
                    self._gcs().call("GetAllNodeInfo", timeout=10))
            if method == "GET" and path == "/api/actors":
                return 200, "application/json", _json_bytes(
                    self._gcs().call("ListActors", timeout=10))
            if method == "GET" and path == "/api/tasks":
                return 200, "application/json", _json_bytes(
                    self._gcs().call("ListTaskEvents", limit=1000,
                                     timeout=10))
            if method == "GET" and path == "/api/cluster_status":
                return 200, "application/json", _json_bytes(
                    self._gcs().call("GetClusterDemand", timeout=10))
            # observability subsystem (event bus + traces + node stats)
            if method == "GET" and path == "/api/v0/events":
                return 200, "application/json", _json_bytes(
                    self._gcs().call("ListClusterEvents", limit=2000,
                                     timeout=10))
            if method == "GET" and path == "/api/v0/node_stats":
                return 200, "application/json", _json_bytes(
                    self._gcs().call("ListNodeStats", timeout=10))
            if method == "GET" and path.startswith("/api/v0/traces/"):
                job_id = path[len("/api/v0/traces/"):]
                return 200, "application/json", _json_bytes(
                    self._gcs().call("GetTrace", job_id=job_id,
                                     timeout=10))
            if path == "/api/jobs":
                if method == "GET":
                    return 200, "application/json", _json_bytes(
                        self.job_manager.list_jobs())
                if method == "POST":
                    req = json.loads(body or b"{}")
                    sid = self.job_manager.submit_job(
                        entrypoint=req["entrypoint"],
                        submission_id=req.get("submission_id"),
                        runtime_env=req.get("runtime_env"),
                        metadata=req.get("metadata"),
                    )
                    return 200, "application/json", _json_bytes(
                        {"submission_id": sid})
            if method == "GET" and path.startswith("/api/nodes/"):
                # proxy to the owning node's agent (reference:
                # dashboard/agent.py — per-node logs/stats without
                # funneling bulk data through the GCS)
                rest = path[len("/api/nodes/"):]
                node_id, _, agent_path = rest.partition("/")
                return self._proxy_agent(node_id, agent_path)
            if path.startswith("/api/jobs/"):
                rest = path[len("/api/jobs/"):]
                if rest.endswith("/logs") and method == "GET":
                    sid = rest[: -len("/logs")]
                    return 200, "application/json", _json_bytes(
                        {"logs": self.job_manager.get_job_logs(sid)})
                if rest.endswith("/stop") and method == "POST":
                    sid = rest[: -len("/stop")]
                    return 200, "application/json", _json_bytes(
                        {"stopped": self.job_manager.stop_job(sid)})
                if method == "GET":
                    info = self.job_manager.get_job_info(rest)
                    if info is None:
                        return 404, "application/json", _json_bytes(
                            {"error": f"no job {rest!r}"})
                    return 200, "application/json", _json_bytes(info)
            return 404, "application/json", _json_bytes(
                {"error": f"no route {method} {path}"})
        except Exception as e:  # noqa: BLE001
            return 500, "application/json", _json_bytes({"error": str(e)})

    def _proxy_agent(self, node_id: str,
                     agent_path: str) -> Tuple[int, str, bytes]:
        nodes = self._gcs().call("GetAllNodeInfo", timeout=10) or []
        node = next((n for n in nodes if n["NodeID"] == node_id
                     or n["NodeID"].startswith(node_id)), None)
        if node is None:
            return 404, "application/json", _json_bytes(
                {"error": f"no node {node_id!r}"})
        port = node.get("AgentPort") or 0
        if not port:
            return 502, "application/json", _json_bytes(
                {"error": "node has no agent"})
        import urllib.request

        url = (f"http://{node['NodeManagerAddress']}:{port}"
               f"/api/local/{agent_path}")
        try:
            with urllib.request.urlopen(url, timeout=10) as resp:
                return resp.status, "application/json", resp.read()
        except Exception as e:  # noqa: BLE001
            return 502, "application/json", _json_bytes(
                {"error": f"agent unreachable: {e}"})

    def _html(self) -> str:
        from html import escape as esc

        gcs = self._gcs()
        nodes = gcs.call("GetAllNodeInfo", timeout=10) or []
        actors = gcs.call("ListActors", timeout=10) or []
        jobs = self.job_manager.list_jobs()
        rows = "".join(
            f"<tr><td>{esc(n['NodeID'][:12])}</td><td>{'head' if n.get('IsHead') else 'worker'}"
            f"</td><td>{'alive' if n.get('Alive') else 'dead'}</td>"
            f"<td>{esc(str(n.get('Resources')))}</td>"
            f"<td>{esc(str(n.get('AvailableResources')))}</td></tr>"
            for n in nodes)
        arows = "".join(
            f"<tr><td>{esc(a['actor_id'][:12])}</td><td>{esc(a.get('name') or '')}"
            f"</td><td>{esc(a['state'])}</td></tr>" for a in actors)
        jrows = "".join(
            f"<tr><td>{esc(j['submission_id'])}</td><td>{esc(j['status'])}</td>"
            f"<td><code>{esc(j['entrypoint'][:60])}</code></td></tr>"
            for j in jobs)
        return (
            "<html><head><title>ray_tpu_torch dashboard</title><style>"
            "body{font-family:sans-serif;margin:2em}table{border-collapse:"
            "collapse}td,th{border:1px solid #ccc;padding:4px 8px}</style>"
            f"</head><body><h1>ray_tpu_torch {__version__}</h1>"
            f"<h2>Nodes ({len(nodes)})</h2><table><tr><th>id</th><th>role"
            f"</th><th>state</th><th>total</th><th>available</th></tr>"
            f"{rows}</table>"
            f"<h2>Actors ({len(actors)})</h2><table><tr><th>id</th>"
            f"<th>name</th><th>state</th></tr>{arows}</table>"
            f"<h2>Jobs ({len(jobs)})</h2><table><tr><th>id</th><th>status"
            f"</th><th>entrypoint</th></tr>{jrows}</table>"
            "</body></html>")

    def shutdown(self) -> None:
        self.job_manager.shutdown()

        def _close():
            if self._server is not None:
                self._server.close()
            self._loop.stop()

        try:
            self._loop.call_soon_threadsafe(_close)
            self._thread.join(timeout=5)
        except Exception:  # noqa: BLE001
            pass


def main(argv=None) -> int:
    """Daemon entry: ``python -m ray_tpu_torch.dashboard.head --gcs-addr h:p``
    (spawned by ``python -m ray_tpu_torch.scripts.scripts start --head``).
    SIGTERM stops the running jobs before the process exits, so stopping
    the head leaves no job behind (JAX's daemon leaves them running)."""
    import argparse
    import signal
    import threading

    ap = argparse.ArgumentParser()
    ap.add_argument("--gcs-addr", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8265)
    a = ap.parse_args(argv)
    h, p = a.gcs_addr.rsplit(":", 1)
    head = DashboardHead((h, int(p)), host=a.host, port=a.port)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    print(f"dashboard at {head.address}", flush=True)
    while not stop.wait(1.0):
        pass
    head.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
