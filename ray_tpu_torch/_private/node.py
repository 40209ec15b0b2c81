"""Node bootstrap — starts/stops the head node's processes (copy of
ray_tpu/_private/node.py, without psutil: the memory from /proc/meminfo,
the teardown by process group).

Reference: python/ray/_private/node.py (Node.start_head_processes :1364 —
spawns gcs_server; start_ray_processes :1393 — spawns raylet which hosts
plasma) and services.py process management.
"""

from __future__ import annotations

import atexit
import json
import logging
import os
import signal
import subprocess
import sys
import tempfile
import time
import uuid
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._private.config import config
from ray_tpu_torch._private.ids import NodeID
from ray_tpu_torch._private.rpc import RpcClient

logger = logging.getLogger(__name__)


def available_memory_bytes() -> int:
    """MemAvailable of /proc/meminfo (psutil's virtual_memory().available)."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("/proc/meminfo has no MemAvailable line")


def default_node_resources(
    num_cpus: Optional[float] = None,
    num_gpus: Optional[float] = None,
    resources: Optional[Dict[str, float]] = None,
) -> Dict[str, float]:
    """The head node's resources. Runs in the driver only: counting the
    cards (``torch.cuda.device_count()``) is a CUDA call, which neither
    the raylet nor the zygote may make before they fork."""
    from ray_tpu_torch.accelerators import get_all_accelerator_managers

    out: Dict[str, float] = dict(resources or {})
    out["CPU"] = float(num_cpus) if num_cpus is not None else float(os.cpu_count() or 1)
    if num_gpus is not None:
        out["GPU"] = float(num_gpus)
    # every registered backend detects through the same ABC (reference:
    # _private/accelerators — 8 plugins behind one surface)
    for name, mgr in get_all_accelerator_managers().items():
        if name not in out:
            n = mgr.get_current_node_num_accelerators()
            if n:
                out[name] = float(n)
        out.update(mgr.get_current_node_additional_resources())
    out.setdefault("memory", float(available_memory_bytes() // 2))
    node_ip = "127.0.0.1"
    out[f"node:{node_ip}"] = 1.0
    return out


def _wait_port_file(proc: subprocess.Popen, port_file: str, what: str, log_path: str,
                    timeout: float) -> int:
    """The port a daemon bound, from the file it writes once listening."""
    deadline = time.monotonic() + timeout
    while not os.path.exists(port_file):
        if proc.poll() is not None:
            raise RuntimeError(f"{what} exited with {proc.returncode}; see {log_path}")
        if time.monotonic() > deadline:
            raise RuntimeError(f"{what} failed to start in time")
        time.sleep(0.02)
    with open(port_file) as f:
        port = int(f.read().strip())
    os.remove(port_file)
    return port


def spawn_gcs(port: int, session_dir: str,
              log_name: str = "gcs.log") -> Tuple[subprocess.Popen, int]:
    """Spawn the GCS server process and wait until it answers Ping;
    returns it and its port. ``port`` 0: the GCS binds a port the system
    picks and reports it through a file. (A port picked here and bound
    there could be taken in between by any process of the host binding
    or connecting, ROADMAP.md Queue C.)"""
    env = dict(os.environ)
    env["RAY_TPU_CONFIG_JSON"] = config.to_json()
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in [repo_root, env.get("PYTHONPATH", "")] if p
    )
    gcs_log = open(os.path.join(session_dir, log_name), "ab")
    port_file = os.path.join(session_dir, "gcs_port")
    proc = subprocess.Popen(
        [
            sys.executable, "-m", "ray_tpu_torch._private.gcs.server",
            "--port", str(port),
            "--port-file", port_file,
            "--storage-path", config.gcs_storage_path,
        ],
        env=env,
        stdout=gcs_log,
        stderr=subprocess.STDOUT,
        start_new_session=True,  # its own process group: kill_process_tree
    )
    # generous: a loaded CI box (a full suite's worth of processes on
    # one core) can take >30s just to schedule the interpreter start
    port = _wait_port_file(proc, port_file, "GCS", f"{session_dir}/{log_name}", 60)
    client = RpcClient("127.0.0.1", port)
    deadline = time.monotonic() + 60
    try:
        while True:
            try:
                client.call("Ping", timeout=2)
                return proc, port
            except Exception:
                if proc.poll() is not None:
                    raise RuntimeError(
                        f"GCS exited with {proc.returncode}; see {session_dir}/{log_name}"
                    )
                if time.monotonic() > deadline:
                    raise RuntimeError("GCS did not become ready")
                time.sleep(0.05)
    finally:
        # probe client: close (cancel + await its read loop) rather than
        # abandoning the task to be GC'd mid-read ("Task was destroyed")
        client.close()


def spawn_raylet(
    gcs_addr: Tuple[str, int],
    node_id: str,
    resources: Dict[str, float],
    store_socket: str,
    store_capacity: int,
    session_dir: str,
    is_head: bool = False,
    log_name: str = "raylet.log",
    labels: Optional[Dict[str, str]] = None,
    gpu_ids: Optional[List[int]] = None,
) -> Tuple[subprocess.Popen, int]:
    """Spawn a raylet daemon process and wait for its port file.

    Shared by the single-node Node bootstrap and the multi-node test
    harness (reference: cluster_utils.Cluster add_node, cluster_utils.py:208).
    ``gpu_ids``: the host card ids the node leases (default: its "GPU"
    count numbered from 0).
    """
    env = dict(os.environ)
    env["RAY_TPU_CONFIG_JSON"] = config.to_json()
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in [repo_root, env.get("PYTHONPATH", "")] if p
    )
    port_file = os.path.join(session_dir, "raylet_port")
    raylet_log = open(os.path.join(session_dir, log_name), "ab")
    cmd = [
        sys.executable,
        "-m",
        "ray_tpu_torch._private.raylet.raylet",
        "--node-id", node_id,
        "--gcs-addr", f"{gcs_addr[0]}:{gcs_addr[1]}",
        "--resources-json", json.dumps(resources),
        "--store-socket", store_socket,
        "--store-capacity", str(store_capacity),
        "--session-dir", session_dir,
        "--port-file", port_file,
        "--log-level", os.environ.get("RAY_TPU_LOG_LEVEL", "INFO"),
    ]
    if is_head:
        cmd.append("--is-head")
    if labels:
        cmd.extend(["--labels-json", json.dumps(labels)])
    if gpu_ids is not None:
        cmd.extend(["--gpu-ids-json", json.dumps(list(gpu_ids))])
    # its own process group, which the store daemon, the zygote and every
    # worker join (none of them calls setsid): kill_process_tree ends them
    proc = subprocess.Popen(cmd, env=env, stdout=raylet_log, stderr=subprocess.STDOUT,
                            start_new_session=True)
    return proc, _wait_port_file(proc, port_file, "raylet", f"{session_dir}/{log_name}", 60)


def _group_alive(pgid: int) -> bool:
    try:
        os.killpg(pgid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True


def kill_process_tree(proc: subprocess.Popen, force: bool = False) -> None:
    """Terminate a daemon process and everything it spawned (store daemon,
    worker processes): the process group that ``spawn_gcs`` /
    ``spawn_raylet`` started it in, which outlives its leader, so the
    group is signalled even when the daemon itself has exited. SIGTERM
    (SIGKILL with ``force``), then SIGKILL to what is left after 3 s."""
    if proc is None:
        return
    pgid = proc.pid
    try:
        os.killpg(pgid, signal.SIGKILL if force else signal.SIGTERM)
    except ProcessLookupError:
        return
    except PermissionError:
        logger.warning("cannot signal process group %d", pgid)
        return
    deadline = time.monotonic() + 3
    try:
        proc.wait(timeout=3)
    except subprocess.TimeoutExpired:
        pass
    while _group_alive(pgid) and time.monotonic() < deadline:
        time.sleep(0.02)
    if _group_alive(pgid):
        try:
            os.killpg(pgid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
    try:
        proc.wait(timeout=2)
    except subprocess.TimeoutExpired:
        pass


class Node:
    """Manages head-node child processes: GCS, raylet (which owns the
    object-store daemon and workers)."""

    def __init__(
        self,
        num_cpus: Optional[float] = None,
        num_gpus: Optional[float] = None,
        resources: Optional[Dict[str, float]] = None,
        object_store_memory: Optional[int] = None,
    ):
        self.session_dir = tempfile.mkdtemp(prefix="ray_tpu_session_")
        self.node_id = NodeID.from_random().hex()
        self.gcs_port = config.gcs_port  # 0: the GCS's own pick, known once it is up
        self.store_socket = os.path.join(self.session_dir, "store.sock")
        self.store_capacity = int(object_store_memory or config.object_store_memory_bytes)
        self.resources = default_node_resources(num_cpus, num_gpus, resources)
        self.gcs_proc: Optional[subprocess.Popen] = None
        self.raylet_proc: Optional[subprocess.Popen] = None
        self.raylet_port: Optional[int] = None

    @property
    def gcs_addr(self) -> Tuple[str, int]:
        return ("127.0.0.1", self.gcs_port)

    @property
    def raylet_addr(self) -> Tuple[str, int]:
        return ("127.0.0.1", self.raylet_port)

    def start(self) -> None:
        self.gcs_proc, self.gcs_port = spawn_gcs(self.gcs_port, self.session_dir)
        self.raylet_proc, self.raylet_port = spawn_raylet(
            gcs_addr=self.gcs_addr,
            node_id=self.node_id,
            resources=self.resources,
            store_socket=self.store_socket,
            store_capacity=self.store_capacity,
            session_dir=self.session_dir,
            is_head=True,
        )
        atexit.register(self.stop)

    def _wait_rpc_ready(self, addr: Tuple[str, int], name: str, timeout: float = 30.0) -> None:
        client = RpcClient(addr[0], addr[1])
        deadline = time.monotonic() + timeout
        try:
            while True:
                try:
                    client.call("Ping", timeout=2)
                    return
                except Exception:
                    if time.monotonic() > deadline:
                        raise RuntimeError(f"{name} did not become ready at {addr}")
                    time.sleep(0.05)
        finally:
            client.close()

    def stop(self) -> None:
        # kill whole trees (the raylet owns the store daemon + workers)
        kill_process_tree(self.raylet_proc)
        kill_process_tree(self.gcs_proc)
        self.raylet_proc = None
        self.gcs_proc = None
