"""Helpers of the front-door tests (tests/test_torch_ray_client.py,
test_torch_dashboard*.py, test_torch_cli.py): the JAX package's and the
port's daemons started side by side as subprocesses, on free ports, each
cluster's processes checked gone at the end.

``PACKAGES`` maps each side to its top package name; a daemon is
``python -m <package>.<module>`` with the repo on its path.
"""

import contextlib
import json
import os
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import ray_tpu
import ray_tpu_torch
from ray_tpu.cluster_utils import Cluster as JaxCluster
from ray_tpu_torch.cluster_utils import Cluster as PortCluster
from test_torch_cluster_cases import collector_paused

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": "ray_tpu", "port": "ray_tpu_torch"}
RUNTIMES = {"jax": ray_tpu, "port": ray_tpu_torch}
CLUSTERS = {"jax": JaxCluster, "port": PortCluster}
TERMINAL = ("SUCCEEDED", "FAILED", "STOPPED")


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def repo_env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in [ROOT, env.get("PYTHONPATH", "")] if p)
    env.pop("RAY_TPU_ADDRESS", None)
    env.update(extra)
    return env


def spawn_client_server(side: str, gcs_address: str) -> subprocess.Popen:
    """A client server of ``side`` on a free port (``client_server_port``
    reads which)."""
    return subprocess.Popen(
        [sys.executable, "-m", f"{PACKAGES[side]}.util.client.server",
         "--gcs", gcs_address, "--port", "0", "--host", "127.0.0.1"],
        env=repo_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def client_server_port(proc) -> int:
    """The port of a spawned client server, from its ready line, which both
    packages print alike."""
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if "client server ready on :" in line:
            return int(line.rsplit(":", 1)[1])
        if not line and proc.poll() is not None:
            break
    proc.kill()
    raise AssertionError(f"the client server did not start: {proc.args}")


def stop(proc) -> None:
    proc.kill()
    proc.wait(timeout=30)
    if proc.stdout is not None:
        proc.stdout.close()


@contextlib.contextmanager
def both_clusters(**node):
    """One single-node ``Cluster`` a package (``node``: add_node kwargs, the
    card keyword named per side by ``cards``), the collector paused while
    JAX's runs."""
    cards = node.pop("cards", 0)
    made = {}
    with collector_paused():
        try:
            for side, cls in CLUSTERS.items():
                c = made[side] = cls()
                key = "num_tpus" if side == "jax" else "num_gpus"
                c.add_node(**node, **({key: cards} if cards else {}))
                c.wait_for_nodes()
            yield made
        finally:
            for c in made.values():
                c.shutdown()


def http_get(url: str):
    """(status, JSON body) of a GET, errors included."""
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def wait_status(client, sid: str, want, timeout: float = 60.0) -> str:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        st = client.get_job_status(sid)
        if st in want:
            return st
        time.sleep(0.1)
    raise AssertionError(f"job {sid} stuck in {client.get_job_status(sid)}; logs:\n"
                         + client.get_job_logs(sid))
