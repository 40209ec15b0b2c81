"""The CLI (ray_tpu_torch/scripts/scripts.py) against JAX's
(ray_tpu/scripts/scripts.py), both driven as subprocesses, side by side,
with free ports and one TMPDIR for the test: ``start --head`` (the GCS, the
head's raylet, the dashboard and the ``ray://`` client server),
``start --address`` (a second node), ``status``, ``submit``,
``job submit/status/logs/list/stop`` and ``stop``.

- Each CLI keeps its own state file in the shared TMPDIR, with the same
  keys; neither reads the other's.
- ``submit``'s script calls ``init()`` with no address: the port's runs on
  the CLI's cluster (``RAY_TPU_ADDRESS``); JAX's starts a fresh one-node
  cluster (ROADMAP.md Queue C), which the test prints and does not copy.
- After the port's ``stop`` no process that its CLI started is left: every
  process carrying the side's marker variable (which each daemon, worker
  and job inherits) is gone. JAX's leftovers are killed by the test.
"""

import json
import os
import pathlib
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import uuid

import pytest

from front_door_ref import PACKAGES, free_port, http_get, repo_env

MARK = "FRONT_DOOR_CLI_SIDE"  # set in each side's CLI processes, inherited by all they start
CARD = {"jax": "--num-tpus", "port": "--num-gpus"}
STATE = {"jax": "ray_tpu_cluster.json", "port": "ray_tpu_torch_cluster.json"}
SCRIPT = """import importlib, sys
rt = importlib.import_module(sys.argv[1])
rt.init()
node = rt.get(rt.remote(lambda: rt.get_runtime_context().get_node_id()).remote(), timeout=60)
print("node", node)
rt.shutdown()
"""


def marked(tag: str) -> list:
    """Pids of the live processes whose environment holds ``MARK=tag``."""
    out = []
    want = f"{MARK}={tag}".encode()
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/environ", "rb") as f:
                if want in f.read().split(b"\0"):
                    with open(f"/proc/{pid}/stat") as s:
                        if s.read().rsplit(")", 1)[1].split()[0] != "Z":
                            out.append(int(pid))
        except OSError:
            pass
    return out


class Side:
    def __init__(self, name: str, tmp):
        self.name, self.tag = name, f"{name}-{uuid.uuid4().hex[:8]}"
        self.env = repo_env(TMPDIR=str(tmp), **{MARK: self.tag})
        if name == "port":
            self.env["RAY_TPU_FAKE_GPUS"] = "1"
        self.dash, self.client = free_port(), free_port()
        self.state_path = tmp / STATE[name]

    def spawn(self, *args) -> subprocess.Popen:
        return subprocess.Popen([sys.executable, "-m", f"{PACKAGES[self.name]}.scripts.scripts",
                                 *args], env=self.env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    def state(self) -> dict:
        return json.loads(self.state_path.read_text())


def run(steps: dict, timeout: float = 120) -> dict:
    """One CLI command a side, run together: {side: stdout}, each exit 0."""
    procs = {side: side.spawn(*args) for side, args in steps.items()}
    out = {}
    for side, proc in procs.items():
        text, _ = proc.communicate(timeout=timeout)
        assert proc.returncode == 0, (side.name, text)
        out[side.name] = text
    return out


@pytest.fixture
def tmp():
    """A short TMPDIR: a store's socket path (session dir + "store.sock")
    must fit a unix socket's 107 bytes, which a pytest tmp_path under an
    xdist worker can exceed."""
    path = pathlib.Path(tempfile.mkdtemp(prefix="cli"))
    yield path
    shutil.rmtree(path, ignore_errors=True)


@pytest.fixture
def sides(tmp):
    made = [Side("jax", tmp), Side("port", tmp)]
    yield made
    for side in made:  # whatever a failed case, or JAX's stop, left behind
        for pid in marked(side.tag):
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass


def wait_dashboard(side: Side) -> None:
    """JAX's start returns before its dashboard listens; the port's waits."""
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        try:
            if http_get(f"http://127.0.0.1:{side.dash}/api/version")[0] == 200:
                return
        except OSError:
            time.sleep(0.1)
    raise AssertionError(f"{side.name}'s dashboard did not answer")


def test_cli_cluster_lifecycle(sides, tmp):
    jax, port = sides
    run({s: ("start", "--head", "--num-cpus", "2", CARD[s.name], "1", "--dashboard-port",
             str(s.dash), "--client-server-port", str(s.client)) for s in sides})
    states = {s.name: s.state() for s in sides}
    assert sorted(states["port"]) == sorted(states["jax"])
    assert states["port"]["address"] != states["jax"]["address"]
    # submit: a script whose init() takes no address, run while the rest is
    # driven
    script = tmp / "job.py"
    script.write_text(SCRIPT)
    submits = {s: s.spawn("submit", str(script), PACKAGES[s.name]) for s in sides}
    run({s: ("start", "--address", states[s.name]["address"], "--num-cpus", "1",
             CARD[s.name], "0") for s in sides})
    status = {k: json.loads(v) for k, v in run({s: ("status",) for s in sides}).items()}
    for name, card in (("jax", "TPU"), ("port", "GPU")):
        assert len([n for n in status[name]["nodes"] if n["Alive"]]) == 2, name
        assert status[name]["total_resources"]["CPU"] == 3
        assert status[name]["total_resources"][card] == 1
    assert all(n["AgentPort"] for n in status["port"]["nodes"])

    # the job API through each CLI's dashboard
    wait_dashboard(jax)
    sids = {k: v.strip() for k, v in run({s: ("job", "submit", "python -c \"print('job says 7')\"")
                                          for s in sides}).items()}
    deadline = time.monotonic() + 60
    while True:
        st = run({s: ("job", "status", sids[s.name]) for s in sides})
        if all(v.strip() in ("SUCCEEDED", "FAILED") for v in st.values()) or \
                time.monotonic() > deadline:
            break
        time.sleep(0.2)
    assert {k: v.strip() for k, v in st.items()} == {"jax": "SUCCEEDED", "port": "SUCCEEDED"}
    logs = run({s: ("job", "logs", sids[s.name]) for s in sides})
    assert all(v == "job says 7\n" for v in logs.values()), logs
    long = {k: v.strip() for k, v in run({s: ("job", "submit", "sleep 600")
                                          for s in sides}).items()}
    listed = run({s: ("job", "list") for s in sides})
    for name, text in listed.items():
        assert f"{sids[name]}  SUCCEEDED" in text and long[name] in text, text
    time.sleep(0.3)  # the sleep is RUNNING
    assert run({s: ("job", "stop", long[s.name]) for s in sides}) == {"jax": "True\n",
                                                                     "port": "True\n"}
    got = {}
    for side, proc in submits.items():
        got[side.name], _ = proc.communicate(timeout=120)
        assert proc.returncode == 0, got[side.name]
    nodes = {s.name: {n["NodeID"] for n in status[s.name]["nodes"]} for s in sides}
    ran_on = {name: text.split("node ", 1)[1].split()[0] for name, text in got.items()}
    print(f"submit's task ran on the CLI's cluster: "
          f"{ {k: ran_on[k] in nodes[k] for k in ran_on} }")
    assert ran_on["port"] in nodes["port"]
    # the port's daemons, store daemons, zygotes and workers are all marked
    assert len(marked(port.tag)) >= 8

    stopped = run({s: ("stop",) for s in sides}, timeout=60)
    assert stopped["port"] == "stopped 5 processes\n"  # dashboard, client server, 2 raylets, gcs
    assert not port.state_path.exists() and not jax.state_path.exists()
    deadline = time.monotonic() + 10
    while marked(port.tag) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert marked(port.tag) == []
