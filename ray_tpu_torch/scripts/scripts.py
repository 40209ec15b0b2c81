"""CLI — cluster lifecycle (copy of ray_tpu/scripts/scripts.py; reference:
python/ray/scripts/scripts.py — `ray start` :800, `stop` :1341, `status`,
`submit` :1976).

Usage:
    python -m ray_tpu_torch.scripts.scripts start --head [--num-cpus N] [--num-gpus N]
    python -m ray_tpu_torch.scripts.scripts start --address HOST:PORT
    python -m ray_tpu_torch.scripts.scripts status [--address HOST:PORT]
    python -m ray_tpu_torch.scripts.scripts stop
    python -m ray_tpu_torch.scripts.scripts submit SCRIPT [args...]
    python -m ray_tpu_torch.scripts.scripts job submit|status|logs|stop|list [ARG]

``start --head`` starts the GCS and the head's raylet (with its node
agent), the dashboard (``--dashboard-port``, 0 disables it) and the
``ray://`` client server (``--client-server-port``, 0 disables it), and
returns once each answers. Every daemon runs in a process group of its
own, which ``stop`` ends whole: the raylets' store daemons and workers
with them, and the dashboard's jobs, which it stops on SIGTERM.

The state of the running cluster is ``$TMPDIR/ray_tpu_torch_cluster.json``,
a name of its own, so that this CLI and the JAX package's never read each
other's.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

STATE_FILE = os.path.join(tempfile.gettempdir(), "ray_tpu_torch_cluster.json")
READY_TIMEOUT_S = 60.0  # for a daemon's ready line
STOP_GRACE_S = 10.0  # from SIGTERM to a process group's SIGKILL (the dashboard stops its jobs)


def _write_state(state: dict) -> None:
    with open(STATE_FILE, "w") as f:
        json.dump(state, f)


def _read_state() -> Optional[dict]:
    if not os.path.exists(STATE_FILE):
        return None
    with open(STATE_FILE) as f:
        return json.load(f)


def _daemon(module: str, args: List[str], log_path: str) -> subprocess.Popen:
    """``python -m module args`` in a process group of its own, its output
    appended to ``log_path``, the repo on its path."""
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in [repo_root, env.get("PYTHONPATH", "")] if p)
    with open(log_path, "ab") as log:
        return subprocess.Popen([sys.executable, "-m", module] + args, env=env, stdout=log,
                                stderr=subprocess.STDOUT, start_new_session=True)


def _wait_ready(proc: subprocess.Popen, log_path: str, line: str) -> None:
    """Until ``line`` shows in the daemon's log; raises if it exits first."""
    deadline = time.monotonic() + READY_TIMEOUT_S
    while True:
        with open(log_path, "rb") as f:
            if line.encode() in f.read():
                return
        if proc.poll() is not None or time.monotonic() > deadline:
            raise RuntimeError(f"{line!r} did not show (exit {proc.poll()}); see {log_path}")
        time.sleep(0.05)


def cmd_start(args) -> int:
    from ray_tpu_torch._private.node import Node, default_node_resources

    if args.head:
        import atexit

        node = Node(num_cpus=args.num_cpus, num_gpus=args.num_gpus)
        node.start()
        # CLI-started clusters outlive the CLI process (reference:
        # `ray start` daemonizes) — drop the auto-stop hook
        atexit.unregister(node.stop)
        addr = f"{node.gcs_addr[0]}:{node.gcs_addr[1]}"
        state = {
            "address": addr,
            "gcs_pid": node.gcs_proc.pid,
            "raylet_pids": [node.raylet_proc.pid],
            "session_dir": node.session_dir,
        }
        waits = []
        dash_port = args.dashboard_port
        if dash_port:
            log = os.path.join(node.session_dir, "dashboard.log")
            dash = _daemon("ray_tpu_torch.dashboard.head",
                           ["--gcs-addr", addr, "--port", str(dash_port)], log)
            waits.append((dash, log, "dashboard at "))
            state["dashboard_pid"] = dash.pid
            state["dashboard_address"] = f"http://127.0.0.1:{dash_port}"
            print(f"  dashboard: http://127.0.0.1:{dash_port}")
        client_port = args.client_server_port
        if client_port:
            log = os.path.join(node.session_dir, "client_server.log")
            csrv = _daemon("ray_tpu_torch.util.client.server",
                           ["--gcs", addr, "--port", str(client_port)], log)
            waits.append((csrv, log, "client server ready on :"))
            state["client_server_pid"] = csrv.pid
            print(f"  remote drivers: ray_tpu_torch.init(address='ray://<host>:{client_port}')")
        _write_state(state)
        for proc, log, line in waits:
            _wait_ready(proc, log, line)
        print(f"ray_tpu_torch head started.\n  address: {addr}")
        print(f"  connect with: ray_tpu_torch.init(address='{addr}')")
        return 0

    if not args.address:
        print("either --head or --address required", file=sys.stderr)
        return 1
    # worker node: start a raylet that joins the existing GCS
    from ray_tpu_torch._private.config import config
    from ray_tpu_torch._private.ids import NodeID
    from ray_tpu_torch._private.node import spawn_raylet

    session_dir = tempfile.mkdtemp(prefix="ray_tpu_torch_worker_")
    host, port = args.address.rsplit(":", 1)
    try:
        proc, _ = spawn_raylet(
            gcs_addr=(host, int(port)),
            node_id=NodeID.from_random().hex(),
            resources=default_node_resources(args.num_cpus, args.num_gpus, None),
            store_socket=os.path.join(session_dir, "store.sock"),
            store_capacity=config.object_store_memory_bytes,
            session_dir=session_dir,
            labels=json.loads(args.labels) if args.labels else None,
        )
    except RuntimeError as e:
        print(f"{e} (see {session_dir}/raylet.log)", file=sys.stderr)
        return 1
    state = _read_state() or {"address": args.address, "raylet_pids": []}
    state.setdefault("raylet_pids", []).append(proc.pid)
    _write_state(state)
    print(f"worker raylet joined {args.address} (pid {proc.pid})")
    return 0


def _group_members(pgid: int) -> List[int]:
    """The live (not zombie) processes of process group ``pgid``."""
    out = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                state, _ppid, pgrp = f.read().rsplit(")", 1)[1].split()[:3]
        except (OSError, IndexError, ValueError):
            continue
        if int(pgrp) == pgid and state != "Z":
            out.append(int(pid))
    return out


def cmd_stop(_args) -> int:
    """SIGTERM to each daemon's process group (the dashboard first, so its
    jobs stop while the cluster still runs; the GCS last); SIGKILL to what
    is left of the group once its leader is gone or the grace ran out; on
    return no process of any group is alive."""
    state = _read_state()
    n = 0
    if state:
        pids = [state.get("dashboard_pid"), state.get("client_server_pid"),
                *state.get("raylet_pids", []), state.get("gcs_pid")]
        for pgid in filter(None, pids):
            try:
                os.killpg(pgid, signal.SIGTERM)
                n += 1
            except ProcessLookupError:
                continue
            deadline = time.monotonic() + STOP_GRACE_S
            while pgid in _group_members(pgid) and time.monotonic() < deadline:
                time.sleep(0.05)
            deadline = time.monotonic() + STOP_GRACE_S
            while _group_members(pgid) and time.monotonic() < deadline:
                try:
                    os.killpg(pgid, signal.SIGKILL)
                except ProcessLookupError:
                    break
                time.sleep(0.05)
        os.remove(STATE_FILE)
    print(f"stopped {n} processes")
    return 0


def cmd_status(args) -> int:
    import ray_tpu_torch
    from ray_tpu_torch.util import state as state_api

    address = args.address or (_read_state() or {}).get("address")
    if not address:
        print("no running cluster found", file=sys.stderr)
        return 1
    ray_tpu_torch.init(address=address, ignore_reinit_error=True)
    summary = state_api.cluster_summary()
    print(json.dumps(summary, indent=2, default=str))
    ray_tpu_torch.shutdown()
    return 0


def cmd_submit(args) -> int:
    """Run a script with the cluster address exported (reference: `ray
    submit`; its ``ray_tpu_torch.init()`` connects there)."""
    address = args.address or (_read_state() or {}).get("address")
    env = dict(os.environ)
    if address:
        env["RAY_TPU_ADDRESS"] = address
    return subprocess.call([sys.executable, args.script] + args.script_args, env=env)


def cmd_job(args) -> int:
    """Job-submission client commands (reference: `ray job` CLI,
    dashboard/modules/job/cli.py)."""
    from ray_tpu_torch.dashboard import JobSubmissionClient

    address = args.address or (_read_state() or {}).get(
        "dashboard_address") or "http://127.0.0.1:8265"
    client = JobSubmissionClient(address)
    if args.action == "submit":
        if not args.arg:
            print("usage: job submit '<entrypoint>'", file=sys.stderr)
            return 1
        sid = client.submit_job(entrypoint=args.arg)
        print(sid)
        return 0
    if args.action == "list":
        for j in client.list_jobs():
            print(f"{j['submission_id']}  {j['status']:10s}  {j['entrypoint']}")
        return 0
    if not args.arg:
        print("submission id required", file=sys.stderr)
        return 1
    if args.action == "status":
        print(client.get_job_status(args.arg))
    elif args.action == "logs":
        print(client.get_job_logs(args.arg), end="")
    elif args.action == "stop":
        print(client.stop_job(args.arg))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m ray_tpu_torch.scripts.scripts")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("start", help="start head or worker node processes")
    sp.add_argument("--head", action="store_true")
    sp.add_argument("--address", default=None, help="GCS host:port to join")
    sp.add_argument("--num-cpus", type=float, default=None)
    sp.add_argument("--num-gpus", type=float, default=None)
    sp.add_argument("--dashboard-port", type=int, default=8265,
                    help="0 disables the dashboard")
    sp.add_argument("--labels", default=None,
                    help="JSON node labels (worker join; autoscaler key)")
    sp.add_argument("--client-server-port", type=int, default=10001,
                    help="ray:// remote-driver port (0 disables)")
    sp.set_defaults(fn=cmd_start)

    sp = sub.add_parser("stop", help="stop processes started by this CLI")
    sp.set_defaults(fn=cmd_stop)

    sp = sub.add_parser("status", help="print cluster summary")
    sp.add_argument("--address", default=None)
    sp.set_defaults(fn=cmd_status)

    sp = sub.add_parser("submit", help="run a script against the cluster")
    sp.add_argument("script")
    sp.add_argument("script_args", nargs="*")
    sp.add_argument("--address", default=None)
    sp.set_defaults(fn=cmd_submit)

    sp = sub.add_parser("job", help="job-submission API client")
    sp.add_argument("action",
                    choices=["submit", "status", "logs", "stop", "list"])
    sp.add_argument("arg", nargs="?", help="entrypoint or submission id")
    sp.add_argument("--address", default=None,
                    help="dashboard URL, e.g. http://127.0.0.1:8265")
    sp.set_defaults(fn=cmd_job)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
