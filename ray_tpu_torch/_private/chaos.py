"""Chaos utilities — process-level fault injection for tests (PyTorch
port of ray_tpu/_private/chaos.py).

Reference: python/ray/_private/test_utils.py:1355 (`ResourceKillerActor`
/ `NodeKillerBase` used by python/ray/tests/chaos/ and the nightly
chaos suite). RPC-level injection lives in _private/rpc.py
(``testing_rpc_failure``, mirroring src/ray/rpc/rpc_chaos.h — including
the ``Method=prob:delay_ms`` latency form; ``rpc_delay_spec`` below
builds one). ``PreemptionInjector`` models capacity loss: a short
drain notice with a jittered deadline, then the host vanishes.

Without psutil: a raylet's workers are found by reading ``/proc``
(``stat`` for the parent pid, ``comm`` and ``cmdline``), as the raylet
and the dashboard's agent read it. Seeding is the JAX package's: the
same seed picks the same list position and the same jittered deadline.
"""

from __future__ import annotations

import os
import random
import signal
import threading
import time
from typing import Dict, List, Optional


# shared default rng for helpers called without an explicit one: seeded
# (replayable across runs) while still varying across successive calls
_DEFAULT_RNG = random.Random(0)


def rpc_delay_spec(method: str, prob: float, delay_ms: float) -> str:
    """One ``testing_rpc_failure`` entry injecting latency instead of a
    failure (join multiple with commas)."""
    return f"{method}={prob:g}:{delay_ms:g}"


def _read(path: str) -> str:
    with open(path, "rb") as f:
        return f.read().decode(errors="replace")


def _children_by_parent() -> Dict[int, List[int]]:
    """Every live process's pid under its parent's, from /proc/<pid>/stat
    (field 4; the command name, field 2, may hold spaces and parens)."""
    kids: Dict[int, List[int]] = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            stat = _read(f"/proc/{name}/stat")
        except OSError:
            continue  # exited since the listing
        ppid = int(stat[stat.rindex(")") + 2:].split()[1])
        kids.setdefault(ppid, []).append(int(name))
    return kids


def list_worker_pids(raylet_pid: int) -> List[int]:
    """PIDs of worker processes owned by a raylet. Covers both spawn
    paths: cold-started workers (``default_worker`` in the cmdline) and
    zygote-forked workers (which inherit the zygote's cmdline — their
    kernel comm is stamped ``rtw:<id>``, and the zygote parent itself
    must NOT be a kill candidate)."""
    kids = _children_by_parent()
    out = []
    todo = list(kids.get(raylet_pid, []))
    while todo:
        pid = todo.pop(0)
        todo.extend(kids.get(pid, []))
        try:
            cmd = _read(f"/proc/{pid}/cmdline").replace("\0", " ")
            comm = _read(f"/proc/{pid}/comm").strip()
        except OSError:
            continue
        if "default_worker" in cmd or comm.startswith("rtw:"):
            out.append(pid)
    return out


def kill_random_worker(cluster, rng: Optional[random.Random] = None) -> Optional[int]:
    """SIGKILL one random worker process somewhere in the cluster;
    returns its pid (None if no workers are running)."""
    # default is SEEDED but shared: replayable across runs, yet
    # successive no-rng calls still draw a fresh value each time (a
    # per-call Random(0) would kill the same list position forever)
    rng = rng or _DEFAULT_RNG
    pids: List[int] = []
    for node in cluster.nodes:
        pids.extend(list_worker_pids(node.proc.pid))
    if not pids:
        return None
    victim = rng.choice(pids)
    try:
        os.kill(victim, signal.SIGKILL)
        return victim
    except OSError:
        return None


class WorkerKiller:
    """Background thread killing a random worker every ``interval_s``
    (reference: ResourceKillerActor, test_utils.py:1355)."""

    def __init__(self, cluster, interval_s: float = 1.0,
                 max_kills: int = 1_000_000, seed: int = 0):
        self.cluster = cluster
        self.interval_s = interval_s
        self.max_kills = max_kills
        self.kills = 0
        self._rng = random.Random(seed)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        def _loop():
            while not self._stop.wait(self.interval_s) and \
                    self.kills < self.max_kills:
                if kill_random_worker(self.cluster, self._rng) is not None:
                    self.kills += 1

        self._thread = threading.Thread(target=_loop, daemon=True,
                                        name="chaos-worker-killer")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)


class NodeKiller:
    """Kills random NON-HEAD nodes of a cluster_utils.Cluster at an
    interval (reference: NodeKillerBase, test_utils.py:1451)."""

    def __init__(self, cluster, interval_s: float = 5.0, max_kills: int = 1,
                 seed: int = 0):
        self.cluster = cluster
        self.interval_s = interval_s
        self.max_kills = max_kills
        self.killed: List[str] = []
        self._rng = random.Random(seed)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def kill_one(self) -> Optional[str]:
        candidates = [n for n in self.cluster.nodes if not n.is_head]
        if not candidates:
            return None
        victim = self._rng.choice(candidates)
        self.cluster.remove_node(victim)
        self.killed.append(victim.node_id)
        return victim.node_id

    def start(self) -> None:
        def _loop():
            while not self._stop.wait(self.interval_s) and \
                    len(self.killed) < self.max_kills:
                self.kill_one()

        self._thread = threading.Thread(target=_loop, daemon=True,
                                        name="chaos-node-killer")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)


class PreemptionInjector:
    """Preemption notices against a cluster_utils.Cluster: a random
    NON-HEAD node gets a graceful ``DrainNode`` with reason PREEMPTION
    and a seeded, jittered deadline; at deadline + grace the host is
    hard-killed if it hasn't deregistered itself (real preemptions don't
    wait for a polite exit). Seeded for reproducible chaos runs."""

    def __init__(self, cluster, interval_s: float = 10.0,
                 max_preemptions: int = 1, seed: int = 0,
                 deadline_s: float = 10.0, jitter_s: float = 2.0,
                 kill_grace_s: float = 3.0):
        self.cluster = cluster
        self.interval_s = interval_s
        self.max_preemptions = max_preemptions
        self.deadline_s = deadline_s
        self.jitter_s = jitter_s
        self.kill_grace_s = kill_grace_s
        self.preempted: List[str] = []
        self._rng = random.Random(seed)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def preempt_one(self) -> Optional[str]:
        """Issue one preemption notice; blocks until the node is gone
        (deadline + grace at most). Returns the node id, or None when
        only the head node remains."""
        from ray_tpu_torch._private.drain import REASON_PREEMPTION
        from ray_tpu_torch._private.node import kill_process_tree
        from ray_tpu_torch._private.rpc import RpcClient

        candidates = [n for n in self.cluster.nodes if not n.is_head]
        if not candidates:
            return None
        victim = self._rng.choice(candidates)
        deadline = max(0.5, self.deadline_s + self._rng.uniform(
            -self.jitter_s, self.jitter_s))
        client = RpcClient("127.0.0.1", self.cluster.gcs_port)
        try:
            client.call("DrainNode", node_id=victim.node_id,
                        reason=REASON_PREEMPTION, deadline_s=deadline,
                        timeout=10)
        except Exception:  # noqa: BLE001 — the hard kill below still fires
            pass
        finally:
            client.close()
        # the raylet normally deregisters and exits on its own; the
        # preemption hard-stop at deadline + grace is the contract
        stop_at = time.monotonic() + deadline + self.kill_grace_s
        while time.monotonic() < stop_at and not self._stop.is_set():
            if victim.proc.poll() is not None:
                break
            time.sleep(0.1)
        kill_process_tree(victim.proc, force=True)
        if victim in self.cluster.nodes:
            self.cluster.nodes.remove(victim)
        self.preempted.append(victim.node_id)
        return victim.node_id

    def start(self) -> None:
        def _loop():
            while not self._stop.wait(self.interval_s) and \
                    len(self.preempted) < self.max_preemptions:
                self.preempt_one()

        self._thread = threading.Thread(target=_loop, daemon=True,
                                        name="chaos-preemption")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
