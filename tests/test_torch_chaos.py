"""The port's chaos helpers against the JAX package's, with no cluster but
one: ``rpc_delay_spec`` equal to JAX's; every ``TestChaosSpecParsing``
case of tests/test_chaos.py through both packages' ``_chaos_action`` (and
the live delay through the port's ``RpcServer``); the seeded choices of
``kill_random_worker``, ``WorkerKiller``, ``NodeKiller`` and
``PreemptionInjector`` (victim positions and jittered deadlines) equal to
JAX's for the same seed and list length, with the kills themselves
recorded instead of sent; and ``list_worker_pids`` on a port node, read
from ``/proc``: its workers, zygote-forked and cold-started, equal to what
JAX's psutil version lists for the same raylet, and never its zygote.
"""

import os
import random
import time
from types import SimpleNamespace

import pytest

import ray_tpu._private.chaos as JC
import ray_tpu._private.rpc as jax_rpc
import ray_tpu_torch
import ray_tpu_torch._private.chaos as PC
import ray_tpu_torch._private.rpc as port_rpc
from cluster_ref import port_cluster
from ray_tpu._private.config import config as jax_config
from ray_tpu_torch._private.config import config as port_config


@pytest.mark.parametrize("args", [("GetObject", 0.5, 200), ("*", 1.0, 12.5),
                                  ("PushTask", 0.05, 1e4)])
def test_rpc_delay_spec_matches_jax(args):
    assert PC.rpc_delay_spec(*args) == JC.rpc_delay_spec(*args)


# (spec, method, JAX's expected action)
SPECS = [
    ("M=1.0", "M", "request"), ("M=0.0", "M", None),
    ("M=1.0:response", "M", "response"),
    ("M=1.0:delay:250", "M", "delay:250"),
    ("M=1.0:250", "M", "delay:250"), ("M=1.0:12.5", "M", "delay:12.5"),
    ("*=1.0:80", "Anything", "delay:80"), ("Other=1.0", "M", None),
    ("A=0.0,M=1.0:40,M=1.0:response", "M", "delay:40"),
    ("M=notanumber", "M", None),
]


@pytest.mark.parametrize("spec,method,want", SPECS)
def test_chaos_spec_parsing_matches_jax(spec, method, want):
    got = []
    for rpc, cfg in ((jax_rpc, jax_config), (port_rpc, port_config)):
        old = cfg.testing_rpc_failure
        cfg.testing_rpc_failure = spec
        try:
            got.append(rpc._chaos_action(method))
        finally:
            cfg.testing_rpc_failure = old
    assert got == [want, want]


def test_delay_injects_real_latency_end_to_end():
    """A live RpcServer of the port's holds the call for the injected
    delay (slow-network paths are testable, not just failures)."""
    server = port_rpc.RpcServer(name="chaos-delay-test")
    server.register("Echo", lambda v: v)
    loop = port_rpc.EventLoopThread(name="chaos-delay-io")
    server.start(loop)
    client = port_rpc.RpcClient(server.host, server.port)
    old = port_config.testing_rpc_failure
    try:
        assert client.call("Echo", v=1, timeout=10) == 1  # warm conn
        for spec in ("Echo=1.0:150", "Echo=1.0:delay:150"):
            port_config.testing_rpc_failure = spec
            t0 = time.monotonic()
            assert client.call("Echo", v=2, timeout=10) == 2
            assert time.monotonic() - t0 >= 0.14
    finally:
        port_config.testing_rpc_failure = old
        client.close()
        server.stop()
        loop.stop()


# ---------------------------------------------------------------------------
# seeded choices, kills recorded
# ---------------------------------------------------------------------------
def _fake_cluster(n_nodes, pids_per_node=3):
    nodes = [SimpleNamespace(node_id=f"node{i}", is_head=i == 0,
                             proc=SimpleNamespace(pid=1000 + i, poll=lambda: 0))
             for i in range(n_nodes)]
    cluster = SimpleNamespace(nodes=nodes, gcs_port=1, removed=[])
    cluster.remove_node = lambda n: cluster.removed.append(n.node_id)
    return cluster, {1000 + i: [10 * (1000 + i) + k for k in range(pids_per_node)]
                     for i in range(n_nodes)}


def test_kill_random_worker_choices_match_jax(monkeypatch):
    killed = {"jax": [], "port": []}
    cluster, pids = _fake_cluster(4)
    monkeypatch.setattr(JC, "list_worker_pids", lambda rp: pids[rp])
    monkeypatch.setattr(PC, "list_worker_pids", lambda rp: pids[rp])
    monkeypatch.setattr(JC, "psutil", SimpleNamespace(Error=OSError, Process=lambda pid: (
        SimpleNamespace(kill=lambda: killed["jax"].append(pid)))))
    monkeypatch.setattr(PC, "os", SimpleNamespace(  # chaos's os alone: kills recorded
        kill=lambda pid, sig: killed["port"].append((pid, sig))))
    for seed in range(5):
        jrng, prng = random.Random(seed), random.Random(seed)
        for _ in range(6):
            assert PC.kill_random_worker(cluster, prng) == JC.kill_random_worker(cluster, jrng)
    assert [p for p, _ in killed["port"]] == killed["jax"] and len(killed["jax"]) == 30
    assert {sig for _, sig in killed["port"]} == {9}  # SIGKILL
    # no workers anywhere: nothing killed, None
    monkeypatch.setattr(PC, "list_worker_pids", lambda rp: [])
    assert PC.kill_random_worker(cluster, random.Random(0)) is None


def test_worker_killer_seeded_like_jax(monkeypatch):
    victims = {"jax": [], "port": []}
    cluster, _ = _fake_cluster(2)
    monkeypatch.setattr(JC, "kill_random_worker",
                        lambda c, rng: victims["jax"].append(rng.random()) or 1)
    monkeypatch.setattr(PC, "kill_random_worker",
                        lambda c, rng: victims["port"].append(rng.random()) or 1)
    for mod, name in ((JC, "jax"), (PC, "port")):
        k = mod.WorkerKiller(cluster, interval_s=0.01, max_kills=4, seed=7)
        k.start()
        deadline = time.monotonic() + 10
        while k.kills < 4 and time.monotonic() < deadline:
            time.sleep(0.01)
        k.stop()
        assert k.kills == 4
    assert victims["port"] == victims["jax"]


@pytest.mark.parametrize("n_nodes", [2, 3, 6])
def test_node_killer_choices_match_jax(n_nodes):
    got = []
    for mod in (JC, PC):
        cluster, _ = _fake_cluster(n_nodes)
        killer = mod.NodeKiller(cluster, max_kills=5, seed=3)
        got.append([killer.kill_one() for _ in range(5)])
        assert cluster.removed == killer.killed
    assert got[1] == got[0] and "node0" not in got[1]  # never the head


@pytest.mark.parametrize("seed,n_nodes", [(0, 2), (42, 3), (7, 5)])
def test_preemption_injector_matches_jax(seed, n_nodes, monkeypatch):
    """The same victims and the same jittered deadlines, in the DrainNode
    each sends with the preemption reason; each victim hard-killed and
    dropped from the cluster's nodes."""
    import ray_tpu._private.node as jax_node
    import ray_tpu_torch._private.node as port_node

    runs = {}
    for name, rpc, node_mod in (("jax", jax_rpc, jax_node), ("port", port_rpc, port_node)):
        calls, kills = [], []

        class Client:
            def __init__(self, host, port):
                pass

            def call(self, method, **kw):
                calls.append((method, kw["node_id"], kw["reason"], kw["deadline_s"]))
                return {"ok": True}

            def close(self):
                pass

        monkeypatch.setattr(rpc, "RpcClient", Client)
        monkeypatch.setattr(node_mod, "kill_process_tree",
                            lambda proc, force=False: kills.append((proc.pid, force)))
        cluster, _ = _fake_cluster(n_nodes)
        mod = JC if name == "jax" else PC
        inj = mod.PreemptionInjector(cluster, seed=seed, deadline_s=6.0, jitter_s=1.5)
        out = [inj.preempt_one() for _ in range(n_nodes)]
        runs[name] = (out, calls, kills, [n.node_id for n in cluster.nodes])
    assert runs["port"] == runs["jax"]
    out, calls, kills, left = runs["port"]
    assert out[-1] is None and left == ["node0"]  # only the head remains
    assert {c[2] for c in calls} == {"DRAIN_NODE_REASON_PREEMPTION"}
    assert all(4.5 <= c[3] <= 7.5 for c in calls) and all(force for _, force in kills)


# ---------------------------------------------------------------------------
# list_worker_pids on a port node
# ---------------------------------------------------------------------------
def _descendants(pid):
    kids = PC._children_by_parent()
    out, todo = [], list(kids.get(pid, []))
    while todo:
        p = todo.pop()
        out.append(p)
        todo.extend(kids.get(p, []))
    return out


def _is_zygote(pid):
    """The zygote's cmdline names its module; a worker it forked keeps that
    cmdline but carries an ``rtw:`` comm."""
    with open(f"/proc/{pid}/cmdline", "rb") as f:
        cmd = f.read().replace(b"\0", b" ").decode()
    with open(f"/proc/{pid}/comm") as f:
        comm = f.read().strip()
    return "workers.zygote" in cmd and not comm.startswith("rtw:")


def test_list_worker_pids_on_a_port_node():
    with port_cluster({"num_cpus": 3}) as cluster:
        @ray_tpu_torch.remote
        def pid(_):
            time.sleep(0.3)
            return os.getpid()

        task_pids = set(ray_tpu_torch.get([pid.remote(i) for i in range(3)], timeout=120))
        raylet = cluster.nodes[0].proc.pid
        listed = PC.list_worker_pids(raylet)
        zygotes = [p for p in _descendants(raylet) if _is_zygote(p)]
        assert len(zygotes) == 1 and zygotes[0] not in listed
        assert task_pids <= set(listed)
        assert sorted(listed) == sorted(JC.list_worker_pids(raylet))
        # a killed worker leaves the list
        victim = PC.kill_random_worker(cluster, random.Random(0))
        assert victim in listed
        deadline = time.monotonic() + 10
        while victim in PC.list_worker_pids(raylet) and time.monotonic() < deadline:
            time.sleep(0.1)
        assert victim not in PC.list_worker_pids(raylet)
