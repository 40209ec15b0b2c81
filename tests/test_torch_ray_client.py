"""Remote drivers over ``ray://``: JAX's tests/test_ray_client.py cases
through the port's client server (ray_tpu_torch/util/client) on a port
``Cluster``, held against the same cases through JAX's client server on a
JAX ``Cluster``: the same functions and inputs give the same results.

Both remote drivers live in this process at once (each package has its own
global worker); JAX's side runs with the collector paused (ROADMAP.md
Queue C). Each node has 4 CPUs and one card: the port's a fake GPU
(``RAY_TPU_FAKE_GPUS``), JAX's a TPU, so ``cluster_info`` shows ``GPU``
where JAX's shows ``TPU``, and a ``num_gpus=1`` task from a remote driver
leases the card.
"""

import os

import pytest
import torch

import ray_tpu_torch
from front_door_ref import (
    RUNTIMES, both_clusters, client_server_port, spawn_client_server, stop,
)
from ray_tpu._private.rpc import RpcClient as JaxRpcClient
from ray_tpu_torch._private.rpc import RpcClient as PortRpcClient
from test_torch_cluster_cases import collector_paused

RPC = {"jax": JaxRpcClient, "port": PortRpcClient}


@pytest.fixture(scope="module")
def servers():
    """Both client servers, started together; a first task on each side,
    sent together, boots each cluster's first worker."""
    os.environ["RAY_TPU_FAKE_GPUS"] = "1"
    try:
        with both_clusters(num_cpus=4, cards=1) as clusters:
            procs = {side: spawn_client_server(side, c.address) for side, c in clusters.items()}
            try:
                ports = {side: client_server_port(proc) for side, proc in procs.items()}
                with collector_paused():
                    for side, rt in RUNTIMES.items():
                        rt.init(address=f"ray://127.0.0.1:{ports[side]}")
                    try:
                        # a lambda goes by value: the servers cannot import this module
                        refs = [rt.remote(lambda: None).remote() for rt in RUNTIMES.values()]
                        for rt, ref in zip(RUNTIMES.values(), refs):
                            rt.get(ref, timeout=60)
                    finally:
                        for rt in RUNTIMES.values():
                            rt.shutdown()
                yield ports
            finally:
                for proc in procs.values():
                    stop(proc)
    finally:
        os.environ.pop("RAY_TPU_FAKE_GPUS")


@pytest.fixture
def both(servers):
    """Both packages connected as remote drivers; the collector paused."""
    with collector_paused():
        for side, rt in RUNTIMES.items():
            rt.init(address=f"ray://127.0.0.1:{servers[side]}")
        try:
            yield RUNTIMES
        finally:
            for rt in RUNTIMES.values():
                rt.shutdown()


def per_side(case):
    return {side: case(rt) for side, rt in RUNTIMES.items()}


def tasks_put_get_wait(rt):
    @rt.remote
    def add(a, b):
        return a + b

    refs = [add.remote(i, 10) for i in range(5)]
    got = rt.get(refs, timeout=60)
    ready, rest = rt.wait(refs, num_returns=5, timeout=30)
    r = rt.put({"k": [1, 2, 3]})
    return got, len(ready), len(rest), rt.get(r, timeout=30)


def ref_args_resolve_on_server(rt):
    @rt.remote
    def double(x):
        return x * 2

    @rt.remote
    def plus(a, b):
        return a + b

    @rt.remote
    def consume(xs):
        import importlib

        # refs nested inside containers arrive as refs; the task gets them
        # itself, through its own package
        own = importlib.import_module(type(xs[0]).__module__.split(".")[0])
        return sum(own.get(list(xs)))

    a, b = double.remote(3), double.remote(4)
    return rt.get(plus.remote(a, b), timeout=60), rt.get(consume.remote([a, b]), timeout=60)


def actor_lifecycle(rt):
    @rt.remote
    class Counter:
        def __init__(self, start):
            self.n = start

        def incr(self, k=1):
            self.n += k
            return self.n

    c = Counter.remote(100)
    out = [rt.get(c.incr.remote(), timeout=60), rt.get(c.incr.remote(5), timeout=60)]
    rt.kill(c)
    return out


def named_actor(rt):
    @rt.remote
    class Registry:
        def who(self):
            return "registry"

    Registry.options(name="client_reg", lifetime="detached").remote()
    h = rt.get_actor("client_reg")
    out = rt.get(h.who.remote(), timeout=60)
    rt.kill(h)
    return out


def task_error(rt):
    @rt.remote
    def boom():
        raise ValueError("client boom")

    try:
        rt.get(boom.remote(), timeout=60)
    except Exception as e:  # noqa: BLE001 — each package's own error type
        return "client boom" in str(e)
    return None


CASES = {"tasks_put_get_wait": (tasks_put_get_wait, ([10, 11, 12, 13, 14], 5, 0,
                                                     {"k": [1, 2, 3]})),
         "ref_args_resolve_on_server": (ref_args_resolve_on_server, (14, 14)),
         "actors_full_lifecycle": (actor_lifecycle, [101, 106]),
         "named_actor_via_client": (named_actor, "registry"),
         "task_error_propagates": (task_error, True)}


@pytest.mark.parametrize("name", list(CASES))
def test_case_matches_jax(both, name):
    case, want = CASES[name]
    assert per_side(case) == {"jax": want, "port": want}


def test_cluster_info_names_the_card(both):
    """4 CPUs and one node on each side; the card is "GPU" where JAX's is
    "TPU", and a num_gpus=1 task sent by the remote driver (``num_gpus`` in
    its options on the wire) runs with card 0 leased."""
    res = {side: rt.cluster_resources() for side, rt in both.items()}
    assert res["jax"]["CPU"] == res["port"]["CPU"] == 4
    assert res["jax"]["TPU"] == res["port"]["GPU"] == 1
    assert "GPU" not in res["jax"] and "TPU" not in res["port"]
    assert [len(rt.nodes()) for rt in both.values()] == [1, 1]

    @ray_tpu_torch.remote(num_gpus=1)
    def leased():
        import os

        ctx = ray_tpu_torch.get_runtime_context()
        return ctx.get_assigned_resources()["gpu_ids"], os.environ.get("CUDA_VISIBLE_DEVICES")

    assert ray_tpu_torch.get(leased.remote(), timeout=60) == ([0], "0")


def test_tensors_cross_as_host_tensors(both):
    """The port alone (JAX's client carries no torch): a bf16 tensor put by
    the remote driver and a tensor a task returns arrive bit-equal, on the
    CPU, as they do across processes in cluster mode."""
    rt = ray_tpu_torch
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4).bfloat16()
    ref = rt.put(x)

    @rt.remote
    def twice(t):
        return t * 2

    got, doubled = rt.get(ref, timeout=30), rt.get(twice.remote(ref), timeout=60)
    assert got.dtype == torch.bfloat16 and torch.equal(got, x)
    assert doubled.device.type == "cpu" and torch.equal(doubled, x * 2)


def test_disconnect_releases_refs(servers):
    """After a remote driver's shutdown its server no longer serves its refs,
    on both sides."""
    with collector_paused():
        for side, rt in RUNTIMES.items():
            rt.init(address=f"ray://127.0.0.1:{servers[side]}")
            ref_hex = rt.put(list(range(1000))).hex()
            rt.shutdown()
            probe = RPC[side]("127.0.0.1", servers[side])
            try:
                reply = probe.call("GetValues", client_id="someone_else",
                                   ref_hexes=[ref_hex], timeout=10)
            finally:
                probe.close()
            assert "error" in reply, side
