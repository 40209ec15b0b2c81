"""The port's actor runtime in cluster mode on one node: a GCS, a raylet,
the shared-memory object store and worker processes, started by
``ray_tpu_torch.init(num_cpus=3)``.

The cases of tests/test_cluster_runtime.py, mirrored on the port's
cluster (one module-scoped cluster, as there), then what the port adds:
torch tensors crossing processes through the store, the worker image's
lease context, and ``shutdown()`` leaving no process of the cluster.
The local-mode cases run through both packages' clusters in
tests/test_torch_cluster_cases.py; the cards' leases, under
``RAY_TPU_FAKE_GPUS``, in tests/test_torch_cluster_gpu.py.
"""

import os
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=3, ignore_reinit_error=True)
    yield ray_tpu_torch._private.worker.global_worker.core
    ray_tpu_torch.shutdown()


# ---- tests/test_cluster_runtime.py, mirrored --------------------------------
def test_task_roundtrip(cluster):
    @ray_tpu_torch.remote
    def add(a, b):
        return a + b

    assert ray_tpu_torch.get(add.remote(1, 2), timeout=60) == 3
    refs = [add.remote(i, i) for i in range(20)]
    assert sum(ray_tpu_torch.get(refs, timeout=60)) == 2 * sum(range(20))


def test_nested_refs_as_args(cluster):
    @ray_tpu_torch.remote
    def add(a, b):
        return a + b

    r = add.remote(add.remote(1, 1), add.remote(2, 2))
    assert ray_tpu_torch.get(r, timeout=60) == 6


def test_big_object_through_shared_memory(cluster):
    x = np.arange(500_000, dtype=np.float64)
    ref = ray_tpu_torch.put(x)
    y = ray_tpu_torch.get(ref, timeout=60)
    assert (x == y).all()

    @ray_tpu_torch.remote
    def total(a):
        return float(a.sum())

    assert ray_tpu_torch.get(total.remote(ref), timeout=60) == float(x.sum())


def test_big_return(cluster):
    @ray_tpu_torch.remote
    def make(n):
        return np.ones(n, dtype=np.float32)

    y = ray_tpu_torch.get(make.remote(400_000), timeout=60)
    assert y.shape == (400_000,)
    assert y.dtype == np.float32


def test_error_propagation(cluster):
    @ray_tpu_torch.remote
    def boom():
        raise ValueError("cluster boom")

    with pytest.raises(ValueError, match="cluster boom"):
        ray_tpu_torch.get(boom.remote(), timeout=60)


def test_actor_lifecycle(cluster):
    @ray_tpu_torch.remote
    class Counter:
        def __init__(self, start=0):
            self.n = start

        def incr(self, by=1):
            self.n += by
            return self.n

    c = Counter.remote(100)
    refs = [c.incr.remote() for _ in range(25)]
    assert ray_tpu_torch.get(refs, timeout=60)[-1] == 125
    # ordering preserved
    assert ray_tpu_torch.get(refs, timeout=60) == list(range(101, 126))


def test_actor_error_and_kill(cluster):
    @ray_tpu_torch.remote
    class Bad:
        def fail(self):
            raise RuntimeError("actor fail")

        def ok(self):
            return 1

    b = Bad.remote()
    with pytest.raises(RuntimeError, match="actor fail"):
        ray_tpu_torch.get(b.fail.remote(), timeout=60)
    # actor still alive after a method error
    assert ray_tpu_torch.get(b.ok.remote(), timeout=60) == 1
    ray_tpu_torch.kill(b)
    time.sleep(0.5)
    with pytest.raises(ray_tpu_torch.exceptions.RayActorError):
        ray_tpu_torch.get(b.ok.remote(), timeout=30)


def test_named_actor_cluster(cluster):
    @ray_tpu_torch.remote
    class Svc:
        def ping(self):
            return "pong"

    Svc.options(name="cluster-svc").remote()
    h = ray_tpu_torch.get_actor("cluster-svc")
    assert ray_tpu_torch.get(h.ping.remote(), timeout=60) == "pong"


def test_wait_cluster(cluster):
    @ray_tpu_torch.remote
    def sleepy(t):
        time.sleep(t)
        return t

    fast = sleepy.remote(0.1)
    slow = sleepy.remote(10.0)
    ready, not_ready = ray_tpu_torch.wait([fast, slow], num_returns=1, timeout=8.0)
    assert ready == [fast]
    assert not_ready == [slow]


def test_nested_task_submission(cluster):
    @ray_tpu_torch.remote
    def inner(x):
        return x * 2

    @ray_tpu_torch.remote
    def outer(x):
        import ray_tpu_torch as rt

        return rt.get(inner.remote(x)) + 1

    assert ray_tpu_torch.get(outer.remote(10), timeout=90) == 21


def test_cluster_resources_visible(cluster):
    res = ray_tpu_torch.cluster_resources()
    assert res["CPU"] == 3.0


def test_actor_restart_after_worker_death(cluster):
    """Regression: calls made after an actor restart must reach the new
    incarnation (the old seqno-window protocol hung forever here)."""

    @ray_tpu_torch.remote(max_restarts=2)
    class Phoenix:
        def __init__(self):
            self.n = 0

        def incr(self):
            self.n += 1
            return self.n

        def pid(self):
            import os

            return os.getpid()

        def die(self):
            import os

            os._exit(1)

    p = Phoenix.remote()
    assert ray_tpu_torch.get(p.incr.remote(), timeout=60) == 1
    old_pid = ray_tpu_torch.get(p.pid.remote(), timeout=60)
    try:
        ray_tpu_torch.get(p.die.remote(), timeout=30)
    except Exception:
        pass  # in-flight task may fail with RayActorError — expected
    # post-restart calls must succeed on a fresh incarnation (state reset)
    deadline = time.monotonic() + 60
    val = None
    while time.monotonic() < deadline:
        try:
            val = ray_tpu_torch.get(p.incr.remote(), timeout=30)
            break
        except ray_tpu_torch.exceptions.RayActorError:
            time.sleep(0.5)  # restart in progress; lost-task failures OK
    assert val == 1, f"expected fresh state after restart, got {val}"
    assert ray_tpu_torch.get(p.pid.remote(), timeout=30) != old_pid


def test_borrow_handoff_claimed_and_unclaimed(cluster):
    """Borrow-interest ledger (reference: reference_counter.h:44 borrower
    handoff): two tasks hand off the SAME worker-owned ref; releasing one
    outer return unclaimed must not unpin the other's handoff, and the
    inner object must stay readable until all interest is gone."""

    @ray_tpu_torch.remote
    def make_inner():
        return ray_tpu_torch.put(np.arange(1000))

    inner_holder = {}

    @ray_tpu_torch.remote
    def wrap(boxed):
        # boxed is a list whose element is an (unresolved) nested ref
        return {"inner": boxed[0]}

    inner = make_inner.remote()
    inner_ref = ray_tpu_torch.get(inner, timeout=60)  # worker-owned ref
    del inner
    outer1 = wrap.remote([inner_ref])
    outer2 = wrap.remote([inner_ref])
    del inner_ref
    time.sleep(0.5)
    # release outer1 WITHOUT deserializing: its handoff interest drops,
    # but outer2 still pins the inner object
    ray_tpu_torch.get(outer2, timeout=60)  # ensure both replies landed
    del outer1
    time.sleep(1.0)
    val = ray_tpu_torch.get(ray_tpu_torch.get(outer2, timeout=60)["inner"], timeout=60)
    assert val.sum() == 499500


# ---- what the port adds -------------------------------------------------------
TENSORS = {
    "fp32": lambda: torch.randn(300, 1000, generator=torch.Generator().manual_seed(0)),
    "bf16": lambda: torch.randn(1000, 300, generator=torch.Generator().manual_seed(1)
                                ).to(torch.bfloat16),
    "int64_small": lambda: torch.arange(12).reshape(3, 4),
    "strided": lambda: torch.arange(200_000.0).reshape(400, 500)[::2, ::3],
    "empty": lambda: torch.empty(0, 7, dtype=torch.bfloat16),
}


@pytest.mark.parametrize("name", sorted(TENSORS))
def test_tensor_through_the_store_and_back(cluster, name):
    t = TENSORS[name]()

    @ray_tpu_torch.remote
    def echo(x, y):
        return {"x": x, "y": y, "kinds": (type(x).__name__, str(x.dtype), x.is_contiguous())}

    ref = ray_tpu_torch.put(t)
    got = ray_tpu_torch.get(echo.remote(ref, t), timeout=60)
    assert got["kinds"] == ("Tensor", str(t.dtype), True)
    for v in (got["x"], got["y"], ray_tpu_torch.get(ref, timeout=60)):
        assert v.dtype == t.dtype and v.shape == t.shape
        assert torch.equal(v.view(torch.uint8) if v.numel() else v,
                           t.contiguous().view(torch.uint8) if t.numel() else t)


def test_lease_context_without_a_card(cluster):
    """A lease that asks for no card sees none (CUDA_VISIBLE_DEVICES=""),
    and its worker never initialized CUDA."""
    @ray_tpu_torch.remote
    def ctx():
        return (os.environ.get("CUDA_VISIBLE_DEVICES"), torch.cuda.is_initialized(),
                ray_tpu_torch.get_runtime_context().get_assigned_resources())

    visible, initialized, assigned = ray_tpu_torch.get(ctx.remote(), timeout=60)
    assert (visible, initialized) == ("", False)
    assert assigned == {"CPU": 1.0, "gpu_ids": []}
    with pytest.raises(ValueError, match="whole cards"):
        ctx.options(num_gpus=0.5).remote()


def test_second_driver_joins_by_address(cluster):
    """``init(address="host:port")`` connects another process to this
    cluster's GCS as a second driver (its own job), sharing the node."""
    import subprocess
    import sys

    host, port = cluster.gcs_addr
    code = ("import ray_tpu_torch as rt; import os; "
            f"info = rt.init(address='{host}:{port}'); "
            "f = rt.remote(lambda x: (x * 2, os.getpid())); "
            "v, pid = rt.get(f.remote(21), timeout=60); "
            "print(v, pid != os.getpid(), rt.cluster_resources()['CPU'], "
            "rt.get_runtime_context().get_job_id()); rt.shutdown()")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=root))
    assert out.returncode == 0, out.stderr[-2000:]
    value, elsewhere, cpus, job = out.stdout.split()[-4:]
    assert (value, elsewhere, cpus) == ("42", "True", "3.0")
    assert job != ray_tpu_torch.get_runtime_context().get_job_id()
    # the second driver's shutdown left this cluster running
    assert ray_tpu_torch.get(ray_tpu_torch.put("still here"), timeout=30) == "still here"


def test_shutdown_leaves_no_process(cluster):
    """Last: ``shutdown()`` ends every process of the cluster (the GCS's
    and the raylet's process groups, which the store daemon, the zygote
    and the workers joined)."""
    node = cluster._node
    groups = {node.gcs_proc.pid, node.raylet_proc.pid}
    members = [p for p in _all_pids() if _pgid(p) in groups]
    assert len(members) >= 5  # gcs, raylet, store, zygote, workers
    t0 = time.monotonic()
    ray_tpu_torch.shutdown()
    assert time.monotonic() - t0 < 15
    assert not ray_tpu_torch.is_initialized()
    assert [p for p in members if _alive(p)] == []
    for g in groups:
        with pytest.raises(ProcessLookupError):
            os.killpg(g, 0)


def _all_pids():
    return [int(p) for p in os.listdir("/proc") if p.isdigit()]


def _pgid(pid):
    try:
        return os.getpgid(pid)
    except ProcessLookupError:
        return None


def _alive(pid):
    """Running, and not a zombie waiting for its reaper."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False
