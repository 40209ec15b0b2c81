"""The local-mode cases of tests/test_torch_runtime.py through both
packages' clusters.

``ray_tpu.init(num_cpus=3)`` and ``ray_tpu_torch.init(num_cpus=3)`` run
side by side (one module-scoped cluster per package). Each case of
``CASES`` runs on JAX's cluster and then on the port's, and both must give
the same outcome: values, exception classes and messages, with package
names and ids normalised. Then ``timeline()`` on each cluster: the same
event kinds with the same fields.
"""

import contextlib
import gc
import re
import time

import pytest

import ray_tpu
import ray_tpu.dag  # noqa: F401 — rt.dag in the cases
import ray_tpu_torch
import ray_tpu_torch.dag  # noqa: F401
from test_torch_runtime import CASES, outcome

PACKAGES = (ray_tpu, ray_tpu_torch)


@contextlib.contextmanager
def collector_paused():
    """The cyclic collector stays paused while JAX's cluster runs, and runs
    between tests (``collect_between_tests``), on the main thread, outside
    every lock. JAX's cluster runtime deadlocks when a collection
    finalizes an ObjectRef inside a locked section on the same thread: in
    its MemoryStore, or in its release pool's ``submit`` (ROADMAP.md
    Queue C). The port's copy is fixed, and tests/test_torch_cluster_gc.py
    holds it with the collector on."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


@pytest.fixture(autouse=True)
def collect_between_tests():
    yield
    gc.collect()


# ids as a cluster prints them: 12 hex digits of an actor id in an
# ActorDiedError, whole ids in a task context
SHORT_ID = re.compile(r"\b[0-9a-f]{12,}\b")


@pytest.fixture(scope="module")
def clusters():
    with collector_paused():
        for rt in PACKAGES:
            rt.init(num_cpus=3)
        warm_up_workers()
        yield
        for rt in PACKAGES:
            rt.shutdown()


def warm_up_workers():
    """A task on each cluster at once: the two zygotes boot (jax's and
    torch's imports) side by side instead of inside the first case."""
    refs = [(rt, rt.remote(lambda: 1).remote()) for rt in PACKAGES]
    assert [rt.get(ref, timeout=120) for rt, ref in refs] == [1, 1]


def normalised(value):
    if isinstance(value, str):
        return SHORT_ID.sub("<id>", value.replace("ray_tpu_torch", "ray_tpu"))
    if isinstance(value, (list, tuple)):
        return type(value)(normalised(v) for v in value)
    if isinstance(value, dict):
        return {k: normalised(v) for k, v in value.items()}
    return value


def run_cluster(rt, fn):
    """The case on ``rt``'s running cluster, its outcome normalised."""
    return normalised(outcome(rt, lambda: fn(rt)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_same_outcome_on_both_clusters(clusters, name):
    ref, port = (run_cluster(rt, CASES[name]) for rt in PACKAGES)
    assert port == ref


def test_timeline_kinds_and_fields(clusters):
    """After a few tasks, ``timeline()`` gives the same kinds of Chrome-trace
    events (queue and task spans) with the same fields on both clusters."""
    def shapes(rt):
        @rt.remote
        def traced(x):
            time.sleep(0.05)
            return x

        assert rt.get([traced.remote(i) for i in range(4)], timeout=60) == list(range(4))
        # events flush on a 1 s cadence from driver and workers: poll
        deadline = time.monotonic() + 20
        spans, events = [], []
        while time.monotonic() < deadline:
            events = [e for e in rt.timeline() if "traced" in e["name"]]
            spans = [e for e in events if e["cat"] == "task"]
            if len(spans) >= 4 and any(e["cat"] == "queue" for e in events):
                break
            time.sleep(0.5)
        assert len(spans) >= 4 and all(e["ph"] == "X" and e["dur"] >= 0 for e in spans)
        return sorted({(e["cat"], e["ph"], tuple(sorted(e)), tuple(sorted(e["args"])),
                        type(e["pid"]).__name__, type(e["tid"]).__name__)
                       for e in events})

    ref, port = (shapes(rt) for rt in PACKAGES)
    assert port == ref
    assert {s[0] for s in port} == {"queue", "task"}
