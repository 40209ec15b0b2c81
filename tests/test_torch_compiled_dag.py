"""The port's compiled DAG (ray_tpu_torch/dag_compiled.py) held against the
JAX package's (ray_tpu/dag_compiled.py) on the CPU.

The cases of tests/test_compiled_dag_channels.py (a three-actor pipeline,
multiple outputs and a node's error, a value past the channel's slot, a
list of refs, pipelined executes) are written once as functions of a
package ``rt`` and run on one cluster of each package (module-scoped,
JAX's with the cyclic collector paused, ROADMAP.md Queue C). Actors are
defined inside the cases (pickled by value into the workers). Every
compiled DAG must take the channel path (``_channel_mode``), and the
outcomes must be equal: values, or exception classes and the messages of
their causes. The port alone: the task path's fallback for a local-mode
actor (it runs no ``__ray_call__``) is taken at once (first, before the
clusters start), a bound method of a live actor compiles (the actor
survives ``teardown``), and ``get`` refuses a mix of compiled and plain
refs.
"""

import contextlib
import gc
import re
import time

import pytest

import ray_tpu
import ray_tpu.dag
import ray_tpu_torch
import ray_tpu_torch.dag

PACKAGES = (ray_tpu, ray_tpu_torch)
HEX_ID = re.compile(r"\b[0-9a-f]{12,}\b")


@contextlib.contextmanager
def collector_paused():
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


@pytest.fixture(scope="module")
def clusters():
    with collector_paused():
        for rt in PACKAGES:
            rt.init(num_cpus=4)
        refs = [(rt, rt.remote(lambda: 1).remote()) for rt in PACKAGES]
        assert [rt.get(r, timeout=120) for rt, r in refs] == [1, 1]
        yield
        for rt in PACKAGES:
            rt.shutdown()


def outcome(rt, fn):
    """("ok", value) or the exception's class and message (a task's error
    by its cause, whose text does not name the package's files)."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the outcome is the exception
        cause = getattr(e, "cause", None)
        text = str(cause) if cause is not None else str(e).splitlines()[0]
        return (type(e).__name__, HEX_ID.sub("<id>", text.replace("ray_tpu_torch", "ray_tpu")))


def stage_class(rt):
    @rt.remote
    class Stage:
        def __init__(self, add):
            self.add = add

        def step(self, x):
            return x + self.add

    return Stage


def compiled(dag, **kwargs):
    c = dag.experimental_compile(**kwargs)
    assert c._channel_mode, "channel mode should engage on one node"
    return c


def three_actor_pipeline(rt):
    Stage = stage_class(rt)
    with rt.dag.InputNode() as inp:
        dag = Stage.bind(3).step.bind(Stage.bind(2).step.bind(Stage.bind(1).step.bind(inp)))
    c = compiled(dag)
    try:
        return [rt.get(c.execute(i), timeout=60) for i in range(5)]
    finally:
        c.teardown()


def multi_output(rt):
    @rt.remote
    class Worker:
        def ok(self, x):
            return x * 2

    with rt.dag.InputNode() as inp:
        a, b = Worker.bind(), Worker.bind()
        dag = rt.dag.MultiOutputNode([a.ok.bind(inp), b.ok.bind(inp)])
    c = compiled(dag)
    try:
        return [rt.get(c.execute(x), timeout=60) for x in (4, 5)]
    finally:
        c.teardown()


def node_error(rt):
    """A node's exception reaches get(), again on a second get of the same
    ref, and the loop survives it for the next execute."""
    @rt.remote
    class Worker:
        def ok(self, x):
            return x * 2

        def boom(self, x):
            raise ValueError("dag boom")

    with rt.dag.InputNode() as inp:
        w = Worker.bind()
        dag = w.ok.bind(w.boom.bind(inp))
    c = compiled(dag)
    try:
        ref = c.execute(1)
        first = outcome(rt, lambda: ref.get(timeout=60))
        again = outcome(rt, lambda: ref.get(timeout=5))
        nxt = outcome(rt, lambda: rt.get(c.execute(2), timeout=60))
        return first, again, nxt
    finally:
        c.teardown()


def oversized_value(rt):
    @rt.remote
    class Big:
        def step(self, n):
            return b"x" * n

    with rt.dag.InputNode() as inp:
        dag = Big.bind().step.bind(inp)
    c = compiled(dag, buffer_size_bytes=1 << 16)
    try:
        small = len(rt.get(c.execute(10), timeout=60))
        big = outcome(rt, lambda: rt.get(c.execute(1 << 20), timeout=60))
        after = len(rt.get(c.execute(20), timeout=60))
        return small, big[0], "exceeds channel capacity" in big[1], after
    finally:
        c.teardown()


def list_of_refs(rt):
    Stage = stage_class(rt)
    with rt.dag.InputNode() as inp:
        dag = Stage.bind(1).step.bind(inp)
    c = compiled(dag)
    try:
        return rt.get([c.execute(1), c.execute(2)], timeout=60)
    finally:
        c.teardown()


def pipelined_executes(rt):
    """Two executes in flight; results arrive in order via the cursor."""
    Stage = stage_class(rt)
    with rt.dag.InputNode() as inp:
        dag = Stage.bind(1).step.bind(inp)
    c = compiled(dag)
    try:
        r0, r1 = c.execute(10), c.execute(20)
        return r1.get(timeout=60), r0.get(timeout=60)
    finally:
        c.teardown()


def function_node(rt):
    """A FunctionNode compiles into a dedicated executor actor."""
    @rt.remote
    def double(x):
        return 2 * x

    with rt.dag.InputNode() as inp:
        dag = double.bind(double.bind(inp))
    c = compiled(dag)
    try:
        return [rt.get(c.execute(i), timeout=60) for i in range(3)]
    finally:
        c.teardown()


def test_local_mode_falls_back_to_the_task_path_at_once():
    """Local-mode actors run no ``__ray_call__``, so the exec loops exit at
    once and the compiled DAG takes the task path (``_channel_mode``
    False) without waiting out the handshake's 120 s."""
    rt = ray_tpu_torch
    rt.init(local_mode=True)
    try:
        Stage = stage_class(rt)
        with rt.dag.InputNode() as inp:
            dag = Stage.bind(2).step.bind(inp)
        t0 = time.monotonic()
        c = dag.experimental_compile()
        assert time.monotonic() - t0 < 30
        assert not c._channel_mode
        assert [rt.get(c.execute(i), timeout=60) for i in range(3)] == [2, 3, 4]
        c.teardown()
    finally:
        rt.shutdown()


CASES = [three_actor_pipeline, multi_output, node_error, oversized_value, list_of_refs,
         pipelined_executes, function_node]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_same_outcome_as_jax(clusters, case):
    ref, port = (outcome(rt, lambda rt=rt: case(rt)) for rt in PACKAGES)
    assert ref[0] == "ok", ref
    assert port == ref


def test_bound_method_of_a_live_actor_survives_teardown(clusters):
    """``handle.method.bind(inp)`` (an ActorMethodNode): the exec loop
    holds one of the actor's threads while the DAG lives, other calls go
    on beside it, and ``teardown`` stops the loop and leaves the actor
    alive for its owner."""
    rt = ray_tpu_torch

    @rt.remote(max_concurrency=2)
    class Counter:
        def __init__(self):
            self.n = 0

        def add(self, k):
            self.n += k
            return self.n

        def ping(self):
            return "pong"

    a = Counter.remote()
    try:
        with rt.dag.InputNode() as inp:
            dag = a.add.bind(inp)
        c = compiled(dag)
        try:
            assert [rt.get(c.execute(k), timeout=60) for k in (1, 2, 3)] == [1, 3, 6]
            assert rt.get(a.ping.remote(), timeout=60) == "pong"
        finally:
            c.teardown()
        assert rt.get(a.add.remote(10), timeout=60) == 16
        with pytest.raises(RuntimeError, match="torn down"):
            c.execute(1)
    finally:
        rt.kill(a)


def test_get_refuses_compiled_and_plain_refs_mixed(clusters):
    rt = ray_tpu_torch
    Stage = stage_class(rt)
    with rt.dag.InputNode() as inp:
        dag = Stage.bind(1).step.bind(inp)
    c = compiled(dag)
    try:
        ref = c.execute(1)
        with pytest.raises(TypeError, match="cannot mix"):
            rt.get([ref, rt.put(1)])
        assert rt.get(ref, timeout=60) == 2
    finally:
        c.teardown()
