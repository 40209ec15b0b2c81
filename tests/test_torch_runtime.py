"""The port's actor runtime in local mode against ray_tpu's.

Each case of tests/test_basic_api.py, tests/test_dag.py and
tests/test_streaming.py that runs in local mode, and each probe of the
drive recipe, is written once as a function of the package module. It runs
through ``ray_tpu`` and then through ``ray_tpu_torch``, each under its own
``init(local_mode=True)`` / ``shutdown()``, and both must give the same
outcome: values, exception classes and messages (the package's name and
random ids aside), ``wait``'s split and the order of actor calls.
"""

import re
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.dag  # noqa: F401 — rt.dag in the cases
import ray_tpu_torch
import ray_tpu_torch.dag  # noqa: F401
from ray_tpu_torch.llm import ContinuousLLMEngine, LLMConfig, LLMEngine, SamplingParams

PACKAGES = (ray_tpu, ray_tpu_torch)
HEX_ID = re.compile(r"[0-9a-f]{16,}")
CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def outcome(rt, fn):
    """("ok", value), or the exception's class name, whether it is one of
    the package's own errors, and its message with the package's name and
    ids normalised. A task's error is compared by its cause: the
    traceback names each package's files."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the outcome is the exception
        msg = str(e.cause) if isinstance(e, rt.exceptions.RayTaskError) else str(e)
        msg = HEX_ID.sub("<id>", msg.replace("ray_tpu_torch", "ray_tpu"))
        return (type(e).__name__, isinstance(e, rt.exceptions.RayTpuError), msg)


def run_local(rt, fn):
    rt.init(local_mode=True)
    try:
        return fn(rt)
    finally:
        rt.shutdown()


def local_mode(rt):
    """Whether ``rt`` runs in local mode (the cases run on both packages'
    clusters too: tests/test_torch_cluster_cases.py)."""
    return rt._private.worker.global_worker.mode == rt._private.worker.LOCAL_MODE


# ---- tests/test_basic_api.py ---------------------------------------------
@case
def put_get(rt):
    one = rt.get(rt.put({"a": 1}))
    many = rt.get([rt.put(i) for i in range(10)])
    assert one == {"a": 1} and many == list(range(10))
    return one, many


@case
def task_submit(rt):
    @rt.remote
    def add(a, b):
        return a + b

    direct = rt.get(add.remote(1, 2))
    chained = rt.get(add.remote(add.remote(1, 1), add.remote(2, 2)))
    assert (direct, chained) == (3, 6)
    return direct, chained


@case
def task_multiple_returns(rt):
    @rt.remote(num_returns=3)
    def three():
        return 1, 2, 3

    refs = three.remote()
    assert len(refs) == 3
    return rt.get(refs)


@case
def task_error_propagates(rt):
    @rt.remote
    def boom():
        raise ValueError("boom!")

    ref = boom.remote()
    with pytest.raises(ValueError, match="boom!"):
        rt.get(ref)
    return outcome(rt, lambda: rt.get(ref))


@case
def get_timeout(rt):
    @rt.remote
    def slow():
        time.sleep(1.0)
        return 1

    ref = slow.remote()
    got = outcome(rt, lambda: rt.get(ref, timeout=0.1))
    assert got[0] == "GetTimeoutError"
    return got, rt.get(ref, timeout=30)


@case
def wait_split(rt):
    @rt.remote
    def sleepy(t):
        time.sleep(t)
        return t

    fast = sleepy.remote(0.01)
    slow = sleepy.remote(1.5)
    ready, not_ready = rt.wait([fast, slow], num_returns=1, timeout=0.75)
    split = (ready == [fast], not_ready == [slow])
    assert split == (True, True)
    return split


@case
def actor_basic(rt):
    @rt.remote
    class Counter:
        def __init__(self, start=0):
            self.v = start

        def incr(self, by=1):
            self.v += by
            return self.v

        def value(self):
            return self.v

    c = Counter.remote(10)
    got = [rt.get(c.incr.remote()), rt.get(c.incr.remote(5)), rt.get(c.value.remote())]
    assert got == [11, 16, 16]
    return got


@case
def actor_ordering(rt):
    @rt.remote
    class Appender:
        def __init__(self):
            self.log = []

        def add(self, x):
            self.log.append(x)
            return list(self.log)

    a = Appender.remote()
    refs = [a.add.remote(i) for i in range(20)]
    logs = rt.get(refs)
    assert logs[-1] == list(range(20))
    return logs


@case
def named_actor(rt):
    @rt.remote
    class Svc:
        def ping(self):
            return "pong"

    Svc.options(name="svc").remote()
    pong = rt.get(rt.get_actor("svc").ping.remote())
    dup = outcome(rt, lambda: Svc.options(name="svc").remote())
    missing = outcome(rt, lambda: rt.get_actor("nope"))
    assert pong == "pong" and dup[0] == "ValueError" and missing[0] == "ValueError"
    return pong, dup, missing


@case
def kill_actor_then_call(rt):
    @rt.remote
    class A:
        def ping(self):
            return 1

    a = A.remote()
    before = rt.get(a.ping.remote())
    rt.kill(a)
    after = outcome(rt, lambda: rt.get(a.ping.remote()))
    with pytest.raises(rt.exceptions.RayActorError):
        rt.get(a.ping.remote())
    not_a_handle = outcome(rt, lambda: rt.kill("not a handle"))
    return before, after, not_a_handle


@case
def actor_error(rt):
    @rt.remote
    class B:
        def bad(self):
            raise RuntimeError("actor oops")

    ref = B.remote().bad.remote()
    with pytest.raises(RuntimeError, match="actor oops"):
        rt.get(ref)
    return outcome(rt, lambda: rt.get(ref))


@case
def direct_calls_rejected(rt):
    @rt.remote
    def f():
        return 1

    @rt.remote
    class K:
        def m(self):
            return 2

    k = K.remote()
    got = [outcome(rt, f), outcome(rt, K), outcome(rt, k.m), rt.get(k.m.remote())]
    assert [g[0] for g in got[:3]] == ["TypeError"] * 3
    return got


# ---- tests/test_dag.py -----------------------------------------------------
@case
def function_dag(rt):
    @rt.remote
    def a(x):
        return x + 1

    @rt.remote
    def b(x):
        return x * 2

    got = rt.get(b.bind(a.bind(10)).execute())
    assert got == 22
    return got


@case
def input_node(rt):
    @rt.remote
    def double(x):
        return 2 * x

    with rt.dag.InputNode() as inp:
        dag = double.bind(double.bind(inp))
    got = [rt.get(dag.execute(5)), rt.get(dag.execute(7))]
    assert got == [20, 28]
    return got


@case
def actor_dag(rt):
    @rt.remote
    class Adder:
        def __init__(self, base):
            self.base = base

        def add(self, x):
            return self.base + x

    got = rt.get(Adder.bind(100).add.bind(23).execute())
    assert got == 123
    return got


@case
def multi_output_dag(rt):
    @rt.remote
    def inc(x):
        return x + 1

    with rt.dag.InputNode() as inp:
        dag = rt.dag.MultiOutputNode([inc.bind(inp), inc.bind(inc.bind(inp))])
    got = rt.get(dag.execute(1))
    assert got == [2, 3]
    return got


@case
def method_decorator_num_returns(rt):
    @rt.remote
    class M:
        @rt.method(num_returns=2)
        def two(self):
            return 1, 2

    a, b = M.remote().two.remote()
    return rt.get([a, b])


# ---- tests/test_streaming.py ----------------------------------------------
@case
def streaming_generator(rt):
    @rt.remote
    def gen(n):
        for i in range(n):
            yield i * i

    g = gen.remote(5)
    assert isinstance(g, rt.ObjectRefGenerator)
    vals = [rt.get(ref, timeout=30) for ref in g]
    assert vals == [0, 1, 4, 9, 16]
    return vals


@case
def streaming_error(rt):
    @rt.remote
    def gen():
        yield 1
        raise ValueError("stream boom")

    g = gen.remote()
    first = rt.get(next(g), timeout=30)
    with pytest.raises(ValueError, match="stream boom"):
        next(g)
    return first


@case
def streaming_actor_method(rt):
    @rt.remote
    class S:
        def count(self, n):
            yield from range(n)

    return [rt.get(r, timeout=30) for r in S.remote().count.remote(4)]


# ---- the drive recipe's probes ---------------------------------------------
@case
def double_init(rt):
    twice = outcome(rt, lambda: rt.init(local_mode=True))
    ignored = rt.init(local_mode=True, ignore_reinit_error=True)
    assert twice[0] == "RuntimeError" and ignored == {"already_initialized": True}
    return twice, ignored


@case
def bad_option_names(rt):
    def f():
        return 1

    class C:
        pass

    got = [outcome(rt, lambda: rt.remote(num_chips=1)(f)),
           outcome(rt, lambda: rt.remote(max_concurrency=2)(f)),
           outcome(rt, lambda: rt.remote(max_calls=1, bogus=2)(C)),
           outcome(rt, lambda: rt.remote(1)),
           outcome(rt, lambda: rt.remote(num_gpus=1)(3))]
    assert [g[0] for g in got] == ["ValueError"] * 3 + ["TypeError"] * 2
    return got


@case
def put_object_ref(rt):
    return outcome(rt, lambda: rt.put(rt.put(1)))


@case
def wait_num_returns_over_len(rt):
    refs = [rt.put(1)]
    return [outcome(rt, lambda: rt.wait(refs, num_returns=2)),
            outcome(rt, lambda: rt.wait(refs + refs))]


@case
def get_if_exists(rt):
    @rt.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def incr(self):
            self.n += 1
            return self.n

    a = Counter.options(name="c", get_if_exists=True).remote()
    b = Counter.options(name="c", get_if_exists=True).remote()
    got = [rt.get(a.incr.remote()), rt.get(b.incr.remote())]
    assert got == [1, 2]  # one actor behind both handles
    return got


@case
def cancel_queued_task(rt):
    """Every thread of the task pool (64) is held, so the task to cancel
    is still queued when it is cancelled."""
    release = threading.Event()

    @rt.remote
    def hold():
        return release.wait(30)

    @rt.remote
    def target():
        return "ran"

    held = [hold.remote() for _ in range(64)]
    ref = target.remote()
    rt.cancel(ref)
    release.set()
    assert rt.get(held) == [True] * 64
    got = outcome(rt, lambda: rt.get(ref, timeout=30))
    assert got[0] == "TaskCancelledError"
    return got


@case
def actor_init_raises(rt):
    @rt.remote
    class Bad:
        def __init__(self):
            raise ValueError("bad init")

        def m(self):
            return 1

    got = outcome(rt, lambda: rt.get(Bad.remote().m.remote()))
    assert got[0] == "RayActorError"
    return got


@case
def actor_constructor_refs(rt):
    """Local mode hands an actor's constructor its ObjectRefs as refs; the
    cluster runtime resolves them (JAX's default_worker.py:868, as Ray
    does; ROADMAP.md Queue C)."""
    @rt.remote
    class Holder:
        def __init__(self, ref, named=None):
            self.kinds = (type(ref).__name__, type(named).__name__)
            self.got = tuple(rt.get(r) if isinstance(r, rt.ObjectRef) else r
                             for r in (ref, named))

        def read(self):
            return self.kinds, self.got

    got = rt.get(Holder.remote(rt.put(3), named=rt.put("n")).read.remote())
    kinds = ("ObjectRef", "ObjectRef") if local_mode(rt) else ("int", "str")
    assert got == (kinds, (3, "n"))
    return got


@case
def runtime_context(rt):
    def ctx():
        c = rt.get_runtime_context()
        node = c.get_node_id()
        # JAX's local mode gives the NodeID itself, the port its hex
        # (ROADMAP.md Queue C, not a port fault); both clusters the hex
        node = node if isinstance(node, str) else node.hex()
        return (c.get_task_id(), c.get_actor_id(), c.get_job_id(),
                node == rt.nodes()[0]["NodeID"])

    @rt.remote
    def in_task():
        return ctx()

    @rt.remote
    class InActor:
        def read(self):
            return ctx()

    got = rt.get(in_task.remote()), rt.get(InActor.remote().read.remote()), ctx()
    assert all(g[3] for g in got)
    return got


@case
def multiple_returns_mismatch(rt):
    @rt.remote(num_returns=2)
    def three():
        return 1, 2, 3

    a, _ = three.remote()
    return outcome(rt, lambda: rt.get(a))


@case
def nodes_and_resources(rt):
    n = rt.nodes()
    assert len(n) == 1 and n[0]["Alive"]
    res = rt.cluster_resources()
    # a cluster's available resources lag its leases (a warm lease holds
    # its CPU for a moment after the task): equal in local mode only
    if local_mode(rt):
        assert rt.available_resources() == res
    # the accelerator key is each package's own (TPU, GPU): compared apart
    return res["CPU"], rt.is_initialized(), sorted(n[0])


@pytest.mark.parametrize("name", sorted(CASES))
def test_same_outcome_as_ray_tpu(name):
    ref, port = (run_local(rt, CASES[name]) for rt in PACKAGES)
    assert port == ref


def test_api_before_init():
    for rt in PACKAGES:
        assert not rt.is_initialized()
    got = [outcome(rt, lambda: rt.put(1)) for rt in PACKAGES]
    # JAX's message also names an auto-init variable that exists nowhere
    assert got[1] == ("RuntimeError", False,
                      "ray_tpu.init() must be called before using the API.")
    assert got[0][:2] == got[1][:2] and got[0][2].startswith(got[1][2][:-1])


# ---- what waits for a later row ---------------------------------------------
def test_cluster_modes_raise_naming_item_10b():
    """Cluster mode on one node came with item 10b (tests/test_torch_cluster*.py);
    what is left of it raises naming the row it waits for: discovering a
    cluster that the CLI started (10b-ii), a remote driver and the
    dashboard (item 12), and a compiled graph (item 9's channels)."""
    rt = ray_tpu_torch
    rows = [({"address": "auto"}, "ROADMAP.md Queue A item 10b-ii, 'multi-node joins, "
                                  "fault paths and the fastpath C codec'"),
            ({"address": "ray://127.0.0.1:10001"}, "ROADMAP.md Queue A item 12, 'util/client'"),
            ({"dashboard": True}, "ROADMAP.md Queue A item 12, 'the dashboard'")]
    for kwargs, row in rows:
        with pytest.raises(NotImplementedError, match=re.escape(row)):
            rt.init(**kwargs)
        assert not rt.is_initialized()
    # timeline() reads a cluster's GCS: local mode has none, in both packages
    got = [run_local(p, lambda p: outcome(p, p.timeline)) for p in PACKAGES]
    assert got[0][0] == got[1][0] == "AttributeError"
    item9 = "ROADMAP.md Queue A item 9, 'experimental/channel.py'"
    rt.init(local_mode=True)
    try:
        @rt.remote
        def f(x):
            return x

        with pytest.raises(NotImplementedError, match=re.escape(item9)):
            f.bind(1).experimental_compile()
        with rt.dag.InputNode() as inp:
            multi = rt.dag.MultiOutputNode([f.bind(inp)])
        with pytest.raises(NotImplementedError, match=re.escape(item9)):
            multi.experimental_compile()
        with pytest.raises(TypeError, match="expects ObjectRef"):
            rt.get([3])
        assert rt.get(f.bind(5).execute()) == 5
    finally:
        rt.shutdown()


# ---- resources --------------------------------------------------------------
def test_fake_gpus_are_advertised(monkeypatch):
    from ray_tpu_torch.accelerators import get_accelerator_manager
    from ray_tpu_torch.accelerators.gpu import FAKE_GPUS_ENV

    monkeypatch.setenv(FAKE_GPUS_ENV, "4")
    assert get_accelerator_manager("GPU").get_current_node_num_accelerators() == 4
    assert run_local(ray_tpu_torch, lambda rt: rt.cluster_resources())["GPU"] == 4
    # JAX's counterpart under conftest's RAY_TPU_FAKE_CHIPS=4
    assert run_local(ray_tpu, lambda rt: rt.cluster_resources())["TPU"] == 4


def test_no_card_no_gpu_key(monkeypatch):
    from ray_tpu_torch.accelerators.gpu import FAKE_GPUS_ENV, NvidiaGPUAcceleratorManager as M

    monkeypatch.delenv(FAKE_GPUS_ENV, raising=False)
    assert not torch.cuda.is_available()
    assert M.get_current_node_num_accelerators() == 0
    assert M.get_current_node_accelerator_type() is None
    res = run_local(ray_tpu_torch, lambda rt: rt.cluster_resources())
    assert res == {"CPU": 8.0}
    explicit = ray_tpu_torch.init(local_mode=True, num_gpus=2, num_cpus=3,
                                  resources={"custom": 1.0})
    try:
        assert explicit["address"] is None
        assert ray_tpu_torch.cluster_resources() == {"CPU": 3.0, "GPU": 2.0, "custom": 1.0}
    finally:
        ray_tpu_torch.shutdown()


def test_gpu_manager_visibility_and_quantity(monkeypatch):
    from ray_tpu_torch.accelerators import get_all_accelerator_managers
    from ray_tpu_torch.accelerators.gpu import NvidiaGPUAcceleratorManager as M

    assert get_all_accelerator_managers() == {"GPU": M}
    assert M.get_resource_name() == "GPU"
    assert M.get_visible_accelerator_ids_env_var() == "CUDA_VISIBLE_DEVICES"
    # set, then deleted: monkeypatch restores the variable's first state
    # even where it was unset (a bare delenv of an unset name records
    # nothing, and the set below then outlived the test)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    assert M.get_current_process_visible_accelerator_ids() is None
    M.set_current_process_visible_accelerator_ids([0, 2])
    assert M.get_current_process_visible_accelerator_ids() == ["0", "2"]
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert M.get_current_process_visible_accelerator_ids() == []
    assert M.validate_resource_request_quantity(2.0) == (True, "")
    assert M.validate_resource_request_quantity(0.5)[0] is False
    assert M.get_current_node_additional_resources() == {}


NORMALIZE_GRID = [
    dict(num_cpus=None, num_gpus=None, resources=None, memory=None),
    dict(num_cpus=0, num_gpus=1, resources=None, memory=None),
    dict(num_cpus=2.5, num_gpus=0.5, resources={"custom": 3}, memory=2**30),
    dict(num_cpus=None, num_gpus=4, resources={"GPU": 1, "x": 0}, memory=0),
    dict(num_cpus=1, num_gpus=None, resources={"CPU": 7}, memory=None),
]


@pytest.mark.parametrize("kw", NORMALIZE_GRID)
@pytest.mark.parametrize("num_tpus", [None, 2])
def test_normalize_resources_matches(kw, num_tpus):
    from ray_tpu._private.core import normalize_resources as jax_norm
    from ray_tpu_torch._private.core import normalize_resources as port_norm

    args = (kw["num_cpus"], kw["num_gpus"], num_tpus, kw["resources"], kw["memory"])
    for default_cpus in (1.0, 0.0):
        assert port_norm(*args, default_cpus=default_cpus) == \
            jax_norm(*args, default_cpus=default_cpus)


def test_option_names_match():
    assert ray_tpu_torch._ALLOWED_TASK_OPTIONS == ray_tpu._ALLOWED_TASK_OPTIONS
    assert ray_tpu_torch._ALLOWED_ACTOR_OPTIONS == ray_tpu._ALLOWED_ACTOR_OPTIONS
    names = set(ray_tpu.__all__) - {"tpu_profile", "start_tpu_profile", "stop_tpu_profile"}
    assert names | {"default_device", "gpu_profile", "start_gpu_profile",
                    "stop_gpu_profile"} == set(ray_tpu_torch.__all__)
    assert all(hasattr(ray_tpu_torch, n) for n in ray_tpu_torch.__all__)


def test_exception_classes_match():
    import ray_tpu.exceptions as J
    import ray_tpu_torch.exceptions as P

    for name in dir(J):
        cls = getattr(J, name)
        if isinstance(cls, type) and issubclass(cls, Exception) and cls.__module__ == J.__name__:
            port = getattr(P, name)
            assert [c.__name__ for c in port.__mro__] == [c.__name__ for c in cls.__mro__]
    err = P.RayTaskError("f", "tb", KeyError("k")).as_instanceof_cause()
    assert isinstance(err, KeyError) and type(err).__name__ == "RayTaskError(KeyError)"
    assert str(P.RayActorError()) == str(J.RayActorError())


# ---- objects: local mode copies nothing --------------------------------------
def test_object_identity():
    t = torch.arange(6.0).reshape(2, 3)
    made = []

    def port_case(rt):
        @rt.remote
        def make():
            made.append(torch.ones(3))
            return made[-1]

        @rt.remote
        def ident(x):
            return x

        return rt.get(rt.put(t)), rt.get(make.remote()), rt.get(ident.remote(rt.put(t)))

    got, returned, passed = run_local(ray_tpu_torch, port_case)
    assert got is t and returned is made[0] and passed is t
    x = jnp.arange(6.0)
    assert run_local(ray_tpu, lambda rt: rt.get(rt.put(x))) is x


# ---- an LLM engine in an actor, on the CPU ----------------------------------
class ServedModel:
    """The chip run's actor at the debug config: an LLMEngine and a
    ContinuousLLMEngine over the params resolved from an ObjectRef."""

    def __init__(self, config, params_ref):
        params = ray_tpu_torch.get(params_ref)
        self.engine = LLMEngine(config, params=params, device="cpu")
        self.cengine = ContinuousLLMEngine(config, params=params, device="cpu")

    def data_ptrs(self):
        return [[t.data_ptr() for t in leaves(p)] for p in
                (self.engine.generator.params, self.cengine.batcher.params)]

    def generate_tokens(self, ids):
        return self.engine.generate_tokens(ids)

    def submit(self, prompt):
        return self.cengine.submit(prompt).result(timeout=60)

    def stats(self):
        return dict(self.cengine.batcher.stats)

    def stream(self, ids, sampling):
        yield from self.engine.generator.generate_stream(ids, sampling)

    def close(self):
        self.cengine.shutdown()


def leaves(tree):
    for v in tree.values():
        yield from (leaves(v) if isinstance(v, dict) else [v])


def test_llm_engine_in_an_actor_matches_direct():
    sampling = SamplingParams(max_tokens=6)
    config = LLMConfig(model="debug", max_len=64, sampling=sampling, seed=3, cache_slots=4)
    engine = LLMEngine(config, device="cpu")
    params = engine.generator.params
    rng = np.random.default_rng(0)
    ids = [rng.integers(0, 256, n).tolist() for n in (5, 11, 17)]
    prompts = ["ab", "hello", "xyz!", "q"]
    direct = engine.generate_tokens(ids)
    direct_stream = list(engine.generator.generate_stream(ids[0], sampling))
    cengine = ContinuousLLMEngine(config, params=params, device="cpu")
    try:
        direct_texts = [cengine.submit(p).result(timeout=60) for p in prompts]
    finally:
        cengine.shutdown()

    rt = ray_tpu_torch
    rt.init(local_mode=True)
    try:
        served = rt.remote(num_gpus=1, max_concurrency=4)(ServedModel).remote(
            config, rt.put(params))
        ptrs = rt.get(served.data_ptrs.remote())
        assert ptrs[0] == ptrs[1] == [t.data_ptr() for t in leaves(params)]
        assert rt.get(served.generate_tokens.remote(ids)) == direct
        texts = rt.get([served.submit.remote(p) for p in prompts], timeout=120)
        assert texts == direct_texts
        assert rt.get(served.stats.remote())["finished"] == len(prompts)
        gen = served.stream.remote(ids[0], sampling)
        assert isinstance(gen, rt.ObjectRefGenerator)
        assert [rt.get(r) for r in gen] == direct_stream
        with pytest.raises(ValueError, match="max_len") as err:
            rt.get(served.generate_tokens.remote([[1] * 70]))
        assert isinstance(err.value, rt.exceptions.RayTaskError)
        rt.get(served.close.remote())
        rt.kill(served)
    finally:
        rt.shutdown()


# ---- profiling ----------------------------------------------------------------
def test_gpu_profile_writes_a_trace(tmp_path):
    rt = ray_tpu_torch
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rt.start_gpu_profile(str(tmp_path))
    assert rt.stop_gpu_profile() is None
    with rt.gpu_profile(str(tmp_path / "t"), device="cpu") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof.path.startswith(str(tmp_path / "t")) and "mm" in open(prof.path).read()
