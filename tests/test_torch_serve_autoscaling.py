"""The cases of tests/test_serve_autoscaling.py through JAX's Serve and the
port's (tests/torch_serve_cases.py runs them: JAX's cluster in a child
process with its collector paused, the port's in this one with the
collector on; the outcomes must be equal): autoscaling up and down from
the handles' metrics, a streaming handle, an async callable, and the HTTP
proxy's unary, chunked-streaming and 404 responses.
"""

import threading
import time

import pytest

from torch_serve_cases import TORCH, Reference, port_cluster, post, post_stream, registry, \
    run_case

CASES, case = registry()


def replica_count(P, name):
    from_ctl = P.serve.controller._controller()
    snap = P.rt.get(from_ctl.get_deployment.remote(name), timeout=30)
    return len(snap["replicas"]) if snap else 0


@case
def autoscales_up_and_down(P):
    @P.serve.deployment(max_ongoing_requests=2, autoscaling_config={
        "min_replicas": 1, "max_replicas": 4, "target_ongoing_requests": 2,
        "upscale_delay_s": 0.2, "downscale_delay_s": 1.0})
    class Slow:
        def __call__(self, _):
            time.sleep(0.4)
            return 1

    h = P.serve.run(Slow.bind())
    initial = replica_count(P, "Slow")
    stop, done = threading.Event(), []

    def pump():
        while not stop.is_set():
            rs = [h.remote(None) for _ in range(16)]
            done.extend(r.result(timeout=60) for r in rs)

    t = threading.Thread(target=pump, daemon=True)
    t.start()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and replica_count(P, "Slow") < 4:
        time.sleep(0.1)
    scaled_up = replica_count(P, "Slow")
    stop.set()
    t.join(timeout=60)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and replica_count(P, "Slow") > 1:
        time.sleep(0.1)
    return initial, scaled_up, bool(done) and set(done) == {1}, replica_count(P, "Slow")


@case
def streaming_deployment_handle(P):
    @P.serve.deployment
    class Tokens:
        def generate(self, n):
            for i in range(n):
                yield f"token-{i}"

    h = P.serve.run(Tokens.bind())
    gen = h.generate.remote(5)
    return type(gen).__name__, [P.rt.get(r, timeout=60) for r in gen]


@case
def async_deployment_callable(P):
    @P.serve.deployment
    class AsyncEcho:
        async def __call__(self, x):
            import asyncio

            await asyncio.sleep(0.05)
            return {"echo": x}

    h = P.serve.run(AsyncEcho.bind())
    return h.remote("hi").result(timeout=60)


@case
def http_proxy_basic_and_streaming(P):
    @P.serve.deployment
    def square(x):
        return x * x

    @P.serve.deployment(name="stream")
    def stream(n):
        for i in range(n):
            yield {"i": i}

    P.serve.run(square.bind())
    P.serve.run(stream.bind())
    port = P.serve.start_http_proxy(port=0)
    return post(port, "/square", 7), post_stream(port, "/stream", 4), post(port, "/nope", 1)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    ref = Reference(__name__, tmp_path_factory.mktemp("jax_serve"))
    yield ref
    ref.close()


@pytest.fixture(scope="module")
def port():
    with port_cluster():
        yield


@pytest.mark.parametrize("name", sorted(CASES))
def test_same_outcome_on_both_serves(reference, port, name):
    got = run_case(TORCH, CASES[name])
    ref = reference.outcome(name)
    assert ref[0] == "ok", ref
    assert got == ref
