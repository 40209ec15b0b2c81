"""The cases of tests/test_serve.py through JAX's Serve and the port's (tests/torch_serve_cases.py runs them:
JAX's cluster in a child process with its collector paused, the port's in
this one with the collector on; the outcomes must be equal).

Function and class deployments, multi-replica routing, ``.options``,
``get_app_handle`` and ``delete``, error propagation, @serve.batch in a
replica and on a free function, the HTTP round trip and replica-side
rejection. ``test_jax_model_replica`` is held in
tests/test_torch_serve_local.py, autoscaling and streaming in
tests/test_torch_serve_autoscaling.py.
"""

import threading
import time

import pytest

from torch_serve_cases import TORCH, Reference, port_cluster, post, registry, run_case

CASES, case = registry()


# ---- tests/test_serve.py ---------------------------------------------------
@case
def function_deployment(P):
    @P.serve.deployment
    def doubler(x):
        return x * 2

    h = P.serve.run(doubler.bind())
    return h.remote(21).result(timeout=60), repr(h)


@case
def class_deployment_with_state(P):
    @P.serve.deployment(num_replicas=1)
    class Counter:
        def __init__(self, start):
            self.n = start

        def incr(self, k):
            self.n += k
            return self.n

    h = P.serve.run(Counter.bind(100))
    return [h.incr.remote(5).result(timeout=60) for _ in range(2)]


@case
def multiple_replicas_route(P):
    @P.serve.deployment(num_replicas=2)
    class Who:
        def __init__(self):
            import os

            self.pid = os.getpid()

        def __call__(self, _):
            return self.pid

    h = P.serve.run(Who.bind())
    pids = {h.remote(None).result(timeout=60) for _ in range(20)}
    return len(pids), repr(h)


@case
def options_override(P):
    @P.serve.deployment
    def f(x):
        return x

    d = f.options(name="custom", num_replicas=1)
    h = P.serve.run(d.bind())
    try:
        f.options(replicas=2)
    except ValueError as e:
        bad = str(e)
    return h.remote(7).result(timeout=60), d.name, P.serve.status(), bad


@case
def get_app_handle_and_delete(P):
    @P.serve.deployment(name="app1")
    def f(x):
        return x + 1

    P.serve.run(f.bind())
    h = P.serve.get_app_handle("app1")
    first = h.remote(1).result(timeout=60)
    P.serve.delete("app1")
    try:
        P.serve.get_app_handle("app1")
    except ValueError as e:
        return first, "ValueError", str(e)


@case
def error_propagates(P):
    @P.serve.deployment
    def bad(x):
        raise ValueError("boom")

    h = P.serve.run(bad.bind())
    try:
        h.remote(1).result(timeout=60)
    except Exception as e:  # noqa: BLE001
        return type(e).__name__, isinstance(e, ValueError), str(e.cause)


@case
def batch_collects_concurrent_calls(P):
    @P.serve.deployment(max_ongoing_requests=16)
    class Model:
        @P.serve.batch(max_batch_size=8, batch_wait_timeout_s=0.2)
        def predict(self, xs):
            return [(x, len(xs)) for x in xs]

    h = P.serve.run(Model.bind())
    results = []
    threads = [threading.Thread(target=lambda i=i: results.append(h.predict.remote(i).result(
        timeout=60)), daemon=True) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return sorted(r[0] for r in results), max(r[1] for r in results) > 1, \
        all(r[1] <= 8 for r in results)


@case
def batch_free_function(P):
    calls = []

    @P.serve.batch(max_batch_size=4, batch_wait_timeout_s=0.1)
    def predict(xs):
        calls.append(len(xs))
        return [x * 10 for x in xs]

    outs = []
    threads = [threading.Thread(target=lambda i=i: outs.append(predict(i)), daemon=True)
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    @P.serve.batch(max_batch_size=2)
    def short(xs):
        return []

    try:
        short(1)
    except ValueError as e:
        short_err = str(e)
    return sorted(outs), sum(calls), short_err


@case
def http_roundtrip(P):
    @P.serve.deployment(name="adder")
    def adder(payload):
        return payload["a"] + payload["b"]

    P.serve.run(adder.bind())
    port = P.serve.start_http_proxy(port=0)
    out = post(port, "/adder", {"a": 2, "b": 3})
    stats = P.serve.http_proxy_stats()
    return out, {k: stats[k] for k in ("requests", "ok", "admission_admitted")}


@case
def two_handles_never_exceed_replica_cap(P):
    @P.serve.deployment(name="capped", num_replicas=2, max_ongoing_requests=2)
    class Slow:
        def __call__(self, x):
            time.sleep(0.2)
            return x

    P.serve.run(Slow.bind(), name="capped")
    h1, h2 = P.serve.get_app_handle("capped"), P.serve.get_app_handle("capped")
    results, errors = [], []

    def fire(handle, val):
        try:
            results.append(handle.remote(val).result(timeout=120))
        except Exception as e:  # noqa: BLE001
            errors.append(repr(e))

    threads = [threading.Thread(target=fire, args=(h, i), daemon=True)
               for i in range(8) for h in (h1, h2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    stats = [P.rt.get(a.ongoing_stats.remote(), timeout=30) for a in h1._rs.actors]
    return errors, sorted(results), [(s["peak"] <= s["max"], s["ongoing"], s["max"])
                                     for s in stats]


@case
def rejection_raises_when_saturated_past_deadline(P):
    @P.serve.deployment(name="tiny_cap", num_replicas=1, max_ongoing_requests=1)
    class Busy:
        def __call__(self):
            time.sleep(2.0)
            return "done"

    P.serve.run(Busy.bind(), name="tiny_cap")
    first = P.serve.get_app_handle("tiny_cap").remote()
    time.sleep(0.5)  # the first request occupies the only slot
    try:
        P.serve.get_app_handle("tiny_cap").remote().result(timeout=1.2)
    except RuntimeError as e:
        err = (type(e).__name__, isinstance(e, P.slo.OverloadedError), str(e), e.retry_after_s)
    return err, first.result(timeout=90)


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
