"""The deadline cases of tests/test_serve_slo.py through JAX's Serve and the
port's, and the SLO building blocks —
``Deadline``, ``AdmissionController``, ``RetryPolicy``, ``error_body``,
``result_within_deadline`` and the error types — against JAX's on the same
inputs without a cluster.

tests/torch_serve_cases.py runs the cluster cases: JAX's cluster in a
child process with its collector paused, the port's in this one with the
collector on; the outcomes must be equal (HTTP statuses, Retry-After, the
structured JSON bodies, exception classes and messages). Its load-shedding
and replica-death cases are tests/test_torch_serve_shedding.py's. The
soak (``scale_bench.bench_serve_soak``) drains one of two nodes and waits
for multi-node (ROADMAP.md Queue A item 10b-ii); the gRPC cases wait for
ROADMAP.md's 'Serve's gRPC ingress'.
"""

import asyncio
import concurrent.futures
import threading
import time

import pytest

from torch_serve_cases import JAX, TORCH, Reference, outcome, port_cluster, post, registry, \
    run_case

CASES, case = registry()


# ---- deadlines -------------------------------------------------------------
@case
def http_deadline_exceeded_is_504_with_structured_body(P):
    @P.serve.deployment(name="slow")
    def slow(_):
        time.sleep(3.0)
        return "done"

    P.serve.run(slow.bind())
    port = P.serve.start_http_proxy(port=0)
    t0 = time.monotonic()
    got = post(port, "/slow", {"x": 1}, timeout_s=1.0)
    stats = P.serve.http_proxy_stats()
    return got, time.monotonic() - t0 < 2.5, stats["deadline_exceeded"]


@case
def handle_timeout_s_option_raises_deadline_error(P):
    @P.serve.deployment(name="slow2")
    def slow2():
        time.sleep(2.0)
        return "done"

    h = P.serve.run(slow2.bind())
    try:
        h.options(timeout_s=0.8).remote().result()
    except P.slo.DeadlineExceededError as e:
        return type(e).__name__, str(e)


@case
def replica_sees_request_deadline(P):
    @P.serve.deployment(name="introspect")
    def introspect():
        d = P.serve.request_deadline()
        return None if d is None else d.remaining()

    h = P.serve.run(introspect.bind())
    remaining = h.options(timeout_s=30.0).remote().result(timeout=30)
    return 0 < remaining <= 30.0, h.remote().result(timeout=30)


@case
def private_methods_unreachable_over_http(P):
    @P.serve.deployment(name="guarded")
    class Guarded:
        def __call__(self, _):
            return "public"

        def _secret(self, _):
            return "private"

    P.serve.run(Guarded.bind(), name="guarded")
    port = P.serve.start_http_proxy(port=0)
    return [post(port, path, {"x": 1}) for path in
            ("/guarded", "/guarded/_secret", "/guarded/__reduce__", "/guarded/__init__")]


@case
def batch_wait_past_deadline_is_504(P):
    @P.serve.deployment(name="batchy", max_ongoing_requests=8)
    class Batchy:
        @P.serve.batch(max_batch_size=64, batch_wait_timeout_s=30.0)
        def predict(self, xs):
            return [x for x in xs]

        def __call__(self, x):
            return self.predict(x)

    P.serve.run(Batchy.bind(), name="batchy")
    port = P.serve.start_http_proxy(port=0)
    status, retry_after, body = post(port, "/batchy", {"x": 1}, timeout_s=1.0)
    # the proxy's wait and the replica's batch wait end at the same
    # deadline: either may report it first, so the message is not compared
    err = body["error"]
    return status, retry_after, err["code"], err["retryable"], \
        err["message"].startswith("request deadline exceeded")


@case
def dead_on_arrival_deadline_rejected_at_replica(P):
    calls = []

    @P.serve.deployment(name="doa")
    def doa():
        calls.append(1)
        return "ran"

    h = P.serve.run(doa.bind())
    first = h.remote().result(timeout=30)
    d = P.slo.Deadline(0.001)
    time.sleep(0.05)
    try:
        h._call("__call__", (), {}, deadline=d).result(timeout=30)
    except P.slo.DeadlineExceededError as e:
        late = str(e)
    stats = P.rt.get(h._rs.actors[0].ongoing_stats.remote(), timeout=30)
    return first, late, stats["deadline_rejects"]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    ref = Reference(__name__, tmp_path_factory.mktemp("jax_serve_slo"))
    yield ref
    ref.close()


@pytest.fixture(scope="module")
def port():
    with port_cluster():
        yield


@pytest.fixture(scope="module")
def clusters(reference, port):
    """Both clusters up: the tests without a cluster ask for it too, so
    the clusters boot while they run."""


# ---- the building blocks, without a cluster ----------------------------------
def both(fn):
    """fn's outcome through each package's slo module."""
    return [outcome(P, lambda: fn(P)) for P in (JAX, TORCH)]


def test_error_types_and_constants(clusters):
    def facts(P):
        s = P.slo
        return ([c.__name__ for c in s.DeadlineExceededError.__mro__],
                [c.__name__ for c in s.OverloadedError.__mro__],
                [c.__name__ for c in s.ReplicasUnavailableError.__mro__],
                s.OverloadedError("x").retry_after_s, s.OverloadedError("x", 3.5).retry_after_s,
                s.DEFAULT_TIMEOUT_S, s.MAX_TIMEOUT_S, s.DEFAULT_MAX_INFLIGHT,
                s.DEFAULT_MAX_QUEUE_DEPTH, s.DEFAULT_QUEUE_WAIT_S,
                s.QUEUE_WAIT_DEADLINE_FRACTION, s.TIMEOUT_HEADER)

    ref, port = both(facts)
    assert ref[0] == "ok" and port == ref


@pytest.mark.parametrize("header", [None, "", "2.5", "0", "-1", "abc", "1e9", "600"])
def test_deadline_from_header(clusters, header):
    def facts(P):
        d = P.slo.Deadline.from_header(header)
        return round(d.remaining()), d.expired(), repr(d)[:19], round(d.queue_budget(2.0), 1)

    ref, port = both(facts)
    assert ref[0] == "ok" and port == ref


def test_deadline_expiry(clusters):
    def facts(P):
        d = P.slo.Deadline(0.01)
        time.sleep(0.03)
        try:
            d.remaining_or_raise()
        except P.slo.DeadlineExceededError as e:
            err = str(e)
        return d.expired(), d.remaining() < 0, d.queue_budget(5.0), err

    ref, port = both(facts)
    assert ref[0] == "ok" and port == ref


def test_request_deadline_outside_a_replica(clusters):
    ref, port = both(lambda P: (P.slo.request_deadline(), P.slo.remaining_or(5.0)))
    assert ref == ("ok", (None, 5.0)) and port == ref


def test_result_within_deadline(clusters):
    def facts(P):
        s = P.slo
        out = [s.result_within_deadline(_done(7))]
        try:  # no request deadline: the plain timeout
            s.result_within_deadline(concurrent.futures.Future(), default_s=0.05)
        except Exception as e:  # noqa: BLE001
            out.append((type(e).__name__, isinstance(e, s.DeadlineExceededError)))
        token = s._request_deadline.set(s.Deadline(0.05))
        try:  # under a request deadline: DeadlineExceededError
            s.result_within_deadline(concurrent.futures.Future())
        except s.DeadlineExceededError as e:
            out.append((type(e).__name__, str(e)))
        finally:
            s._request_deadline.reset(token)
        return out

    ref, port = both(facts)
    assert ref[0] == "ok" and len(ref[1]) == 3 and port == ref


def _done(value):
    f = concurrent.futures.Future()
    f.set_result(value)
    return f


def test_admission_controller_shed_and_fifo(clusters):
    def facts(P):
        s = P.slo
        ac = s.AdmissionController(max_inflight=1, max_queue_depth=0)
        ac.admit(s.Deadline(5))
        try:
            ac.admit(s.Deadline(5))
        except s.OverloadedError as e:
            shed = (str(e), e.retry_after_s)
        ac.release()
        ac.admit(s.Deadline(5))
        ac.release()
        return shed, ac.stats()

    ref, port = both(facts)
    assert ref[0] == "ok" and ref[1][1]["shed_depth"] == 1 and port == ref


def test_admission_queue_wait_hands_off_slot(clusters):
    def facts(P):
        s = P.slo
        ac = s.AdmissionController(max_inflight=1, max_queue_depth=4, queue_wait_s=5.0)
        ac.admit(s.Deadline(10))
        got = []
        t = threading.Thread(target=lambda: (ac.admit(s.Deadline(10)), got.append(1)),
                             daemon=True)
        t.start()
        time.sleep(0.2)
        queued = (list(got), ac.stats()["queued_now"])
        ac.release()
        t.join(timeout=5)
        ac.release()
        return queued, got, ac.stats()

    ref, port = both(facts)
    assert ref[0] == "ok" and ref[1][:2] == (([], 1), [1]) and port == ref


def test_admission_sheds_past_queue_budget_async_and_sync(clusters):
    """A queued request with no slot within its queue-wait budget is shed
    (async for the proxy loop, sync for worker threads); a deadline with
    no budget left is shed without queueing."""
    def facts(P):
        s = P.slo
        ac = s.AdmissionController(max_inflight=1, max_queue_depth=4, queue_wait_s=0.1)
        ac.admit(s.Deadline(10))
        out = []
        for admit in (lambda d: asyncio.run(ac.try_admit(d)), ac.admit):
            try:
                admit(s.Deadline(10))
            except s.OverloadedError as e:
                out.append((str(e), e.retry_after_s))
        d = s.Deadline(0.001)
        time.sleep(0.01)
        try:
            ac.admit(d)
        except s.OverloadedError as e:
            out.append((str(e), e.retry_after_s))
        ac.release()
        asyncio.run(ac.try_admit(s.Deadline(10)))
        ac.release()
        return out, ac.stats()

    ref, port = both(facts)
    assert ref[0] == "ok" and len(ref[1][0]) == 3 and port == ref


@pytest.mark.parametrize("seed", [0, 3])
def test_retry_policy_backoff_sequence(clusters, seed):
    def facts(P):
        pol = P.slo.RetryPolicy(seed=seed)
        return [pol.backoff(a) for a in range(8)], pol.max_attempts

    ref, port = both(facts)
    assert ref[0] == "ok" and port == ref


@pytest.mark.parametrize("kw", [{}, {"retry_after_s": 1.5}, {"terminal": True},
                                {"retry_after_s": 0.25, "terminal": True}])
def test_error_body(clusters, kw):
    ref, port = both(lambda P: P.slo.error_body("overloaded", "too busy", **kw))
    assert ref[0] == "ok" and port == ref


# ---- the cluster cases --------------------------------------------------------
@pytest.mark.parametrize("name", sorted(CASES))
def test_same_outcome_on_both_serves(reference, port, name):
    got = run_case(TORCH, CASES[name])
    ref = reference.outcome(name)
    assert ref[0] == "ok", ref
    assert got == ref
