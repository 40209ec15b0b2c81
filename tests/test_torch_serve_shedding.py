"""The load-shedding and replica-death cases of tests/test_serve_slo.py
through JAX's Serve and the port's (tests/torch_serve_cases.py runs them:
JAX's cluster in a child process with its collector paused, the port's in
this one with the collector on; the outcomes must be equal): 503 with
Retry-After before the first byte, replica saturation as the typed
OverloadedError, the terminal frame of a stream whose replica dies, and a
unary request retried on a surviving replica unless it is not idempotent.
"""

import http.client
import importlib
import json
import os
import tempfile
import threading
import time

import pytest

from torch_serve_cases import TORCH, Reference, port_cluster, post, registry, run_case

CASES, case = registry()


# ---- load shedding -----------------------------------------------------------
@case
def http_503_with_retry_after_before_first_byte(P):
    @P.serve.deployment(name="busy", max_ongoing_requests=4)
    def busy(_):
        time.sleep(1.0)
        return "ok"

    P.serve.run(busy.bind())
    port = P.serve.start_http_proxy(port=0, max_inflight=1, max_queue_depth=0)
    first = []
    occupier = threading.Thread(target=lambda: first.append(
        post(port, "/busy", {"x": 0}, timeout_s=20)), daemon=True)
    occupier.start()
    time.sleep(0.5)  # the only admission slot is now held
    t0 = time.monotonic()
    shed = post(port, "/busy", {"x": 1}, timeout_s=20)
    took = time.monotonic() - t0
    occupier.join(timeout=30)
    stats = P.serve.http_proxy_stats()
    return shed, took < 1.0, first, {k: stats[k] for k in (
        "requests", "ok", "shed", "admission_shed_depth", "admission_admitted")}


@case
def replica_saturation_maps_to_typed_overload(P):
    @P.serve.deployment(name="tiny", num_replicas=1, max_ongoing_requests=1)
    def tiny():
        time.sleep(1.5)
        return "done"

    h = P.serve.run(tiny.bind())
    first = h.remote()
    time.sleep(0.4)
    try:
        h.remote().result(timeout=0.9)
    except P.slo.OverloadedError as e:
        err = (type(e).__name__, isinstance(e, RuntimeError), str(e), e.retry_after_s)
    return err, first.result(timeout=30)


# ---- replica death -----------------------------------------------------------
@case
def mid_stream_death_yields_terminal_frame_no_hang(P):
    @P.serve.deployment(name="streamer", num_replicas=1)
    class Streamer:
        def gen(self, _):
            for i in range(200):
                time.sleep(0.05)
                yield {"i": i}

    P.serve.run(Streamer.bind(), name="streamer")
    h = P.serve.get_app_handle("streamer")
    port = P.serve.start_http_proxy(port=0)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("POST", "/streamer/gen", body=json.dumps({"p": 1}),
                 headers={"Content-Type": "application/json", "x-request-timeout-s": "30"})
    resp = conn.getresponse()
    lines, t0 = [], time.monotonic()
    while time.monotonic() - t0 < 25:
        line = resp.readline()
        if not line:
            break
        if line.strip():
            lines.append(json.loads(line))
            if len(lines) == 3:
                P.rt.kill(h._rs.actors[0])
    conn.close()
    terminal = lines[-1]
    return (resp.status, lines[:3], terminal.get("terminal"), terminal["error"]["code"],
            terminal["error"]["retryable"],
            all(frame == {"i": j} for j, frame in enumerate(lines[:-1])),
            time.monotonic() - t0 < 25)


def flaky_deployment(P, name, marker):
    @P.serve.deployment(name=name, num_replicas=2)
    class Flaky:
        def __call__(self, _):
            import os as _os

            # exactly one replica hard-dies mid-request; the marker file
            # makes the fault one-shot across the fleet
            try:
                fd = _os.open(marker, _os.O_CREAT | _os.O_EXCL | _os.O_WRONLY)
                _os.close(fd)
                _os._exit(1)
            except FileExistsError:
                pass
            return _os.getpid()

    return Flaky


@case
def unary_death_transparent_retry(P):
    marker = os.path.join(tempfile.mkdtemp(), "died_once")
    h = P.serve.run(flaky_deployment(P, "flaky", marker).bind(), name="flaky")
    out = h.options(timeout_s=60).remote({"x": 1}).result(timeout=60)
    return isinstance(out, int), os.path.exists(marker)


@case
def unary_death_no_retry_when_not_idempotent(P):
    marker = os.path.join(tempfile.mkdtemp(), "died_once_nr")
    h = P.serve.run(flaky_deployment(P, "flaky_nr", marker).bind(), name="flaky_nr")
    for _ in range(20):
        resp = h.options(timeout_s=30).remote({"x": 1})
        resp.retry_on_failure = False
        try:
            resp.result(timeout=30)
        except Exception as e:  # noqa: BLE001 — the surfaced death
            # which of the replica-failure types depends on when the death
            # is seen (the call's connection or the actor's state)
            failures = importlib.import_module(P.serve.__name__ + ".deployment").REPLICA_FAILURES
            return "surfaced", isinstance(e, failures)
    return "no failure surfaced"


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    ref = Reference(__name__, tmp_path_factory.mktemp("jax_serve_shedding"))
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
