"""Serve's gRPC ingress (ray_tpu_torch/serve/grpc_proxy.py) held against
JAX's (ray_tpu/serve/grpc_proxy.py) on both packages' clusters.

The cases are those of tests/test_serve_slo.py's TestGrpcParity
(DEADLINE_EXCEEDED, RESOURCE_EXHAUSTED with ``retry-after-s``, NOT_FOUND,
UNAVAILABLE after a stream's partial messages) and
tests/test_serve_grpc_multiplex.py's TestGrpcIngress (unary and
streaming, the multiplexed model id from the metadata), then each payload
mode, pickle refused off loopback and the singleton's ValueError, the
gRPC deadline reaching the replica, idempotent retries around a dead
replica and ``grpc_proxy_stats()``. tests/torch_serve_cases.py runs JAX's
side in a child process with its collector paused while the port's
cluster runs the same cases here; the outcomes must be equal: status
codes, details, trailing metadata and results. A ``debug`` llama
deployment answered over gRPC is tests/test_torch_serve_llm.py's.
"""

import json
import pickle
import threading
import time

import pytest

from torch_serve_cases import TORCH, Reference, port_cluster, registry, run_case

CASES, case = registry()
PICKLE = (("payload", "pickle"),)
JSON = (("payload", "json"),)


def rpc(fn):
    """("ok", fn()), or the RpcError's status code, details and trailing
    metadata."""
    import grpc

    try:
        return ("ok", fn())
    except grpc.RpcError as e:
        return (e.code().name, e.details(), dict(e.trailing_metadata() or ()))


def channel(port):
    import grpc

    return grpc.insecure_channel(f"127.0.0.1:{port}")


# ---- the SLO cases (tests/test_serve_slo.py's TestGrpcParity) ----------------------
@case
def grpc_deadline_exceeded_status(P):
    @P.serve.deployment(name="gslow")
    def gslow(_):
        time.sleep(2.0)
        return b"done"

    P.serve.run(gslow.bind())
    port = P.serve.start_grpc_proxy(port=0)
    with channel(port) as ch:
        t0 = time.monotonic()
        got = rpc(lambda: ch.unary_unary("/gslow/__call__")(b"x", timeout=1.0))
    # the client's deadline and the proxy's abort race: the code, not
    # whose details arrive first
    return got[0], time.monotonic() - t0 < 2.5


@case
def grpc_deadline_reaches_the_replica(P):
    """The client's deadline is the replica's. With none, grpcio reports
    a far one (not None), so the request gets MAX_TIMEOUT_S, not
    DEFAULT_TIMEOUT_S, in both packages."""
    @P.serve.deployment(name="gintrospect")
    def gintrospect(_):
        d = P.serve.request_deadline()
        return None if d is None else d.remaining()

    P.serve.run(gintrospect.bind())
    port = P.serve.start_grpc_proxy(port=0)
    with channel(port) as ch:
        call = ch.unary_unary("/gintrospect/__call__")
        with_deadline = json.loads(call(b"x", timeout=20.0))
        without = json.loads(call(b"x"))
    return (0 < with_deadline <= 20.0,
            P.slo.DEFAULT_TIMEOUT_S < without <= P.slo.MAX_TIMEOUT_S)


@case
def grpc_shed_maps_to_resource_exhausted(P):
    @P.serve.deployment(name="gbusy")
    def gbusy(_):
        time.sleep(1.5)
        return b"ok"

    P.serve.run(gbusy.bind())
    port = P.serve.start_grpc_proxy(port=0, max_inflight=1, max_queue_depth=0)
    first = {}
    with channel(port) as ch:
        call = ch.unary_unary("/gbusy/__call__")
        occupier = threading.Thread(
            target=lambda: first.update(got=rpc(lambda: call(b"a", timeout=30))), daemon=True)
        occupier.start()
        time.sleep(0.5)
        shed = rpc(lambda: call(b"b", timeout=10))
        occupier.join(timeout=30)
    return first["got"], shed, P.serve.grpc_proxy_stats()


@case
def grpc_unknown_deployment_not_found(P):
    port = P.serve.start_grpc_proxy(port=0)
    with channel(port) as ch:
        return (rpc(lambda: ch.unary_unary("/nosuch/__call__")(b"x", timeout=10)),
                rpc(lambda: ch.unary_unary("/too/many/parts")(b"x", timeout=10)))


@case
def grpc_mid_stream_death_maps_to_unavailable(P):
    @P.serve.deployment(name="gstream", num_replicas=1)
    class GStream:
        def gen(self, _):
            for i in range(200):
                time.sleep(0.05)
                yield json.dumps({"i": i})

    P.serve.run(GStream.bind(), name="gstream")
    h = P.serve.get_app_handle("gstream")
    port = P.serve.start_grpc_proxy(port=0)
    got = []

    def read(ch):
        for msg in ch.unary_stream("/gstream/gen")(b"x", timeout=30):
            got.append(msg)
            if len(got) == 3:
                P.rt.kill(h._rs.actors[0])

    with channel(port) as ch:
        code, details, trailing = rpc(lambda: read(ch))
    # the partial messages first, then the status naming the replica's death
    return code, details.split(":")[0], trailing, got[:3], len(got) >= 3


# ---- ingress (tests/test_serve_grpc_multiplex.py's TestGrpcIngress) ------------------
@case
def grpc_unary_and_streaming_in_each_payload_mode(P):
    @P.serve.deployment(name="echo_grpc")
    class Echo:
        def __call__(self, x=None, **kw):
            return {"echo": x, "kw": kw}

        def same(self, data):
            return data

        def text(self, data):
            return data.decode() + "!"

        def tokens(self, n):
            for i in range(int(n)):
                yield f"t{i}"

    P.serve.run(Echo.bind(), name="echo_grpc")
    port = P.serve.start_grpc_proxy(port=0)
    with channel(port) as ch:
        call = ch.unary_unary("/echo_grpc/__call__")
        stream = ch.unary_stream("/echo_grpc/tokens")

        def loads_pickle(data, metadata=PICKLE, method=call):
            return pickle.loads(method(data, metadata=metadata, timeout=30))

        def loads_json(data):
            return json.loads(call(data, metadata=JSON, timeout=30))

        return {
            "pickle": rpc(lambda: loads_pickle(pickle.dumps((("hello",), {"k": 1})))),
            "pickle_not_a_pair": rpc(lambda: loads_pickle(b"plain bytes")),
            "json_object": rpc(lambda: loads_json(b'{"args": ["hi"], "kwargs": {"k": 2}}')),
            "json_array": rpc(lambda: loads_json(b'["a"]')),
            "json_scalar": rpc(lambda: loads_json(b"7")),
            "json_invalid": rpc(lambda: loads_json(b"{nope")),
            "json_bad_args": rpc(lambda: loads_json(b'{"args": 5}')),
            "raw_bytes": rpc(lambda: ch.unary_unary("/echo_grpc/same")(b"\x00\x01", timeout=30)),
            "raw_str": rpc(lambda: ch.unary_unary("/echo_grpc/text")(b"abc", timeout=30)),
            "raw_unencodable": rpc(lambda: call(b"abc", timeout=30)),
            "unknown_mode": rpc(lambda: call(b"x", metadata=(("payload", "yaml"),), timeout=30)),
            "stream_pickle": rpc(lambda: [pickle.loads(m) for m in stream(
                pickle.dumps(((3,), {})), metadata=PICKLE, timeout=30)]),
            "stream_json": rpc(lambda: [json.loads(m) for m in stream(
                b"[2]", metadata=JSON, timeout=30)]),
            "stream_raw": rpc(lambda: list(stream(b"2", timeout=30))),
            "missing": rpc(lambda: loads_pickle(
                pickle.dumps(((1,), {})), method=ch.unary_unary("/NoSuchApp/__call__"))),
        }


@case
def grpc_multiplexed_metadata(P):
    @P.serve.deployment(name="mux_grpc", num_replicas=1)
    class MuxModel:
        def __init__(self):
            self.load_count = 0

        @P.serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id: str):
            self.load_count += 1
            return {"id": model_id, "n": self.load_count}

        def __call__(self, x):
            model = self.get_model(P.serve.get_multiplexed_model_id())
            return {"model": model["id"], "x": x, "loads": self.load_count}

    P.serve.run(MuxModel.bind(), name="mux_grpc")
    port = P.serve.start_grpc_proxy(port=0)
    with channel(port) as ch:
        call = ch.unary_unary("/mux_grpc/__call__")
        return [rpc(lambda m=m: pickle.loads(call(
            pickle.dumps(((5,), {})), timeout=30,
            metadata=(("multiplexed_model_id", m), ("payload", "pickle")))))
            for m in ("mx", "my", "mx", "mz", "mx")]


# ---- safety, retries and stats ------------------------------------------------------
@case
def grpc_pickle_refused_off_loopback(P):
    """A proxy bound beyond loopback refuses pickle unless told otherwise;
    the running singleton refuses a changed ``allow_pickle``."""
    @P.serve.deployment(name="gpk")
    def gpk(x=None):
        return {"x": x}

    P.serve.run(gpk.bind())
    payload = pickle.dumps((("a",), {}))
    out = {}
    for label, kw in (("any_address", {"host": "0.0.0.0"}),
                      ("loopback_without_pickle", {"allow_pickle": False}),
                      ("loopback", {})):
        port = P.serve.start_grpc_proxy(port=0, **kw)
        out[label + "_again_same_port"] = P.serve.start_grpc_proxy(port=0, **kw) == port
        try:
            P.serve.start_grpc_proxy(port=0, allow_pickle=label != "loopback")
            out[label + "_changed"] = "no error"
        except ValueError as e:
            out[label + "_changed"] = str(e)
        with channel(port) as ch:
            call = ch.unary_unary("/gpk/__call__")
            out[label + "_pickle"] = rpc(lambda: pickle.loads(
                call(payload, metadata=PICKLE, timeout=30)))
            out[label + "_json"] = rpc(lambda: json.loads(call(b'["a"]', metadata=JSON, timeout=30)))
        P.serve.stop_grpc_proxy()
    return out


@case
def grpc_idempotent_unary_retries_around_a_dead_replica(P):
    @P.serve.deployment(name="gtwo", num_replicas=2)
    def gtwo(x):
        return b"ok:" + x

    h = P.serve.run(gtwo.bind(), name="gtwo")
    port = P.serve.start_grpc_proxy(port=0)
    with channel(port) as ch:
        call = ch.unary_unary("/gtwo/__call__")
        warm = [rpc(lambda i=i: call(b"%d" % i, timeout=30)) for i in range(4)]
        P.rt.kill(h._rs.actors[0])
        after = [rpc(lambda i=i: call(b"%d" % i, timeout=30)) for i in range(8)]
    return warm, after


@case
def grpc_proxy_stats_count_admissions(P):
    @P.serve.deployment(name="gcount")
    def gcount(x):
        return x

    P.serve.run(gcount.bind())
    before = P.serve.grpc_proxy_stats()
    port = P.serve.start_grpc_proxy(port=0)
    fresh = P.serve.grpc_proxy_stats()
    with channel(port) as ch:
        answers = [rpc(lambda i=i: ch.unary_unary("/gcount/__call__")(b"%d" % i, timeout=30))
                   for i in range(3)]
        rpc(lambda: ch.unary_unary("/nosuch/__call__")(b"x", timeout=10))
    stats = P.serve.grpc_proxy_stats()
    P.serve.stop_grpc_proxy()
    return before, fresh, answers, stats, P.serve.grpc_proxy_stats()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    ref = Reference(__name__, tmp_path_factory.mktemp("jax_serve_grpc"))
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
