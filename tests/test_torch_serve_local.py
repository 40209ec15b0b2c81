"""The multiplexing and local-testing-mode cases of
tests/test_serve_grpc_multiplex.py, and tests/test_serve.py's model
replica, through JAX's Serve and the port's.

On both clusters (tests/torch_serve_cases.py: JAX's in a child process
with its collector paused, the port's in this one with the collector on;
the outcomes must be equal): @serve.multiplexed's cache-aware routing over
two replicas and its LRU eviction on one, and a model replica whose
forward runs under @serve.batch (JAX's ``debug`` forward on JAX's side,
the port's on the same fp32 weights on the port's, in place of
``test_jax_model_replica``). Without a cluster, in this process:
``serve.run(..., local_testing_mode=True)`` (calls, generators, async
callables, multiplexed ids, errors) and the per-replica LRU.
"""

import numpy as np
import pytest

from torch_serve_cases import JAX, TORCH, Reference, outcome, port_cluster, registry, run_case

CASES, case = registry()


def mux_model(P, num_replicas, name):
    @P.serve.deployment(name=name, num_replicas=num_replicas)
    class MuxModel:
        def __init__(self):
            self.load_count = 0

        @P.serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id: str):
            self.load_count += 1
            return {"id": model_id, "n": self.load_count}

        def __call__(self, x):
            mid = P.serve.get_multiplexed_model_id()
            model = self.get_model(mid)
            return {"model": model["id"], "x": x, "loads": self.load_count}

        def loads(self):
            return self.load_count

        def tokens(self, n):
            for i in range(n):
                yield (P.serve.get_multiplexed_model_id(), i)

    return MuxModel


@case
def multiplexed_routing_is_cache_aware(P):
    import time

    handle = P.serve.run(mux_model(P, 2, "mux").bind(), name="mux")
    handle.options(multiplexed_model_id="m0").remote(-1).result(timeout=120)
    time.sleep(1.0)  # the handle's long-poll settles on the final replica set
    outs = [handle.options(multiplexed_model_id=f"m{i % 3}").remote(i).result(timeout=120)
            for i in range(12)]
    snap = P.rt.get(P.serve.controller._controller().get_deployment.remote("mux"), timeout=60)
    per_replica = [P.rt.get(a.handle_request.remote("loads", (), {}), timeout=60)
                   for a in snap["replicas"]]
    ids = [sorted(P.rt.get(a.multiplexed_model_ids.remote(), timeout=60))
           for a in snap["replicas"]]
    # each model pinned to one replica: 3 loads (4 if the warm-up's
    # affinity was reset by a replica-set settle); pow-2 alone loads up to 6
    return [o["model"] for o in outs], 3 <= sum(per_replica) <= 4, \
        sorted(m for r in ids for m in r) in (["m0", "m1", "m2"], ["m0", "m0", "m1", "m2"])


@case
def multiplexed_lru_eviction(P):
    handle = P.serve.run(mux_model(P, 1, "mux1").bind(), name="mux1")
    for mid in ["m0", "m1", "m2", "m0"]:
        handle.options(multiplexed_model_id=mid).remote(0).result(timeout=120)
    loads = handle.loads.remote().result(timeout=60)
    hit = handle.options(multiplexed_model_id="m2").remote(1).result(timeout=120)
    stream = handle.options(multiplexed_model_id="m5").tokens.remote(3)
    return loads, hit, [P.rt.get(r, timeout=60) for r in stream]


def debug_params():
    """``debug``'s weights as a numpy tree (fp32, seeded normal x 0.02), in
    the layout both packages' params take."""
    from ray_tpu_torch.models import transformer as T

    rng = np.random.default_rng(0)

    def draw(tree):
        return {k: draw(v) if isinstance(v, dict) else
                (0.02 * rng.standard_normal(v[0])).astype(np.float32) for k, v in tree.items()}

    return draw(T.param_shapes(T.config("debug")))


@case
def model_replica_under_batch(P):
    """tests/test_serve.py's test_jax_model_replica: a model replica whose
    forward runs under @serve.batch; each side runs its own package's
    ``debug`` forward on the same fp32 weights, and the last position's
    argmax of every request must agree."""
    if P.name == "jax":
        @P.serve.deployment(max_ongoing_requests=8)
        class TinyLM:
            def __init__(self, params):
                import functools

                import jax

                jax.config.update("jax_platforms", "cpu")
                import jax.numpy as jnp

                import ray_tpu.models.transformer as T

                self.cfg = T.config("debug", dtype=jnp.float32, param_dtype=jnp.float32)
                self.params = jax.tree.map(jnp.asarray, params)
                self.fwd = jax.jit(functools.partial(T.forward, self.cfg))

            @P.serve.batch(max_batch_size=4, batch_wait_timeout_s=0.2)
            def predict(self, token_lists):
                import jax.numpy as jnp
                import numpy as np

                logits = self.fwd(self.params, jnp.asarray(np.stack(token_lists)))
                return [(int(np.asarray(l[-1]).argmax()), len(token_lists)) for l in logits]
    else:
        @P.serve.deployment(max_ongoing_requests=8)
        class TinyLM:
            def __init__(self, params):
                import torch

                from ray_tpu_torch.models import transformer as T
                from ray_tpu_torch.models.convert import params_from_jax

                self.cfg = T.config("debug", dtype=torch.float32, param_dtype=torch.float32)
                self.params = params_from_jax(params, self.cfg, "cpu")

            @P.serve.batch(max_batch_size=4, batch_wait_timeout_s=0.2)
            def predict(self, token_lists):
                import numpy as np
                import torch

                from ray_tpu_torch.models import transformer as T

                with torch.no_grad():
                    logits = T.forward(self.cfg, self.params,
                                       torch.from_numpy(np.stack(token_lists)).long())
                return [(int(l[-1].argmax()), len(token_lists)) for l in logits]

    h = P.serve.run(TinyLM.bind(debug_params()))
    rng = np.random.default_rng(0)
    tokens = [rng.integers(0, 256, 16).astype(np.int32) for _ in range(4)]
    resps = [h.predict.remote(t) for t in tokens]
    outs = [r.result(timeout=120) for r in resps]
    return [o[0] for o in outs], all(1 <= o[1] <= 4 for o in outs)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    ref = Reference(__name__, tmp_path_factory.mktemp("jax_serve_local"))
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


# ---- local testing mode and the LRU, without a cluster ---------------------
def both(fn):
    return [outcome(P, lambda: fn(P)) for P in (JAX, TORCH)]


def test_local_testing_mode_no_cluster_needed(clusters):
    def facts(P):
        @P.serve.deployment
        class Adder:
            def __init__(self, base):
                self.base = base

            def __call__(self, x):
                return self.base + x

            def tokens(self, n):
                for i in range(n):
                    yield i

            async def later(self, x):
                import asyncio

                await asyncio.sleep(0.01)
                return x * 3

            def fails(self):
                raise KeyError("nope")

        handle = P.serve.run(Adder.bind(10), local_testing_mode=True)
        try:
            handle.fails.remote().result(timeout=30)
        except KeyError as e:
            err = repr(e)
        return (type(handle).__name__, handle.remote(5).result(timeout=30),
                list(handle.tokens.remote(3)), handle.later.remote(2).result(timeout=30), err)

    ref, port = both(facts)
    assert ref == ("ok", ("LocalDeploymentHandle", 15, [0, 1, 2], 6, "KeyError('nope')"))
    assert port == ref


def test_multiplexed_locally(clusters):
    def facts(P):
        handle = P.serve.run(mux_model(P, 1, "lmux").bind(), local_testing_mode=True)
        out = handle.options(multiplexed_model_id="lm").remote(1).result(timeout=30)
        out2 = handle.options(multiplexed_model_id="lm").remote(2).result(timeout=30)
        return out, out2, list(handle.options(multiplexed_model_id="lz").tokens.remote(2))

    ref, port = both(facts)
    assert ref[0] == "ok" and ref[1][1]["loads"] == 1 and port == ref


def test_multiplexed_lru_state():
    """The per-replica LRU on one instance: loads, hits, evictions (with
    the unload hook called), and the ids it holds."""
    def facts(P):
        unloaded = []

        class Model:
            def __init__(self, mid):
                self.mid = mid

            def __serve_multiplex_unload__(self):
                unloaded.append(self.mid)

        class Server:
            @P.serve.multiplexed(max_num_models_per_replica=2)
            def get_model(self, model_id):
                return Model(model_id)

        s = Server()
        got = [s.get_model(m).mid for m in ["a", "b", "a", "c", "b", "a"]]
        from importlib import import_module

        mux = import_module(P.serve.__name__ + ".multiplex")
        return got, unloaded, mux.replica_multiplexed_model_ids(s), \
            P.serve.get_multiplexed_model_id()

    ref, port = both(facts)
    assert ref[0] == "ok" and port == ref


# ---- the cluster cases --------------------------------------------------------
@pytest.mark.parametrize("name", sorted(CASES))
def test_same_outcome_on_both_serves(reference, port, name):
    got = run_case(TORCH, CASES[name])
    ref = reference.outcome(name)
    assert ref[0] == "ok", ref
    assert got == ref
