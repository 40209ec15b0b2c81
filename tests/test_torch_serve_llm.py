"""The slice as a whole at a small size: ``serve_llm`` on both packages'
clusters, on the CPU.

JAX's ``serve_llm`` draws ``debug``'s params in its replica as JAX's engine
does (``T.init_params(cfg, jax.random.key(0))``, fp32). This process draws
the same params, converts them with ``models/convert.py::params_from_jax``
and saves them with the port's ``train.save_state``; the port's
``serve_llm(LLMConfig(params_path=...), device="cpu")`` serves them from a
replica of its cluster. Both deploy a continuous-batching and a
@serve.batch deployment at once and take the same prompts: one call, four
concurrent calls and ``generate_stream`` (whose deltas join to the unary
text); the continuous one answers the same prompts through the gRPC
ingress too, as concurrent unary calls and one server stream. The
tokenizer writes the ids out, so equal texts are equal greedy tokens,
exactly, in fp32 (tests/torch_serve_cases.py runs JAX's side in a child
process with its collector paused). The port's replicas on a fake card
are tests/test_torch_serve_llm_card.py's.
"""

import dataclasses
import functools
import json
import os
import threading

import numpy as np
import pytest

from torch_serve_cases import TORCH, Reference, port_cluster, registry, run_case

CASES, case = registry()
# one length: JAX compiles a program per prompt length and batch size
PROMPTS = ["abc", "p00", "p01", "p02", "p03"]


def ids_tokenizer():
    """ByteTokenizer's encode; decode writes the ids out, so a completion's
    text carries its exact tokens. Defined in a function: its class is
    pickled by value into the replicas."""
    class IdsTokenizer:
        vocab_size = 257
        eos_token_id = 256

        def encode(self, text):
            return list(text.encode("utf-8"))

        def decode(self, ids):
            return " ".join(str(int(i)) for i in ids)

    return IdsTokenizer()


@functools.lru_cache(maxsize=None)
def port_params_path():
    """debug's fp32 params drawn as JAX's engine draws them
    (``T.init_params(cfg, jax.random.key(seed))``, seed 0), converted and
    saved by the port's save_state."""
    import tempfile

    import jax

    from ray_tpu.models import transformer as JT
    from ray_tpu_torch.models.convert import params_from_jax
    from ray_tpu_torch.train import save_state

    jparams = JT.init_params(jax_debug(), jax.random.key(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), port_debug(), "cpu")
    path = os.path.join(tempfile.mkdtemp(), "params")
    save_state(params, path)
    return path


def jax_debug():
    import jax.numpy as jnp

    from ray_tpu.models import transformer as JT

    return JT.config("debug", dtype=jnp.float32, param_dtype=jnp.float32)


def port_debug():
    import torch

    from ray_tpu_torch.models import transformer as T

    return T.config("debug", dtype=torch.float32, param_dtype=torch.float32)


def llm_configs(P):
    """The continuous and the @serve.batch deployments' configs."""
    if P.name == "jax":
        from ray_tpu.llm import LLMConfig, SamplingParams

        base = LLMConfig(model=jax_debug(), max_len=64, seed=0)
    else:
        from ray_tpu_torch.llm import LLMConfig, SamplingParams

        base = LLMConfig(model=port_debug(), max_len=64, seed=0, params_path=port_params_path())
    base = dataclasses.replace(base, tokenizer=ids_tokenizer(), batch_wait_timeout_s=0.2,
                               sampling=SamplingParams(max_tokens=8))
    return [dataclasses.replace(base, name="llm-c"),
            dataclasses.replace(base, name="llm-b", continuous_batching=False)]


def serve_llm(P, config):
    if P.name == "jax":
        from ray_tpu.llm import serve_llm as deploy

        return deploy(config)
    from ray_tpu_torch.llm import serve_llm as deploy

    return deploy(config, device="cpu")


def over_grpc(P, name):
    """The prompts through the gRPC ingress (payload=json) as concurrent
    unary calls, and the first as a server stream of generate_stream."""
    import grpc

    port = P.serve.start_grpc_proxy(port=0)
    args = [json.dumps({"args": [p]}).encode() for p in PROMPTS]
    json_md = (("payload", "json"),)
    with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
        call = ch.unary_unary(f"/{name}/__call__")
        futures = [call.future(a, metadata=json_md, timeout=120) for a in args]
        texts = [json.loads(f.result()) for f in futures]
        deltas = [json.loads(m) for m in ch.unary_stream(f"/{name}/generate_stream")(
            args[0], metadata=json_md, timeout=120)]
    return {"texts": texts, "stream": "".join(deltas),
            "admitted": P.serve.grpc_proxy_stats()["admission_admitted"]}


@case
def serve_llm_continuous_and_batched(P):
    """Both deployments at once, each driven by its own thread (each side's
    replicas draw or load their weights and warm up side by side)."""
    out = {}

    def drive(config):
        h = serve_llm(P, config)
        one = h.remote(PROMPTS[0]).result(timeout=120)
        four = [r.result(timeout=120) for r in [h.remote(p) for p in PROMPTS[1:]]]
        deltas = [P.rt.get(r, timeout=120) for r in h.generate_stream.remote(PROMPTS[0])]
        short = [P.rt.get(r, timeout=120)
                 for r in h.generate_stream.remote(PROMPTS[1], max_tokens=3)]
        stats = h.engine_stats.remote().result(timeout=60)
        out[config.name] = {
            "one": one, "four": four, "stream_joins_to_one": "".join(deltas) == one,
            "deltas": len(deltas), "short": "".join(short),
            "stats": {k: stats[k] for k in ("admitted", "finished", "tokens_out") if k in stats}}
        if config.continuous_batching:
            out[config.name]["grpc"] = over_grpc(P, config.name)

    threads = [threading.Thread(target=drive, args=(c,), daemon=True) for c in llm_configs(P)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=240)
    return dict(sorted(out.items()))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    ref = Reference(__name__, tmp_path_factory.mktemp("jax_serve_llm"))
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
    by_name = ref[1]
    # the texts are the tokens, and the batched path gives the
    # continuous path's completions
    assert by_name["llm-b"]["one"] == by_name["llm-c"]["one"] != ""
    assert by_name["llm-b"]["four"] == by_name["llm-c"]["four"]
    assert all(d["stream_joins_to_one"] for d in by_name.values())
    # over gRPC: the same completions, unary and streamed
    grpc = by_name["llm-c"]["grpc"]
    assert grpc["texts"] == [by_name["llm-c"]["one"]] + by_name["llm-c"]["four"]
    assert grpc["stream"] == grpc["texts"][0] and grpc["admitted"] == len(PROMPTS) + 1
