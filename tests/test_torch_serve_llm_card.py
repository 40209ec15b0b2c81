"""Serve's LLM replicas on the port's cluster with one fake card
(``RAY_TPU_FAKE_GPUS=1``; nothing calls CUDA), at ``debug`` in fp32 on the
CPU, with weights the engine draws from the config's seed.

``LLMConfig.resources={"GPU": 1}`` pins the replica to the card as
``num_gpus=1`` does; a replica that cannot reach a card fails its deploy
(no fallback to the CPU); with continuous batching a request past its
deadline gives its KV slot back; the @serve.batch replica reports its
batches. tests/test_torch_serve_llm.py holds ``serve_llm`` against JAX's.
"""

import dataclasses
import os
import time

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.accelerators.gpu import FAKE_GPUS_ENV
from ray_tpu_torch.llm import LLMConfig, SamplingParams, serve_llm
from ray_tpu_torch.models import transformer as T

PROMPTS = ["abc", "p00", "p01", "p02", "p03"]
DEBUG = T.config("debug", dtype=torch.float32, param_dtype=torch.float32)


class IdsTokenizer:
    """Decode writes the ids out: a completion's text carries its tokens."""

    vocab_size = 257
    eos_token_id = 256

    def encode(self, text):
        return list(text.encode("utf-8"))

    def decode(self, ids):
        return " ".join(str(int(i)) for i in ids)


CONFIG = LLMConfig(model=DEBUG, max_len=64, seed=0, tokenizer=IdsTokenizer(), name="llm-c",
                   batch_wait_timeout_s=0.2, sampling=SamplingParams(max_tokens=8))


@pytest.fixture(scope="module")
def port():
    """The port's cluster with one fake card."""
    before = {k: os.environ.pop(k, None) for k in (FAKE_GPUS_ENV, "CUDA_VISIBLE_DEVICES")}
    os.environ[FAKE_GPUS_ENV] = "1"
    try:
        ray_tpu_torch.init(num_cpus=4)
    finally:
        os.environ.pop(FAKE_GPUS_ENV)
        os.environ.update({k: v for k, v in before.items() if v is not None})
    yield
    ray_tpu_torch.serve.shutdown()
    ray_tpu_torch.shutdown()


def test_resources_gpu_pins_the_replica_to_the_card(port):
    """``LLMConfig.resources={"GPU": 1}`` leases the cluster's one card as
    ``num_gpus=1`` does: the replica's process sees it in
    ``CUDA_VISIBLE_DEVICES`` and its lease, while the engine runs on the
    device it was given (the CPU here)."""
    config = dataclasses.replace(CONFIG, name="llm-card", resources={"GPU": 1})
    assert ray_tpu_torch.cluster_resources()["GPU"] == 1.0
    h = serve_llm(config, device="cpu")
    try:
        facts = h.replica_stats.remote().result(timeout=60)
        assert facts["visible_devices"] == "0" and facts["gpu_ids"] == [0]
        assert facts["device"] == "cpu" and facts["pid"] != os.getpid()
        assert ray_tpu_torch.available_resources().get("GPU", 0.0) == 0.0
        assert h.remote(PROMPTS[0]).result(timeout=60) != ""
    finally:
        ray_tpu_torch.serve.delete("llm-card")
    deadline = time.monotonic() + 30
    while ray_tpu_torch.available_resources().get("GPU") != 1.0 and time.monotonic() < deadline:
        time.sleep(0.1)
    assert ray_tpu_torch.available_resources().get("GPU") == 1.0


def test_num_gpus_in_actor_options_pins_a_plain_replica(port):
    """``ray_actor_options={"num_gpus": 1}`` leases the card for any
    deployment's replica, as ``resources={"GPU": 1}`` does."""
    @ray_tpu_torch.serve.deployment(name="carded", ray_actor_options={"num_gpus": 1})
    def carded():
        return os.environ["CUDA_VISIBLE_DEVICES"], \
            ray_tpu_torch.get_runtime_context().get_assigned_resources()["gpu_ids"]

    h = ray_tpu_torch.serve.run(carded.bind())
    try:
        assert h.remote().result(timeout=60) == ("0", [0])
    finally:
        ray_tpu_torch.serve.delete("carded")


def test_a_replica_without_a_card_fails_its_deploy(port):
    """device=None is the card of the replica's process: a replica that has
    none (the card here is fake) raises in its constructor, and the deploy
    fails with that error; nothing falls back to the CPU."""
    config = dataclasses.replace(CONFIG, name="llm-nocard", resources={"GPU": 1})
    with pytest.raises(Exception) as err:
        serve_llm(config)
    assert "runs on a CUDA device and none is available" in str(err.value)
    assert "llm-nocard" not in ray_tpu_torch.serve.status()["deployments"]


def test_deadline_expiry_gives_the_slot_back(port):
    """With continuous batching, a request past its deadline raises
    DeadlineExceededError and its request leaves the batcher at the next
    step: the one slot serves the next request at once."""
    config = LLMConfig(model=DEBUG, max_len=2048,
                       tokenizer=IdsTokenizer(), name="llm-deadline", cache_slots=1,
                       sampling=SamplingParams(max_tokens=2000, stop_token_id=-1))
    h = serve_llm(config, device="cpu")
    try:
        with pytest.raises(ray_tpu_torch.serve.DeadlineExceededError):
            h.options(timeout_s=0.5).remote("a long one").result()
        deadline = time.monotonic() + 30
        while h.engine_stats.remote().result(timeout=60)["cancelled"] < 1 and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        stream = [ray_tpu_torch.get(r, timeout=60)
                  for r in h.generate_stream.remote("next", max_tokens=2)]
        stats = h.engine_stats.remote().result(timeout=60)
        assert len("".join(stream).split()) == 2
        assert stats["cancelled"] == 1 and stats["finished"] == 1 and stats["admitted"] == 2
        assert stats["tokens_out"] < 1000, stats  # the first stopped long before its end
    finally:
        ray_tpu_torch.serve.delete("llm-deadline")


def test_replica_stats_reports_batches(port):
    """The @serve.batch deployment's replica reports the sizes of the
    batches it ran, each at most batch_max_size."""
    config = dataclasses.replace(dataclasses.replace(CONFIG, continuous_batching=False), name="llm-sizes", batch_max_size=2)
    h = serve_llm(config, device="cpu")
    try:
        texts = [r.result(timeout=120) for r in [h.remote(p) for p in PROMPTS]]
        facts = h.replica_stats.remote().result(timeout=60)
        assert sum(facts["batch_sizes"]) == len(PROMPTS) and max(facts["batch_sizes"]) <= 2
        assert facts["kernel_launches"] == {"flash_fwd": 0, "flash_bwd_dq": 0,
                                            "flash_bwd_dkv": 0}  # the plain version on the CPU
        assert len(texts) == len(PROMPTS) and all(isinstance(t, str) for t in texts)
    finally:
        ray_tpu_torch.serve.delete("llm-sizes")


def test_a_closed_stream_gives_its_slot_back():
    """A stream whose consumer stops (a request past its deadline
    mid-stream, a client gone) leaves the batcher at the next step: the one
    slot then serves the next request; its Future's cancellation does the
    same for a unary request still waiting for a slot."""
    from ray_tpu_torch.llm import ContinuousLLMEngine

    config = LLMConfig(model=DEBUG, max_len=2048, tokenizer=IdsTokenizer(), cache_slots=1,
                       sampling=SamplingParams(max_tokens=2000, stop_token_id=-1))
    engine = ContinuousLLMEngine(config, device="cpu")
    try:
        stream = engine.submit_stream("a long one")
        assert len([next(stream) for _ in range(2)]) == 2
        waiting = engine.submit("queued")  # no slot while the stream holds it
        assert waiting.cancel()
        stream.close()
        short = engine.submit("next", SamplingParams(max_tokens=3, stop_token_id=-1))
        assert len(short.result(timeout=60).split()) == 3
        stats = engine.batcher.stats
        assert stats["cancelled"] == 2 and stats["finished"] == 1 and stats["admitted"] == 2
        assert stats["tokens_out"] < 1000, stats
    finally:
        engine.shutdown()
