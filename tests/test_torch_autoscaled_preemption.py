"""The slice as a whole at a small size, held against JAX: a preempted card
node's actor is brought back by the autoscaler.

``tiny`` (fp32) is served from a ``num_gpus=1, max_restarts=1`` actor on a
port ``Cluster`` under ``RAY_TPU_FAKE_GPUS=1`` (the engine on the CPU, the
card fake): a head of CPUs only and node B owning card 0. JAX's
``LLMEngine`` draws the weights from seed 0; the port's are converted with
``models/convert.py`` and reach the actor through the store. An
``Autoscaler`` with one ``gpu1`` type and ``LocalNodeProvider(cluster=)``
watches the cluster. The actor's greedy tokens equal JAX's ``generate`` on
the same prompts; ``PreemptionInjector`` preempts B (a drain notice, then
the kill); the restart, pending with no card in the cluster, is demand, so
the autoscaler launches one node that owns card 0, and the restarted actor's
tokens equal JAX's again. Killing the actor leaves that node idle, and the
autoscaler terminates it: one launch, one termination, the drain events
carry the preemption reason, and the actor ended ALIVE with one restart.
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

import ray_tpu_torch as rt
from cluster_ref import collector_paused
from ray_tpu.llm.config import LLMConfig as JLLMConfig
from ray_tpu.llm.engine import LLMEngine as JLLMEngine
from ray_tpu.models import transformer as JT
from ray_tpu.models.decoding import SamplingParams as JSamplingParams
from ray_tpu_torch._private.chaos import PreemptionInjector
from ray_tpu_torch._private.drain import (
    EVENT_DRAIN_COMPLETE,
    EVENT_DRAIN_START,
    REASON_PREEMPTION,
)
from ray_tpu_torch.autoscaler import Autoscaler, LocalNodeProvider, NodeTypeConfig
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.llm import LLMConfig, LLMEngine, SamplingParams
from ray_tpu_torch.models import transformer as T
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.util import state as rstate
from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy

PROMPTS = [[7, 9, 11], [100, 2, 3, 4, 5, 6, 88], [5, 17, 3, 101, 42, 1, 2, 3, 4, 5, 6]]


class ServedTiny:
    """The engine on a leased (fake) card: params from the store (boxed,
    so the constructor gets the ref), where it runs recorded first."""

    def __init__(self, config, boxed_ref):
        self.facts = {"node_id": rt.get_runtime_context().get_node_id(),
                      "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                      "pid": os.getpid()}
        self.engine = LLMEngine(config, params=rt.get(boxed_ref[0]), device="cpu")

    def where(self):
        return self.facts

    def generate_tokens(self, ids):
        return self.engine.generate_tokens(ids)


def jax_side():
    """JAX's tiny engine (seed 0): its params and its greedy tokens on
    PROMPTS."""
    jcfg = JT.config("tiny", dtype=jnp.float32, param_dtype=jnp.float32)
    with collector_paused():
        eng = JLLMEngine(JLLMConfig(model=jcfg, max_len=64,
                                    sampling=JSamplingParams(max_tokens=10)))
        tokens = eng.generate_tokens(PROMPTS)
    return jax.tree.map(np.asarray, eng.generator.params), tokens


def _wait(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.1)


def test_preempted_card_node_replaced_by_autoscaler(monkeypatch):
    tcfg = T.config("tiny", dtype=torch.float32, param_dtype=torch.float32)
    config = LLMConfig(model=tcfg, max_len=64, sampling=SamplingParams(max_tokens=10))
    monkeypatch.setenv("RAY_TPU_FAKE_GPUS", "1")
    cluster = Cluster()
    cluster.add_node(num_cpus=2)
    b = cluster.add_node(num_cpus=1, num_gpus=1)
    cluster.wait_for_nodes()
    provider = LocalNodeProvider(cluster.gcs_addr, cluster=cluster)
    asc = Autoscaler(cluster.gcs_addr,
                     {"gpu1": NodeTypeConfig(resources={"CPU": 1, "GPU": 1}, max_workers=1)},
                     provider, idle_timeout_s=3.0, interval_s=0.5)
    try:
        rt.init(address=cluster.address)
        asc.start()
        # B's zygote boots while JAX builds its engine
        warm = rt.remote(lambda: 1).options(scheduling_strategy=NodeAffinitySchedulingStrategy(
            b.node_id, soft=False)).remote()
        np_params, want = jax_side()
        assert rt.get(warm, timeout=120) == 1
        params = params_from_jax(np_params, tcfg, "cpu")
        served = rt.remote(num_gpus=1, max_restarts=1)(ServedTiny).remote(
            config, [rt.put(params)])
        before = rt.get(served.where.remote(), timeout=120)
        assert (before["node_id"], before["visible"]) == (b.node_id, "0")
        assert rt.get(served.generate_tokens.remote(PROMPTS), timeout=120) == want
        assert asc.num_launches == 0

        gone = PreemptionInjector(cluster, seed=0, deadline_s=4.0, jitter_s=1.0).preempt_one()
        assert gone == b.node_id and cluster.free_gpu_ids() == [0]
        assert rt.get(served.generate_tokens.remote(PROMPTS), timeout=120) == want
        after = rt.get(served.where.remote(), timeout=60)
        (new,) = provider.non_terminated_nodes()
        assert after["node_id"] == new and after["visible"] == "0"
        assert after["pid"] != before["pid"] and provider.node_gpu_ids(new) == [0]
        assert asc.num_launches == 1
        info = rstate.get_actor(served._actor_id.hex())
        assert (info["state"], info["num_restarts"]) == ("ALIVE", 1)
        drains = {(e["type"], e.get("reason")) for e in rstate.list_events()
                  if e.get("node_id") == b.node_id}
        assert {(EVENT_DRAIN_START, REASON_PREEMPTION),
                (EVENT_DRAIN_COMPLETE, REASON_PREEMPTION)} <= drains

        rt.kill(served)
        _wait(lambda: not provider.non_terminated_nodes() and asc.num_terminations,
              60, "the idle node's termination")
        assert (asc.num_launches, asc.num_terminations) == (1, 1)
    finally:
        asc.stop()
        try:
            rt.shutdown()
        finally:
            provider.shutdown()
            cluster.shutdown()
