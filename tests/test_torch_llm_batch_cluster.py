"""``build_llm_processor`` over a two-node ``Cluster`` of the port's with
two fake cards (``RAY_TPU_FAKE_GPUS=2``, one a node), at ``debug`` width,
against JAX's processor on the same rows in JAX's local mode (collector
paused; no JAX cluster).

Both sides serve the same weights: JAX's engine draws ``debug`` from seed
0, and the port's engines restore those params, written by DCP. The rows pass a
CPU stage (tasks spread over both nodes), then the processor's stage: a
pool of two actors, each leasing a card (``num_gpus=1``) and building one
engine, here on the CPU (``device="cpu"``; the cards are fake). JAX's
processor runs in this thread while the port's plan runs on the cluster
from another. The generated column equals JAX's, row for row and in
order.
tests/test_torch_cluster_utils.py holds a stage that wants a card and has
none.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.data  # noqa: F401
import ray_tpu_torch
import ray_tpu_torch.data  # noqa: F401
from cluster_ref import collector_paused, port_cluster
from ids_tokenizer import IdsTokenizer
from ray_tpu.llm import build_llm_processor as jax_processor
from ray_tpu.llm.config import LLMConfig as JLLMConfig
from ray_tpu.models import transformer as JT
from ray_tpu.models.decoding import SamplingParams as JSamplingParams
from ray_tpu_torch.llm import LLMConfig, SamplingParams, build_llm_processor
from ray_tpu_torch.models import transformer as T
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.train import save_state


# prompts of one length: JAX compiles one prefill shape
ROWS = [{"prompt": f"msg {i} " * 3, "i": i} for i in range(6)]
MAX_TOKENS = 8


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """JAX's processor, its engine drawing ``debug`` from seed 0 (cached:
    the processor reuses it); that engine's params, written by DCP, in the
    port's config. (JAX's processor, the port's config.)"""
    import ray_tpu.llm.batch as jax_batch

    jcfg = JT.config("debug", dtype=jnp.float32, param_dtype=jnp.float32)
    jconfig = JLLMConfig(model=jcfg, max_len=64, seed=0, tokenizer=IdsTokenizer(),
                         sampling=JSamplingParams(max_tokens=MAX_TOKENS))
    with collector_paused():
        eng = jax_batch._engine_for(jconfig)
    np_params = jax.tree.map(np.asarray, eng.generator.params)
    tcfg = T.config("debug", dtype=torch.float32, param_dtype=torch.float32)
    dcp_dir = str(tmp_path_factory.mktemp("params") / "dcp")
    save_state(params_from_jax(np_params, tcfg, "cpu"), dcp_dir)
    config = LLMConfig(model=tcfg, max_len=64, params_path=dcp_dir, tokenizer=IdsTokenizer(),
                       sampling=SamplingParams(max_tokens=MAX_TOKENS))
    try:
        yield jax_processor(jconfig, batch_size=2), config
    finally:
        jax_batch._ENGINE_CACHE.clear()


def jax_rows(process):
    """ROWS through JAX's processor in JAX's local mode."""
    with collector_paused():
        ray_tpu.init(local_mode=True)
        try:
            return process(ray_tpu.data.from_items(ROWS, override_num_blocks=3)).take_all()
        finally:
            ray_tpu.shutdown()


@pytest.fixture(scope="module")
def cluster():
    """Up, and both nodes' zygotes booting, before JAX's side runs."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_FAKE_GPUS", "2")
        with port_cluster({"num_cpus": 2, "num_gpus": 1}, {"num_cpus": 2, "num_gpus": 1}) as c:
            c.warm = [ray_tpu_torch.remote(lambda: 1).options(
                scheduling_strategy="SPREAD").remote() for _ in range(2)]
            yield c


BLOCKS = 3


def tagged(barrier_dir):
    """The rows through a CPU stage of tasks spread over both nodes, each
    row tagged with the node that mapped it. Each task waits until all
    three have started (a file each in ``barrier_dir``): three tasks
    running at once need three leases, more than one node's two CPUs, so
    both nodes map rows however slow the host is. (Without the wait,
    under load the first lease's worker could finish a task before the
    other leases were granted and take the next one: the runtime reuses
    a granted lease, as the JAX package's does.)"""
    def tag(b):
        import time

        open(os.path.join(barrier_dir, str(int(b["i"][0]))), "w").close()
        deadline = time.monotonic() + 60
        while len(os.listdir(barrier_dir)) < BLOCKS:
            if time.monotonic() > deadline:
                raise TimeoutError(f"{os.listdir(barrier_dir)} of {BLOCKS} tasks started")
            time.sleep(0.02)
        return dict(b, node=np.full(len(b["i"]), os.environ["RAY_TPU_NODE_ID"]))

    return ray_tpu_torch.data.from_items(ROWS, override_num_blocks=BLOCKS).map_batches(
        tag, scheduling_strategy="SPREAD")


def test_processor_on_leased_cards_matches_jax(cluster, jax_side, tmp_path):
    """Two pool actors, one a node's card: JAX's completions, in order;
    each actor built one engine on its card's worker, and the CPU stage
    ran on both nodes (chip_smoke.py runs one actor on the card)."""
    jax_process, config = jax_side
    assert ray_tpu_torch.get(cluster.warm, timeout=120) == [1, 1]
    pool = 2
    process = build_llm_processor(config, batch_size=2, device="cpu",
                                  num_gpus=1, concurrency=pool, _stats_column="stage")
    with ThreadPoolExecutor(1) as driver:
        port = driver.submit(lambda: process(tagged(str(tmp_path))).take_all())
        want = jax_rows(jax_process)
        got = port.result(timeout=120)
    assert [r["generated"] for r in got] == [r["generated"] for r in want]
    assert [r["i"] for r in got] == list(range(len(ROWS)))
    assert all(len(r["generated"].split()) == MAX_TOKENS for r in got)
    assert {r["node"] for r in got} == {n.node_id for n in cluster.nodes}
    stages = {(r["stage"]["pid"], r["stage"]["batch"]): r["stage"] for r in got}
    pids = {pid for pid, _ in stages}
    assert len(stages) == 3 and os.getpid() not in pids and len(pids) <= pool
    assert all(s["engines_built"] == 1 and s["device"] == "cpu" for s in stages.values())
    cards = {s["pid"]: s["visible"] for s in stages.values()}
    assert set(cards.values()) <= {"0", "1"} and len(set(cards.values())) == len(pids)
