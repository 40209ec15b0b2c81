"""The port stands alone: ray_tpu_torch, chip_smoke.py, chip_repeats.py and
chip_cards.py import nothing of JAX or of the JAX package, and no entry point runs on the
CPU unless a caller asks for it."""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.data import Dataset
from ray_tpu_torch.experimental.rdt import DeviceTensorChannel
from ray_tpu_torch.llm import ContinuousLLMEngine, LLMConfig, LLMEngine, build_llm_processor
from ray_tpu_torch.models import transformer as T
from ray_tpu_torch.models.continuous_batching import ContinuousBatcher
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.decoding import Generator, init_cache
from ray_tpu_torch.models.disagg_prefill import DisaggPrefillEngine
from ray_tpu_torch.models.paged_kv import PagedBatcher
from ray_tpu_torch.parallel import initialize_host, local_process_specs, single_device_mesh
from ray_tpu_torch.rllib.podracer.sebulba import SebulbaConfig, _PodLearnerImpl
from ray_tpu_torch.util.collective import init_collective_group
from ray_tpu_torch.train import (
    RunConfig, TorchTrainer, default_optimizer, init_state, make_eval_step, make_train_step,
    restore_state,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ray_tpu")


def _port_files():
    return sorted((ROOT / "ray_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "chip_repeats.py", ROOT / "chip_cards.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_port_imports_no_jax_and_no_ray_tpu():
    files = _port_files()
    assert len(files) > 10
    bad = [(f.relative_to(ROOT).as_posix(), m) for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in FORBIDDEN]
    assert bad == []


# the card's machine has neither: the port reads /proc for psutil and
# pickles with its vendored cloudpickle (ray_tpu_torch/_private/cloudpickle)
NOT_ON_THE_CARD = ("psutil", "cloudpickle")


def test_port_imports_no_psutil_and_no_installed_cloudpickle():
    bad = [(f.relative_to(ROOT).as_posix(), m) for f in _port_files()
           for m in _imported_modules(f) if m.split(".")[0] in NOT_ON_THE_CARD]
    assert bad == []
    vendored = ROOT / "ray_tpu_torch" / "_private" / "cloudpickle"
    assert {p.name for p in vendored.glob("*.py")} == {
        "__init__.py", "cloudpickle.py", "cloudpickle_fast.py"}
    assert "BSD" in (vendored / "LICENSE").read_text() or \
        "Redistribution and use" in (vendored / "LICENSE").read_text()


def test_zygote_import_initializes_no_cuda():
    """The zygote's image (torch and the worker) must leave CUDA
    uninitialized: a child forked after cuInit cannot use the card."""
    code = ("import torch, ray_tpu_torch._private.workers.zygote, "
            "ray_tpu_torch._private.workers.default_worker, "
            "ray_tpu_torch._private.raylet.raylet, sys; "
            "print(torch.cuda.is_initialized(), 'psutil' in sys.modules, "
            "'cloudpickle' in sys.modules)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd="/", env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.split() == ["False", "False", "False"]


def test_import_leaves_jax_out_of_sys_modules():
    code = ("import sys, ray_tpu_torch, ray_tpu_torch.llm, ray_tpu_torch.ops, "
            "ray_tpu_torch.models.convert, ray_tpu_torch.train, ray_tpu_torch.parallel, "
            "ray_tpu_torch.models.paged_kv, ray_tpu_torch.parallel.bootstrap, "
            "ray_tpu_torch.util.collective, ray_tpu_torch.train.checkpoint, "
            "ray_tpu_torch.train.config, ray_tpu_torch.train.session, "
            "ray_tpu_torch.train.scaling_policy, ray_tpu_torch.train.torch_trainer, "
            "ray_tpu_torch.rllib, ray_tpu_torch.rllib.podracer, ray_tpu_torch.rllib.adam, "
            "ray_tpu_torch.rllib.convert, ray_tpu_torch.rllib.podracer.torch_env, "
            "ray_tpu_torch.exceptions, ray_tpu_torch.actor, ray_tpu_torch.remote_function, "
            "ray_tpu_torch.dag, ray_tpu_torch.runtime_context, ray_tpu_torch.accelerators, "
            "ray_tpu_torch.accelerators.gpu, ray_tpu_torch._private.worker, "
            "ray_tpu_torch._private.local_mode, ray_tpu_torch._private.core, "
            "ray_tpu_torch._private.ids, ray_tpu_torch._private.fastpath, "
            "ray_tpu_torch._private.object_ref, ray_tpu_torch._private.memory_store, "
            "ray_tpu_torch._private.reference_counter, ray_tpu_torch._private.task_spec, "
            "ray_tpu_torch._private.async_compat, ray_tpu_torch._private.streaming, "
            "ray_tpu_torch._private.profiling, ray_tpu_torch.data, ray_tpu_torch.data.block, "
            "ray_tpu_torch.data.dataset, ray_tpu_torch.data.read_api, "
            "ray_tpu_torch.data._internal.executor, ray_tpu_torch.llm.batch, "
            "ray_tpu_torch.tune, ray_tpu_torch.tune.search, ray_tpu_torch.tune.schedulers, "
            "ray_tpu_torch.tune.tpe, ray_tpu_torch.tune.tuner, "
            "ray_tpu_torch._private.config, ray_tpu_torch._private.debug_locks, "
            "ray_tpu_torch._private.rpc, ray_tpu_torch._private.serialization, "
            "ray_tpu_torch._private.object_store.client, ray_tpu_torch._private.drain, "
            "ray_tpu_torch._private.runtime_env, ray_tpu_torch._private.gcs.server, "
            "ray_tpu_torch._private.raylet.raylet, ray_tpu_torch._private.node, "
            "ray_tpu_torch._private.core_worker, ray_tpu_torch._private.cluster_runtime, "
            "ray_tpu_torch._private.workers.default_worker, "
            "ray_tpu_torch._private.workers.zygote, ray_tpu_torch.observability, "
            "ray_tpu_torch.util.metrics, ray_tpu_torch.util.state, "
            "ray_tpu_torch.rllib.podracer.obs, ray_tpu_torch.util, "
            "ray_tpu_torch.util.placement_group, ray_tpu_torch.util.scheduling_strategies, "
            "ray_tpu_torch.util.gpu, ray_tpu_torch.experimental, "
            "ray_tpu_torch.experimental.channel, ray_tpu_torch.experimental.rdt, "
            "ray_tpu_torch.dag_compiled, ray_tpu_torch.models.disagg_prefill, "
            "ray_tpu_torch.util.collective.objstore_group, ray_tpu_torch.util.collective.v2, "
            "ray_tpu_torch.rllib.podracer.sebulba, ray_tpu_torch.rllib.podracer.codec, "
            "ray_tpu_torch.rllib.podracer.fleet, ray_tpu_torch.cluster_utils, "
            "ray_tpu_torch.data._internal.streaming_executor, ray_tpu_torch._private.chaos, "
            "ray_tpu_torch.autoscaler, ray_tpu_torch.autoscaler.autoscaler, "
            "ray_tpu_torch.autoscaler.node_provider, ray_tpu_torch.serve.grpc_proxy; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'ray_tpu', "
            "'psutil', 'cloudpickle')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd="/", env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_data_and_tune_need_no_pandas_or_pyarrow():
    """The card's machine has neither package: Data, Tune and the LLM
    processor import, and a plan runs, with both unimportable."""
    code = ("import sys; sys.modules['pandas'] = sys.modules['pyarrow'] = None; "
            "import ray_tpu_torch as rt, ray_tpu_torch.data as d, ray_tpu_torch.tune, "
            "ray_tpu_torch.llm.batch; rt.init(local_mode=True); "
            "ds = d.range(40, override_num_blocks=4).map_batches(lambda b: {'id': b['id'] * 2})"
            ".random_shuffle(seed=0).sort('id'); "
            "print(ds.sum('id'), [len(b['id']) for b in ds.iter_batches(batch_size=16)]); "
            "rt.shutdown()")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd="/", env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip() == "1560.0 [16, 16, 8]"


def _raise(result):
    """A fit's error, raised (a loop's failure comes back in the Result)."""
    if result.error is not None:
        raise result.error


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", [
    "default_device", "init_params", "init_cache", "params_from_jax",
    "Generator", "ContinuousBatcher", "LLMEngine", "ContinuousLLMEngine",
    "init_state", "make_train_step", "make_eval_step", "single_device_mesh",
    "PagedBatcher", "init_collective_group", "initialize_host", "restore_state",
    "LLMEngine_params_path", "TorchTrainer", "start_gpu_profile", "build_llm_processor",
    "iter_torch_batches", "DisaggPrefillEngine", "DeviceTensorReader", "PodLearner",
])
def test_entry_points_need_cuda_unless_told_cpu(no_cuda, entry, tmp_path):
    cfg = T.config("debug")
    calls = {
        "default_device": lambda: ray_tpu_torch.default_device(),
        "init_params": lambda: T.init_params(cfg, torch.Generator()),
        "init_cache": lambda: init_cache(cfg, 1, 8),
        "params_from_jax": lambda: params_from_jax({}, cfg),
        "Generator": lambda: Generator(cfg, {}),
        "ContinuousBatcher": lambda: ContinuousBatcher(cfg, {}),
        "LLMEngine": lambda: LLMEngine(LLMConfig(model="debug")),
        "ContinuousLLMEngine": lambda: ContinuousLLMEngine(LLMConfig(model="debug")),
        "init_state": lambda: init_state(cfg, default_optimizer(cfg)),
        "make_train_step": lambda: make_train_step(cfg, default_optimizer(cfg)),
        "make_eval_step": lambda: make_eval_step(cfg),
        "single_device_mesh": lambda: single_device_mesh(),
        "PagedBatcher": lambda: PagedBatcher(cfg, {}),
        "init_collective_group": lambda: init_collective_group(1, 0),
        "initialize_host": lambda: initialize_host(local_process_specs(2)[0]),
        "restore_state": lambda: restore_state("/nonexistent"),
        "LLMEngine_params_path": lambda: LLMEngine(LLMConfig(model="debug",
                                                             params_path="/nonexistent")),
        "TorchTrainer": lambda: _raise(TorchTrainer(
            lambda: init_state(cfg, default_optimizer(cfg)),
            run_config=RunConfig(storage_path=str(tmp_path))).fit()),
        "start_gpu_profile": lambda: ray_tpu_torch.start_gpu_profile(str(tmp_path)),
        "build_llm_processor": lambda: build_llm_processor(LLMConfig(model="debug")),
        "iter_torch_batches": lambda: next(Dataset([{"id": torch.arange(2).numpy()}])
                                           .iter_torch_batches(batch_size=1)),
        "DisaggPrefillEngine": lambda: DisaggPrefillEngine(cfg, {}),
        "DeviceTensorReader": lambda: channel.reader().read(timeout=1),
        "PodLearner": lambda: _PodLearnerImpl(dataclasses.asdict(SebulbaConfig()), 4, 2),
    }
    channel = DeviceTensorChannel((2,), "bfloat16")
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            calls[entry]()
    finally:
        channel.close()


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """No card: exit non-zero and print no result. Alone in a directory
    (no package beside it) it fails the same way."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
            env.pop("PYTHONPATH")
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


def test_chip_cards_refuses_without_four_cards(tmp_path):
    """No card: chip_cards.py exits non-zero before it starts anything and
    prints no result."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_cards.py")], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 1 and "needs 4 cards" in out.stderr
    assert '"ok": true' not in out.stdout


def test_serve_imports_no_jax_and_no_ray_tpu():
    """Serve and the LLM deployment import neither JAX nor the JAX package
    (nor torch: a replica of a plain deployment never loads it)."""
    code = ("import sys, ray_tpu_torch.serve, ray_tpu_torch.serve.slo, "
            "ray_tpu_torch.serve.batching, ray_tpu_torch.serve.multiplex, "
            "ray_tpu_torch.serve.deployment, ray_tpu_torch.serve.controller, "
            "ray_tpu_torch.serve.local_mode, ray_tpu_torch.serve.http_proxy, "
            "ray_tpu_torch.serve.grpc_proxy; "
            "torch_free = 'torch' not in sys.modules; "
            "import ray_tpu_torch.llm.serving; "
            "print(torch_free, sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'ray_tpu', "
            "'psutil', 'cloudpickle', 'grpc')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd="/", env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip() == "True []"


def test_serve_exports_the_jax_packages_names():
    import ray_tpu.serve
    import ray_tpu_torch.serve

    assert ray_tpu_torch.serve.__all__ == ray_tpu.serve.__all__
    assert all(hasattr(ray_tpu_torch.serve, name) for name in ray_tpu_torch.serve.__all__)
