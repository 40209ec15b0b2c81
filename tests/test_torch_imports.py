"""The port stands alone: ray_tpu_torch, chip_smoke.py and chip_repeats.py
import nothing of JAX or of the JAX package, and no entry point runs on the
CPU unless a caller asks for it."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.data import Dataset
from ray_tpu_torch.llm import ContinuousLLMEngine, LLMConfig, LLMEngine, build_llm_processor
from ray_tpu_torch.models import transformer as T
from ray_tpu_torch.models.continuous_batching import ContinuousBatcher
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.decoding import Generator, init_cache
from ray_tpu_torch.models.paged_kv import PagedBatcher
from ray_tpu_torch.parallel import initialize_host, local_process_specs, single_device_mesh
from ray_tpu_torch.util.collective import init_collective_group
from ray_tpu_torch.train import (
    RunConfig, TorchTrainer, default_optimizer, init_state, make_eval_step, make_train_step,
    restore_state,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ray_tpu")


def _port_files():
    return sorted((ROOT / "ray_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                             ROOT / "chip_repeats.py"]


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
            "ray_tpu_torch.tune.tpe, ray_tpu_torch.tune.tuner; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'ray_tpu')))")
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
    "iter_torch_batches",
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
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


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
