"""The port's cluster-runtime parts against ray_tpu's, with no cluster.

The flag table, the fastpath frame codec, the RPC body codec, the object
serialization of numpy, bytes and dicts, the runtime_env packaging and the
raylet's ResourceSet all run through both packages on the same inputs and
must give the same bytes and values (the ResourceSet's "GPU" ids stand for
JAX's "TPU" chips). The port's own additions are held on their own terms:
torch tensors round-trip bit for bit with their bytes out of band,
/proc stands in for psutil, and a process group's teardown leaves nothing.
"""

import os
import pickle
import signal
import subprocess
import sys
import time

import numpy as np
import psutil
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from ray_tpu._private import config as jax_config
from ray_tpu._private import rpc as jax_rpc
from ray_tpu._private import runtime_env as jax_renv
from ray_tpu._private import serialization as jax_ser
from ray_tpu._private.fastpath import _pyimpl as jax_fp
from ray_tpu._private.raylet.raylet import ResourceSet as JaxResourceSet
from ray_tpu_torch._private import config as port_config
from ray_tpu_torch._private import fastpath as port_fp
from ray_tpu_torch._private import node as port_node
from ray_tpu_torch._private import rpc as port_rpc
from ray_tpu_torch._private import runtime_env as port_renv
from ray_tpu_torch._private import serialization as port_ser
from ray_tpu_torch._private.raylet import raylet as port_raylet
from ray_tpu_torch._private.raylet.raylet import ResourceSet as PortResourceSet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---- the flag table ---------------------------------------------------------
def test_flag_table_matches():
    assert port_config._DEFINITIONS == jax_config._DEFINITIONS
    assert port_config.config.to_json() == jax_config._Config().to_json()


ENV_FLAGS = {"rpc_call_timeout_s": "12.5", "rpc_max_retries": "9",
             "worker_zygote_enabled": "off", "worker_pool_prestart_workers": "Yes",
             "testing_rpc_failure": "Ping=0.5", "object_store_memory_bytes": "123456"}


def test_flags_from_env_and_system_config(monkeypatch):
    for name, value in ENV_FLAGS.items():
        monkeypatch.setenv("RAY_TPU_" + name.upper(), value)
    port, jax = port_config._Config(), jax_config._Config()
    assert port._values == jax._values
    assert port.rpc_call_timeout_s == 12.5 and port.worker_zygote_enabled is False
    sysconf = {"rpc_max_retries": "3", "log_to_driver": "false",
               "scheduler_spread_threshold": 0.25, "gcs_port": 7000.0}
    for c in (port, jax):
        c.initialize(sysconf)
    assert port._values == jax._values
    assert port.log_to_driver is False and port.gcs_port == 7000
    for c in (port, jax):
        with pytest.raises(ValueError, match="Unknown config flag: bogus"):
            c.initialize({"bogus": 1})
    port2, jax2 = port_config._Config(), jax_config._Config()
    port2.from_json(port.to_json())
    jax2.from_json(jax.to_json())
    assert port2._values == jax2._values


# ---- the fastpath frame codec ------------------------------------------------
blobs = st.binary(max_size=300)


@settings(max_examples=150, deadline=None)
@given(total=st.integers(0, 2**32 - 1), call_id=st.integers(0, 2**64 - 1),
       kind=st.integers(0, 255), meta=blobs, bufs=st.lists(blobs, max_size=5),
       prefix=st.binary(min_size=0, max_size=24), index=st.integers(0, 2**32 - 1))
def test_fastpath_frames_equal_jax(total, call_id, kind, meta, bufs, prefix, index):
    assert port_fp.pack_header(total, call_id, kind) == jax_fp.pack_header(total, call_id, kind)
    hdr = jax_fp.pack_header(total, call_id, kind)
    assert port_fp.unpack_header(hdr) == jax_fp.unpack_header(hdr) == (total, call_id, kind)
    body = port_fp.encode_body(meta, bufs)
    assert body == jax_fp.encode_body(meta, bufs)
    pm, pb = port_fp.decode_body(body)
    jm, jb = jax_fp.decode_body(body)
    assert bytes(pm) == bytes(jm) == meta
    assert [bytes(b) for b in pb] == [bytes(b) for b in jb] == bufs
    assert port_fp.build_frame(call_id, kind, meta) == jax_fp.build_frame(call_id, kind, meta)
    assert port_fp.id_from_index(prefix, index) == jax_fp.id_from_index(prefix, index)
    for bad in (body[:-1], body[:3]) if bufs and bufs[-1] else ():
        with pytest.raises(ValueError):
            port_fp.decode_body(bad)


# ---- the GCS's port -----------------------------------------------------------
def test_gcs_binds_the_port_it_reports(tmp_path):
    """The GCS binds a port of the system's choosing and reports it: no
    port is picked in the driver and bound later, where any process of
    the host could take it in between (ROADMAP.md Queue C)."""
    import socket

    from ray_tpu_torch._private.node import kill_process_tree, spawn_gcs
    from ray_tpu_torch._private.rpc import RpcClient

    proc, port = spawn_gcs(0, str(tmp_path))
    try:
        assert proc.args[proc.args.index("--port") + 1] == "0"
        client = RpcClient("127.0.0.1", port)
        try:
            assert client.call("Ping", timeout=10) == "pong"
        finally:
            client.close()
        with socket.socket() as s, pytest.raises(OSError):
            s.bind(("127.0.0.1", port))  # the GCS holds it
        assert not os.path.exists(tmp_path / "gcs_port")
    finally:
        kill_process_tree(proc)


def test_init_returns_with_the_head_node_registered():
    """``init()`` returns once the GCS has the head node: its resources
    are the cluster's at once, though the GCS answers the raylet's
    RegisterNode 1.5 s late (ROADMAP.md Queue C)."""
    code = ("import ray_tpu_torch as rt; rt.init(num_cpus=3); "
            "print(rt.cluster_resources().get('CPU')); rt.shutdown()")
    # the daemons read their flags from RAY_TPU_<FLAG>
    env = dict(os.environ, PYTHONPATH=ROOT, RAY_TPU_TESTING_RPC_FAILURE="RegisterNode=1:1500")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd="/", capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[-1] == "3.0"


# ---- the RPC body codec ------------------------------------------------------
RPC_BODIES = [
    {"method": "Ping", "args": (), "kwargs": {}},
    {"oid": b"\x01" * 28, "size": 5, "nested": [1, 2.5, None, "x" * 100]},
    {"small": np.arange(10, dtype=np.int32), "big": np.arange(5000, dtype=np.float64)},
    [np.ones((64, 64), np.float32), bytearray(b"y" * 9000)],
]


@pytest.mark.parametrize("i", range(len(RPC_BODIES)))
def test_rpc_bodies_equal_jax(i):
    obj = RPC_BODIES[i]
    pk, psegs, ptot = port_rpc._encode_body(obj)
    jk, jsegs, jtot = jax_rpc._encode_body(obj)
    joined = b"".join(bytes(s) for s in psegs)
    assert (pk, ptot, joined) == (jk, jtot, b"".join(bytes(s) for s in jsegs))
    back = port_rpc._decode_body(pk, joined)
    assert pickle.dumps(back) == pickle.dumps(jax_rpc._decode_body(jk, joined))
    _assert_same(back, obj)


def _assert_same(a, b):
    """Equal values, numpy arrays by dtype, shape and contents."""
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    else:
        assert a == b


# ---- object serialization ------------------------------------------------------
PAYLOADS = [
    b"raw bytes" * 100,
    {"a": 1, "b": [1.5, "s", None], "c": {"d": (1, 2)}},
    np.arange(100_000, dtype=np.float32).reshape(100, 1000),
    np.array([[1, 2], [3, 4]], dtype=np.int64)[:, ::-1],
    {"arr": np.zeros((3, 0)), "flag": True, "bytes": b"\x00\xff"},
    list(range(1000)),
]


@pytest.mark.parametrize("i", range(len(PAYLOADS)))
def test_serialize_bytes_equal_jax(i):
    value = PAYLOADS[i]
    data = port_ser.serialize(value)
    assert data == jax_ser.serialize(value)
    back = port_ser.deserialize(data)
    assert pickle.dumps(back) == pickle.dumps(jax_ser.deserialize(data))
    _assert_same(back, value)


def _bits(t):
    return t.contiguous().reshape(-1).view(torch.uint8).tolist()


TENSORS = {
    "fp32": lambda g: torch.randn(33, 17, generator=g),
    "bf16": lambda g: torch.randn(4, 257, generator=g).to(torch.bfloat16),
    "fp16_nan": lambda g: torch.tensor([float("nan"), -0.0, float("inf"), 1e-8], dtype=torch.float16),
    "int64": lambda g: torch.randint(-2**62, 2**62, (5, 6), generator=g),
    "int8": lambda g: torch.randint(-128, 127, (1000,), generator=g, dtype=torch.int8),
    "bool": lambda g: torch.rand(7, 3, generator=g) > 0.5,
    "non_contiguous": lambda g: torch.randn(8, 6, generator=g).t()[::2],
    "empty": lambda g: torch.empty(3, 0, 4, dtype=torch.bfloat16),
    "scalar": lambda g: torch.tensor(2.5, dtype=torch.float64),
    "complex": lambda g: torch.randn(3, dtype=torch.complex64, generator=g),
}


@pytest.mark.parametrize("name", sorted(TENSORS))
def test_tensor_round_trip_out_of_band(name):
    t = TENSORS[name](torch.Generator().manual_seed(0))
    sv = port_ser.serialize_prepare(t)
    try:
        # one out-of-band buffer holding exactly the tensor's bytes
        assert [b.nbytes for b in sv.buffers] == [t.numel() * t.element_size()]
        assert len(sv.meta) < 300
        data = sv.to_bytes()
    finally:
        sv.release()
    back = port_ser.deserialize(data)
    assert type(back) is torch.Tensor and back.device.type == "cpu"
    assert back.dtype == t.dtype and back.shape == t.shape and back.is_contiguous()
    assert _bits(back) == _bits(t)
    # inline (bytes): a tensor of its own, writable without touching `data`
    if back.numel():
        back.reshape(-1).view(torch.uint8)[0] ^= 1
        assert port_ser.deserialize(data).reshape(-1).view(torch.uint8)[0] == _bits(t)[0]


def test_tensor_from_a_store_view_is_zero_copy_and_pins_it():
    t = torch.arange(4096, dtype=torch.float32)
    sv = port_ser.serialize_prepare({"t": t, "p": torch.nn.Parameter(torch.ones(3))})
    region = bytearray(sv.total)
    sv.write_into(memoryview(region))
    sv.release()
    released = []
    got = port_ser.deserialize(memoryview(region), release_cb=lambda: released.append(1))
    base = np.frombuffer(region, np.uint8).ctypes.data
    assert base <= got["t"].data_ptr() < base + len(region)  # a view, not a copy
    assert torch.equal(got["t"], t)
    p = got["p"]
    assert type(p) is torch.Tensor and p.requires_grad and torch.equal(p.detach(), torch.ones(3))
    assert released == []  # the tensors pin the region
    del got, p
    assert released == [1]


def test_sparse_and_subclass_tensors_keep_torch_pickling():
    s = torch.eye(3).to_sparse()
    back = port_ser.deserialize(port_ser.serialize(s))
    assert back.is_sparse and torch.equal(back.to_dense(), torch.eye(3))


def test_functions_pickle_by_the_vendored_cloudpickle():
    k = 7

    def f(x):
        return x + k

    data = port_ser.dumps_function(f)
    assert b"ray_tpu_torch._private.cloudpickle" in data
    assert port_ser.loads_function(data)(1) == 8
    from ray_tpu_torch._private import cloudpickle as vendored

    assert vendored.__version__ == "3.1.2"


# ---- runtime_env packaging ---------------------------------------------------
class _KV:
    def __init__(self):
        self.kv = {}

    def call(self, method, ns, key, value=None, overwrite=False, timeout=None):
        if method == "KVGet":
            return self.kv.get((ns, key))
        self.kv[(ns, key)] = value
        return True


def test_runtime_env_packaging_matches(tmp_path):
    pkg = tmp_path / "wd"
    (pkg / "sub").mkdir(parents=True)
    (pkg / "a.py").write_text("A = 1\n")
    (pkg / "sub" / "b.txt").write_text("b" * 1000)
    (pkg / "__pycache__").mkdir()
    (pkg / "__pycache__" / "x.pyc").write_bytes(b"\0")
    env = {"env_vars": {"X": 1, "Y": "two"}, "working_dir": str(pkg),
           "py_modules": [str(pkg / "sub")], "pip": {"packages": ["b", "a"]}}
    kvs = _KV(), _KV()
    port = port_renv.prepare_runtime_env(env, kvs[0])
    jax = jax_renv.prepare_runtime_env(env, kvs[1])
    assert port == jax and port["working_dir_pkg"].startswith("pkg_")
    assert kvs[0].kv == kvs[1].kv
    assert port_renv._zip_dir(str(pkg)) == jax_renv._zip_dir(str(pkg))
    for e in (port, {}, {"env_vars": {"A": "1"}}, env):
        assert port_renv.env_hash(e) == jax_renv.env_hash(e)
    job, task = {"env_vars": {"A": "1", "B": "2"}, "working_dir": "pkg_x"}, {"env_vars": {"B": "3"}}
    assert port_renv.merge_runtime_envs(job, task) == jax_renv.merge_runtime_envs(job, task)
    for bad in ({"conda": "env"}, {"pip": "not-a-list"}):
        with pytest.raises(ValueError) as pe:
            port_renv.prepare_runtime_env(bad, kvs[0])
        with pytest.raises(ValueError) as je:
            jax_renv.prepare_runtime_env(bad, kvs[1])
        assert str(pe.value) == str(je.value)


# ---- the raylet's ResourceSet: cards as instances ------------------------------
def _as_tpu(req):
    return {("TPU" if k == "GPU" else k): v for k, v in req.items()}


def test_resource_set_gives_jax_ids():
    total = {"CPU": 8.0, "GPU": 4.0, "memory": 1e9, "custom": 2.0}
    port, jax = PortResourceSet(total), JaxResourceSet(_as_tpu(total))
    rng = np.random.default_rng(0)
    held = []
    for step in range(200):
        if held and (rng.random() < 0.45 or len(held) > 5):
            p, j = held.pop(int(rng.integers(len(held))))
            port.release(p)
            jax.release(j)
        else:
            req = {"CPU": float(rng.integers(0, 3)), "GPU": float(rng.integers(0, 3))}
            if rng.random() < 0.3:
                req["custom"] = 1.0
            p, j = port.allocate(req), jax.allocate(_as_tpu(req))
            assert (p is None) == (j is None)
            if p is not None:
                assert p["gpu_ids"] == j["tpu_chips"]
                assert p["resources"] == req
                held.append((p, j))
        assert port.free_gpu_ids == jax.free_tpu_chips
        assert _as_tpu(port.available) == jax.available
    assert port.feasible({"GPU": 4}) and not port.feasible({"GPU": 5})
    # "TPU" is a plain countable resource on a card node
    tpu = PortResourceSet({"CPU": 1.0, "TPU": 2.0})
    assert tpu.allocate({"TPU": 2.0}) == {"resources": {"TPU": 2.0}, "gpu_ids": []}


# ---- /proc in place of psutil, and the process-group teardown -------------------
def test_proc_reads_match_psutil():
    avail = port_node.available_memory_bytes()
    assert abs(avail - psutil.virtual_memory().available) < 512 * 2**20
    assert abs(port_raylet._memory_used_pct() - psutil.virtual_memory().percent) < 5.0
    ticks = port_raylet._proc_start_time(os.getpid())
    start = psutil.boot_time() + ticks / os.sysconf("SC_CLK_TCK")
    assert abs(start - psutil.Process().create_time()) < 0.05
    res = port_node.default_node_resources(num_cpus=2, num_gpus=3, resources={"x": 1.0})
    assert res["CPU"] == 2.0 and res["GPU"] == 3.0 and res["x"] == 1.0
    assert res["node:127.0.0.1"] == 1.0 and res["memory"] > 0
    probe = port_raylet.ZygoteProc.__new__(port_raylet.ZygoteProc)
    probe.pid, probe.returncode, probe._pidfd = os.getpid(), None, None
    probe._create_time = ticks
    assert probe.poll() is None  # alive, by its start time


TREE = """
import os, subprocess, sys, time
kids = [subprocess.Popen([sys.executable, "-c", "import time; time.sleep(600)"])
        for _ in range(2)]
if os.fork() == 0:      # a grandchild whose parent exits: reparented
    if os.fork() == 0:
        time.sleep(600)
    os._exit(0)
print(" ".join(str(k.pid) for k in kids), flush=True)
time.sleep(600)
"""


def test_kill_process_tree_leaves_nothing():
    proc = subprocess.Popen([sys.executable, "-c", TREE], stdout=subprocess.PIPE,
                            start_new_session=True, text=True)
    kids = [int(p) for p in proc.stdout.readline().split()]
    time.sleep(0.2)
    members = [p.pid for p in psutil.process_iter() if _pgid(p.pid) == proc.pid]
    assert len(members) >= 4 and set(kids) <= set(members)
    t0 = time.monotonic()
    port_node.kill_process_tree(proc)
    assert time.monotonic() - t0 < 6
    assert proc.poll() is not None
    left = [p for p in members if psutil.pid_exists(p) and
            psutil.Process(p).status() != psutil.STATUS_ZOMBIE]
    assert left == []
    with pytest.raises(ProcessLookupError):
        os.killpg(proc.pid, signal.SIGCONT)
    port_node.kill_process_tree(proc)  # an ended group: a no-op


def _pgid(pid):
    try:
        return os.getpgid(pid)
    except ProcessLookupError:
        return None
