"""The port's fastpath codec (ray_tpu_torch/_private/fastpath) held byte for
byte against its own Python backend and the JAX package's C backend.

Every case of tests/test_fastpath_parity.py runs through three
implementations: the port's C extension (``csrc/fastpath.c``, built here
into ``_build/``), the port's ``_pyimpl`` and JAX's extension
(``ray_tpu._private.fastpath.available_backends()["c"]``). Encodings must
be equal bytes and decodings equal values. Then the selection:
``RAY_TPU_FASTPATH=require`` loads "c" and ``0`` gives "python", each in
a fresh interpreter; a port cluster under ``require`` runs tasks, an
actor and a put/get with every process on the C codec; and the ASan
build of the port's extension passes this file's parity cases
(slow-marked, as tests/test_fastpath_asan.py is).
"""

import os
import pickle
import shutil
import struct
import subprocess
import sys

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from ray_tpu._private import fastpath as jax_fastpath
from ray_tpu_torch._private import fastpath, rpc
from ray_tpu_torch._private.ids import ActorID, JobID, ObjectID, TaskID

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "ray_tpu_torch", "_private", "fastpath", "csrc")

PORT = fastpath.available_backends()
IMPLS = {"port_python": PORT["python"]}
if "c" in PORT:
    IMPLS["port_c"] = PORT["c"]
if "c" in jax_fastpath.available_backends():
    IMPLS["jax_c"] = jax_fastpath.available_backends()["c"]


def _impls():
    return sorted(IMPLS.items())


def _same(outs: dict):
    ref = next(iter(outs.values()))
    assert all(v == ref for v in outs.values()), sorted(outs)
    return ref


def test_three_backends_present_with_a_compiler():
    """A compiler exists: neither package's C extension may fall back
    silently, and the port's is its own module."""
    if fastpath.compiler() is None:
        pytest.skip("no C compiler on PATH")
    assert sorted(IMPLS) == ["jax_c", "port_c", "port_python"]
    assert IMPLS["port_c"].__name__ == "ray_tpu_torch_fastpath"
    assert IMPLS["jax_c"].__name__ == "ray_tpu_fastpath"
    assert IMPLS["port_c"].BACKEND == IMPLS["jax_c"].BACKEND == "c"
    assert {i.NOGIL_THRESHOLD for i in IMPLS.values()} == {64 * 1024}


# ---- headers ----------------------------------------------------------------
@settings(max_examples=200, deadline=None)
@given(total=st.integers(0, 2**32 - 1), call_id=st.integers(0, 2**64 - 1),
       kind=st.integers(0, 255))
def test_header_parity(total, call_id, kind):
    ref = _same({n: impl.pack_header(total, call_id, kind) for n, impl in _impls()})
    assert len(ref) == 13
    for _, impl in _impls():
        assert impl.unpack_header(ref) == (total, call_id, kind)


@pytest.mark.parametrize("kind", [256, -1, 1000])
def test_header_kind_range_checked(kind):
    for _, impl in _impls():
        with pytest.raises(ValueError):
            impl.pack_header(1, 1, kind)
        with pytest.raises(ValueError):
            impl.unpack_header(b"\x00" * 12)


@pytest.mark.parametrize("call", [
    lambda f: f.pack_header(2**32, 1, 0), lambda f: f.pack_header(-1, 1, 0),
    lambda f: f.pack_header(1, 2**64, 0), lambda f: f.pack_header(1, -1, 0),
    lambda f: f.build_frame(2**64, 0, b"x"), lambda f: f.build_frame(-1, 0, b"x"),
    lambda f: f.id_from_index(b"prefix", 2**32), lambda f: f.id_from_index(b"", -1)],
    ids=["total", "total<0", "call_id", "call_id<0", "frame_call_id", "frame_call_id<0",
         "index", "index<0"])
def test_out_of_range_fields_raise_on_both_port_backends(call):
    """The port's two backends agree on out-of-range integer fields: both
    raise (JAX's C backend wraps them, its argument formats unchecked)."""
    for name in ("port_python", "port_c"):
        if name in IMPLS:
            with pytest.raises((OverflowError, struct.error)):
                call(IMPLS[name])


# ---- bodies -----------------------------------------------------------------
def _body_shapes():
    rng = np.random.RandomState(0)
    big = rng.randint(0, 255, size=300_000, dtype=np.uint8)
    return [
        ("empty-meta-no-bufs", b"", []),
        ("meta-only", b"m" * 100, []),
        ("one-small-buf", b"meta", [b"x" * 64]),
        ("one-large-buf", b"meta", [big.data.cast("B")]),
        ("many-bufs", b"M" * 1000,
         [b"a" * 10, memoryview(b"b" * 5000).cast("B"),
          np.arange(4096, dtype=np.uint8).data.cast("B"), b""]),
        ("empty-buf-entry", b"x", [b"", b"y"]),
    ]


BODIES = _body_shapes()


def _nbytes(b) -> int:
    return b.nbytes if isinstance(b, memoryview) else len(b)


@pytest.mark.parametrize("name,meta,bufs", BODIES, ids=[s[0] for s in BODIES])
def test_body_encode_decode_parity(name, meta, bufs):
    ref = _same({n: impl.encode_body(meta, bufs) for n, impl in _impls()})
    for n, impl in _impls():
        m, views = impl.decode_body(ref)
        assert bytes(m) == bytes(meta), n
        assert [bytes(v) for v in views] == [bytes(b) for b in bufs], n
        assert all(isinstance(v, memoryview) for v in views), n  # zero-copy


@pytest.mark.parametrize("name,meta,bufs", BODIES, ids=[s[0] for s in BODIES])
def test_write_body_into_parity(name, meta, bufs):
    total = 8 + len(meta) + sum(8 + _nbytes(b) for b in bufs)
    outs = {}
    for n, impl in _impls():
        dest = bytearray(total)
        assert impl.write_body_into(dest, meta, bufs) == total
        outs[n] = bytes(dest)
    ref = _same(outs)
    for _, impl in _impls():
        assert impl.encode_body(meta, bufs) == ref


def test_write_body_into_short_dest_raises():
    for _, impl in _impls():
        with pytest.raises(ValueError):
            impl.write_body_into(bytearray(4), b"meta", [b"xx"])


def test_decode_body_truncated_raises():
    ref = fastpath.encode_body(b"meta", [b"payload" * 100])
    for _, impl in _impls():
        with pytest.raises(ValueError):
            impl.decode_body(ref[: len(ref) // 2])
        with pytest.raises(ValueError):
            impl.decode_body(b"\x00\x01")


def test_decode_body_huge_length_fields_raise():
    """A corrupt frame's enormous length fields raise on every backend,
    never wrap into out-of-bounds reads."""
    evil = (struct.pack("<I", 4) + b"meta" + struct.pack("<I", 1)
            + struct.pack("<Q", 0xFFFFFFFFFFFFFFF8) + b"x")
    evil_meta = struct.pack("<I", 0xFFFFFFF0) + b"m"
    for _, impl in _impls():
        with pytest.raises(ValueError):
            impl.decode_body(evil)
        with pytest.raises(ValueError):
            impl.decode_body(evil_meta)


@pytest.mark.parametrize("size", [0, 4, 8192, 100_000])
def test_build_frame_parity(size):
    body = bytes(range(256)) * (size // 256) + b"t" * (size % 256)
    ref = _same({n: impl.build_frame(42, 0x81, body) for n, impl in _impls()})
    for _, impl in _impls():
        assert impl.unpack_header(ref) == (len(body), 42, 0x81)
        assert ref[13:] == body


@pytest.mark.parametrize("index", [0, 1, 255, 2**32 - 1])
def test_id_from_index_parity(index):
    tid = TaskID.for_normal_task(JobID.from_int(7))
    ref = _same({n: impl.id_from_index(tid.binary(), index) for n, impl in _impls()})
    assert ref == ObjectID.from_index(tid, index).binary()
    assert ObjectID(ref).index() == index and ObjectID(ref).task_id() == tid


# ---- whole frames -----------------------------------------------------------
def _spec_payloads():
    """Task-spec wire payloads of every shape the submit path makes:
    by value, by reference, kwargs, a promoted big argument."""
    tid = TaskID.for_normal_task(JobID.from_int(3))
    aid = ActorID.of(JobID.from_int(3))
    oid = ObjectID.from_index(tid, 1)
    big = np.arange(64_000, dtype=np.uint8)
    return [
        {"task_id": tid.binary(), "function_name": "f", "args": [],
         "kwargs": {}, "num_returns": 1, "caller_addr": ("127.0.0.1", 1)},
        {"task_id": tid.binary(), "function_name": "g",
         "args": [{"is_ref": False, "value": b"v" * 10, "object_id": None,
                   "owner_addr": None}],
         "kwargs": {"k": {"is_ref": True, "value": None,
                          "object_id": oid.binary(),
                          "owner_addr": ("127.0.0.1", 2)}},
         "num_returns": 2, "attempt_number": 1},
        {"actor_id": aid.hex(), "task_id": tid.binary(),
         "method_name": "m", "args": [], "kwargs": {},
         "num_returns": 1, "streaming": False,
         "caller_addr": ("127.0.0.1", 3), "submit_ts": 123.25},
        {"task_id": tid.binary(), "function_name": "big",
         "args": [{"is_ref": False, "value": big, "object_id": None,
                   "owner_addr": None}], "kwargs": {}, "num_returns": 1},
    ]


@pytest.mark.parametrize("kind", [rpc.KIND_REQUEST, rpc.KIND_RESPONSE, rpc.KIND_ONEWAY])
@pytest.mark.parametrize("i", range(4))
def test_spec_frames_roundtrip_every_kind(kind, i):
    """The port's RPC body of each task-spec shape, framed under each
    kind by every backend into the same bytes, decodes to the payload."""
    payload = _spec_payloads()[i]
    flags, segs, total = rpc._encode_body(("PushTask", payload))
    body = b"".join(bytes(s) if isinstance(s, memoryview) else s for s in segs)
    assert total == len(body)
    _same({n: impl.build_frame(9, kind | flags, body) for n, impl in _impls()})
    for n, impl in _impls():
        if flags & rpc.KIND_OOB_FLAG:
            meta, bufs = impl.decode_body(body)
            method, decoded = pickle.loads(bytes(meta), buffers=bufs)
        else:
            method, decoded = pickle.loads(body)
        assert method == "PushTask"
        for key, val in payload.items():
            if key == "args" and val and isinstance(val[0].get("value"), np.ndarray):
                assert np.array_equal(decoded[key][0]["value"], val[0]["value"])
            else:
                assert decoded[key] == val, (n, key)


def test_module_backend_consistent():
    assert fastpath.backend() == fastpath.BACKEND
    assert fastpath.BACKEND in ("c", "python")
    assert fastpath.available_backends()[fastpath.BACKEND].BACKEND == fastpath.BACKEND
    for name in ("pack_header", "unpack_header", "encode_body", "decode_body",
                 "write_body_into", "build_frame", "id_from_index"):
        assert getattr(fastpath, name) is getattr(PORT[fastpath.BACKEND], name)


# ---- selection, in fresh interpreters -----------------------------------------
def _in_a_subprocess(code: str, mode: str, timeout=120):
    env = dict(os.environ, PYTHONPATH=ROOT, RAY_TPU_FASTPATH=mode, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-c", code], env=env, cwd="/",
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("mode,want", [("require", "c"), ("c", "c"), ("0", "python"),
                                       ("python", "python"), ("auto", "c")])
def test_mode_selects_backend_in_a_subprocess(mode, want):
    if want == "c" and fastpath.compiler() is None:
        pytest.skip("no C compiler on PATH")
    out = _in_a_subprocess(
        "import ray_tpu_torch._private.fastpath as f; print(f.backend(), f.pack_header(1, 2, 3).hex())",
        mode)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [want, "01000000020000000000000003"]


def test_auto_falls_back_with_one_warning_in_a_subprocess():
    """No compiler and no built extension (a build directory of its own):
    ``auto`` serves on the Python backend and says so once at WARNING;
    ``require`` raises."""
    code = ("import logging; logging.basicConfig(level=logging.WARNING); "
            "import os; os.environ['PATH'] = ''; "
            "import ray_tpu_torch._private.fastpath as f; print('backend', f.backend())")
    env = {"RAY_TPU_TORCH_FASTPATH_BUILD_DIR": "/nonexistent/fastpath_build"}
    for mode in ("auto", "require"):
        out = subprocess.run(
            [sys.executable, "-c", code], cwd="/", capture_output=True, text=True, timeout=120,
            env=dict(os.environ, PYTHONPATH=ROOT, RAY_TPU_FASTPATH=mode, **env))
        if mode == "auto":
            assert out.returncode == 0, out.stderr
            assert out.stdout.split() == ["backend", "python"]
            assert out.stderr.count("WARNING") == 1, out.stderr
            assert "no C compiler on PATH" in out.stderr
        else:
            assert out.returncode != 0
            assert "RAY_TPU_FASTPATH=require but the C extension is unavailable" in out.stderr


CLUSTER_CODE = """
import os
import numpy as np
import ray_tpu_torch as rt
from ray_tpu_torch._private import fastpath
assert fastpath.backend() == "c", fastpath.backend()
rt.init(num_cpus=2)
try:
    @rt.remote
    def f(x):
        from ray_tpu_torch._private import fastpath
        return x + 1, fastpath.backend(), os.environ.get("RAY_TPU_FASTPATH")

    @rt.remote
    class A:
        def m(self, x):
            from ray_tpu_torch._private import fastpath
            return x * 2, fastpath.backend()

    assert rt.get(f.remote(41), timeout=120) == (42, "c", "require")
    a = A.remote()
    assert rt.get(a.m.remote(21), timeout=120) == (42, "c")
    arr = np.arange(1 << 18, dtype=np.float32)  # 1 MB
    assert np.array_equal(rt.get(rt.put(arr), timeout=120), arr)
    assert rt.get(f.remote(rt.put(arr)), timeout=120)[0].sum() == (arr + 1).sum()
finally:
    rt.shutdown()
print("REQUIRE_CLUSTER_OK")
"""


def test_port_cluster_under_require_in_a_subprocess():
    """Every process of a port cluster (driver, GCS, raylet, workers)
    inherits ``require`` and serves tasks, an actor and a 1 MB put/get
    on the C codec."""
    if fastpath.compiler() is None:
        pytest.skip("no C compiler on PATH")
    out = _in_a_subprocess(CLUSTER_CODE, "require", timeout=180)
    assert "REQUIRE_CLUSTER_OK" in out.stdout, out.stdout + out.stderr[-4000:]


# ---- the sanitizer build ---------------------------------------------------------
def _libasan(cc: str):
    try:
        out = subprocess.run([cc, "-print-file-name=libasan.so"], capture_output=True,
                             text=True, timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    # an unresolved -print-file-name echoes the bare name back
    return out if out and os.path.sep in out and os.path.exists(out) else None


@pytest.mark.slow
def test_parity_under_asan(tmp_path):
    """``make SANITIZE=asan`` of the port's extension into a directory of
    its own, then this file's in-process parity cases in a child with
    libasan preloaded and ``RAY_TPU_FASTPATH=require``."""
    cc = os.environ.get("CC") or "gcc"
    if shutil.which(cc) is None:
        pytest.skip(f"no C compiler ({cc}) on PATH")
    libasan = _libasan(cc)
    if libasan is None:
        pytest.skip(f"{cc} lacks libasan (-print-file-name=libasan.so unresolved)")
    build_dir = str(tmp_path / "asan_build")
    built = subprocess.run(["make", "-C", CSRC, "SANITIZE=asan", f"CC={cc}",
                            f"PYTHON={sys.executable}", f"BUILD_DIR={build_dir}"],
                           capture_output=True, text=True, timeout=300)
    # libasan is present: a failing instrumented build is a regression
    assert built.returncode == 0, f"make SANITIZE=asan failed:\n{built.stderr[-2000:]}"
    env = dict(os.environ, LD_PRELOAD=libasan, RAY_TPU_FASTPATH="require",
               RAY_TPU_TORCH_FASTPATH_BUILD_DIR=build_dir, JAX_PLATFORMS="cpu",
               ASAN_OPTIONS="detect_leaks=0:abort_on_error=1:allocator_may_return_null=1")
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-m", "not slow",
         "-k", "not subprocess", os.path.abspath(__file__)],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    tail = (run.stdout + "\n" + run.stderr)[-4000:]
    assert run.returncode == 0, f"parity suite failed under ASan (rc={run.returncode}):\n{tail}"
    assert "ERROR: AddressSanitizer" not in run.stdout + run.stderr, tail
    assert " passed" in run.stdout and "skipped" not in run.stdout, tail


def test_sanitize_flag_rejects_unknown():
    out = subprocess.run(["make", "-C", CSRC, "SANITIZE=bogus", "-n"],
                         capture_output=True, text=True, timeout=60)
    assert out.returncode != 0 and "unknown SANITIZE" in out.stderr
