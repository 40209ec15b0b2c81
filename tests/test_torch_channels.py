"""The port's channels (ray_tpu_torch.experimental) held against the JAX
package's (ray_tpu/experimental/channel.py, rdt.py) on the CPU.

Every case of tests/test_channels.py's TestLocal, TestCrossProcess and
TestTensorChannel is written once as a function of ``P`` (a namespace of
one package's ``rt``, ``experimental`` and ``rdt``) and run on both
packages, with its payloads drawn from one numpy seed; the outcomes
(values, or exception classes and messages) must be equal. The
cross-process cases run on one cluster of each package (module-scoped,
JAX's with the cyclic collector paused, ROADMAP.md Queue C). Unlike
tests/test_channels.py, a driver writes only after the reading actor is
live (its ``ready`` call returned), and every write names its timeout.

Then what only the port has: ``TensorChannel.write`` of a CPU
torch.Tensor, bfloat16 through ``rdt.DeviceTensorChannel`` between
processes bit for bit (and bit-equal to JAX's bf16 wire), and a killed
reader process leaving the writer's segment mapped and readable.
"""

import contextlib
import gc
import os
import threading
import time
import types

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.experimental
import ray_tpu.experimental.rdt
import ray_tpu_torch
import ray_tpu_torch.experimental
import ray_tpu_torch.experimental.rdt

JAX = types.SimpleNamespace(name="jax", rt=ray_tpu, exp=ray_tpu.experimental,
                            rdt=ray_tpu.experimental.rdt)
TORCH = types.SimpleNamespace(name="torch", rt=ray_tpu_torch, exp=ray_tpu_torch.experimental,
                              rdt=ray_tpu_torch.experimental.rdt)
SEED = 0


def outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the outcome is the exception
        return (type(e).__name__, str(e).replace("ray_tpu_torch", "ray_tpu"))


def both(case):
    """``case`` on JAX's package, then on the port's: equal outcomes."""
    ref, port = (outcome(lambda P=P: case(P)) for P in (JAX, TORCH))
    assert port == ref
    return port


@contextlib.contextmanager
def collector_paused():
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


@pytest.fixture(scope="module")
def clusters():
    with collector_paused():
        for P in (JAX, TORCH):
            P.rt.init(num_cpus=4)
        # both zygotes boot (jax's and torch's imports) side by side
        refs = [(P, P.rt.remote(lambda: 1).remote()) for P in (JAX, TORCH)]
        assert [P.rt.get(r, timeout=120) for P, r in refs] == [1, 1]
        yield
        for P in (JAX, TORCH):
            P.rt.shutdown()


# ---- TestLocal --------------------------------------------------------------
def write_read_roundtrip(P):
    rng = np.random.default_rng(SEED)
    value = {"a": int(rng.integers(100)), "b": rng.integers(0, 9, 3).tolist()}
    ch = P.exp.Channel(capacity=1 << 16)
    r = ch.reader()
    ch.write(value, timeout=10)
    got = r.read(timeout=10)
    ch.close()
    return got


def in_place_rewrite_many_values(P):
    values = np.random.default_rng(SEED).integers(0, 1 << 30, 100).tolist()
    ch = P.exp.Channel(capacity=1 << 16)
    r = ch.reader()
    got = []

    def consume():
        for _ in range(100):
            got.append(r.read(timeout=30))

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    for v in values:
        ch.write(v, timeout=30)
    t.join(timeout=30)
    ch.close()
    return got == values, t.is_alive()


def backpressure_blocks_writer(P):
    ch = P.exp.Channel(capacity=1 << 16)
    ch.reader()  # never reads
    ch.write("first", timeout=10)  # slot empty: ok
    try:
        ch.write("second", timeout=0.3)
        return "wrote"
    except P.exp.ChannelTimeoutError as e:
        return type(e).__name__, str(e)
    finally:
        ch.close()


def reader_timeout(P):
    ch = P.exp.Channel(capacity=1 << 16)
    r = ch.reader()
    try:
        r.read(timeout=0.3)
    finally:
        ch.close()


def capacity_enforced(P):
    ch = P.exp.Channel(capacity=64)
    try:
        ch.write(np.zeros(1024), timeout=10)
    finally:
        ch.close()


def two_readers_each_get_every_value(P):
    values = np.random.default_rng(SEED + 1).integers(0, 1000, 20).tolist()
    ch = P.exp.Channel(capacity=1 << 16, num_readers=2)
    r0, r1 = ch.reader(0), ch.reader(1)
    got0, got1 = [], []

    def consume(r, out):
        for _ in range(20):
            out.append(r.read(timeout=30))

    threads = [threading.Thread(target=consume, args=a, daemon=True)
               for a in ((r0, got0), (r1, got1))]
    for t in threads:
        t.start()
    for v in values:
        ch.write(v, timeout=30)
    for t in threads:
        t.join(timeout=30)
    ch.close()
    return got0 == got1 == values, [t.is_alive() for t in threads]


def reader_index_out_of_range(P):
    ch = P.exp.Channel(capacity=64, num_readers=2)
    try:
        ch.reader(2)
    finally:
        ch.close()


LOCAL = [write_read_roundtrip, in_place_rewrite_many_values, backpressure_blocks_writer,
         reader_timeout, capacity_enforced, two_readers_each_get_every_value,
         reader_index_out_of_range]


@pytest.mark.parametrize("case", LOCAL, ids=[c.__name__ for c in LOCAL])
def test_local_cases_match_jax(case):
    got = both(case)
    if case in (in_place_rewrite_many_values, two_readers_each_get_every_value):
        assert got[1][0] is True, got


# ---- TestTensorChannel (in process) -------------------------------------------
def typed_roundtrip(P):
    x = np.random.default_rng(SEED).standard_normal((16, 16)).astype(np.float32)
    ch = P.exp.TensorChannel((16, 16), "float32")
    r = ch.reader()
    ch.write(x, timeout=10)
    got = r.read(timeout=10)
    ch.close()
    return got.dtype.name, got.tobytes() == x.tobytes()


def shape_dtype_enforced(P):
    ch = P.exp.TensorChannel((4,), "float32")
    errs = []
    for bad in (np.zeros(5, np.float32), np.zeros(4, np.int64)):
        errs.append(outcome(lambda: ch.write(bad, timeout=10)))
    ch.close()
    return errs


def read_view_borrows_the_slot(P):
    """A borrowed view holds the writer off until it is released."""
    x = np.arange(8, dtype=np.float64)
    ch = P.exp.TensorChannel((8,), "float64")
    r = ch.reader()
    ch.write(x, timeout=10)
    view = r.read_view(timeout=10)
    blocked = outcome(lambda: ch.write(x + 1, timeout=0.3))
    seen = view.tolist()
    r.release()
    ch.write(x + 2, timeout=10)
    after = r.read(timeout=10).tolist()
    ch.close()
    return seen, blocked[0], after


TENSOR_LOCAL = [typed_roundtrip, shape_dtype_enforced, read_view_borrows_the_slot]


@pytest.mark.parametrize("case", TENSOR_LOCAL, ids=[c.__name__ for c in TENSOR_LOCAL])
def test_tensor_channel_cases_match_jax(case):
    both(case)


def test_faster_than_pickle_channel_for_big_arrays():
    """tests/test_channels.py's bound on the port: the typed channel's
    write path must not lose to pickling (a loose 2x bound — both paths
    are memcpy-bound)."""
    arr = np.ones((512, 512), np.float32)  # 1MB
    n = 60
    tch = ray_tpu_torch.experimental.TensorChannel(arr.shape, "float32")
    tr = tch.reader()
    t0 = time.perf_counter()
    for _ in range(n):
        tch.write(arr, timeout=10)
        tr.read(timeout=10)
    t_tensor = time.perf_counter() - t0
    tch.close()
    pch = ray_tpu_torch.experimental.Channel(capacity=arr.nbytes + 4096)
    pr = pch.reader()
    t0 = time.perf_counter()
    for _ in range(n):
        pch.write(arr, timeout=10)
        pr.read(timeout=10)
    t_pickle = time.perf_counter() - t0
    pch.close()
    assert t_tensor < t_pickle * 2.0


def chunk_pipe(P):
    """Chunks of seeded bytes through a two-slot pipe, the reader a
    thread that borrows each chunk and releases it."""
    rng = np.random.default_rng(SEED + 2)
    chunks = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
              for n in rng.integers(1, 4096, 12)]
    pipe = P.exp.ChunkPipe(chunk_bytes=4096)
    reader = P.exp.ChunkPipeReader(pipe.name, 4096)
    got = []

    def consume():
        for _ in chunks:
            got.append(bytes(reader.next_chunk(timeout=30)))
            reader.release_chunk()

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    for c in chunks:
        pipe.write_chunk(c, timeout=30)
    t.join(timeout=30)
    too_big = outcome(lambda: pipe.write_chunk(b"x" * 4097, timeout=1))
    reader.close()
    pipe.close()
    return got == chunks, t.is_alive(), too_big


def test_chunk_pipe_matches_jax():
    assert both(chunk_pipe)[1][:2] == (True, False)


def test_tensor_channel_takes_a_cpu_tensor():
    """A CPU tensor is written through its numpy view: the bytes equal the
    same values written as an ndarray into JAX's channel; a bfloat16 or
    wrongly shaped tensor raises."""
    x = np.random.default_rng(SEED).standard_normal((3, 5)).astype(np.float32)
    got = []
    for P, value in ((JAX, x), (TORCH, torch.from_numpy(x.copy()))):
        ch = P.exp.TensorChannel((3, 5), "float32")
        r = ch.reader()
        ch.write(value, timeout=10)
        got.append(r.read(timeout=10).tobytes())
        if P is TORCH:
            with pytest.raises(ValueError, match="bfloat16"):
                ch.write(torch.zeros(3, 5, dtype=torch.bfloat16), timeout=1)
            with pytest.raises(ValueError, match="expected"):
                ch.write(torch.zeros(5, 3), timeout=1)
        ch.close()
    assert got[0] == got[1] == x.tobytes()


# ---- TestCrossProcess and TestTensorChannel across processes ----------------
def driver_to_actor_stream(P):
    values = np.random.default_rng(SEED + 3).integers(0, 1000, 10).tolist()
    ch = P.exp.Channel(capacity=1 << 16)

    @P.rt.remote
    class Consumer:
        def __init__(self, reader):
            self.reader = reader
            self.total = 0

        def ready(self):
            return True

        def consume(self, n):
            for _ in range(n):
                self.total += self.reader.read(timeout=60)
            return self.total

    c = Consumer.remote(ch.reader())
    try:
        P.rt.get(c.ready.remote(), timeout=120)  # the reader is live
        fut = c.consume.remote(len(values))
        for v in values:
            ch.write(v, timeout=60)
        return P.rt.get(fut, timeout=120), sum(values)
    finally:
        P.rt.kill(c)
        ch.close()


def actor_to_actor_pipeline(P):
    """The compiled-DAG shape: stage A writes into a channel, stage B reads."""
    fills = np.random.default_rng(SEED + 4).integers(0, 100, 8).tolist()
    ch = P.exp.Channel(capacity=1 << 20)

    @P.rt.remote
    class Producer:
        def __init__(self, channel):
            self.ch = channel

        def produce(self, fills):
            import numpy as _np

            for f in fills:
                self.ch.write(_np.full(128, f), timeout=60)
            return len(fills)

    @P.rt.remote
    class Consumer:
        def __init__(self, reader):
            self.reader = reader

        def ready(self):
            return True

        def consume(self, n):
            s = 0.0
            for _ in range(n):
                s += float(self.reader.read(timeout=60).sum())
            return s

    p = Producer.remote(ch)
    c = Consumer.remote(ch.reader())
    try:
        P.rt.get(c.ready.remote(), timeout=120)
        fut = c.consume.remote(len(fills))
        n = P.rt.get(p.produce.remote(fills), timeout=120)
        return n, P.rt.get(fut, timeout=120)
    finally:
        P.rt.kill(p)
        P.rt.kill(c)
        ch.close()


def cross_process_tensor_stream(P):
    values = np.random.default_rng(SEED + 5).standard_normal(12).tolist()
    ch = P.exp.TensorChannel((64,), "float64")

    @P.rt.remote
    class Sink:
        def __init__(self, reader):
            self.r = reader

        def ready(self):
            return True

        def run(self, n):
            return [float(self.r.read(timeout=60).sum()) for _ in range(n)]

    s = Sink.remote(ch.reader())
    try:
        P.rt.get(s.ready.remote(), timeout=120)
        fut = s.run.remote(len(values))
        for v in values:
            ch.write(np.full(64, v), timeout=60)
        return P.rt.get(fut, timeout=120)
    finally:
        P.rt.kill(s)
        ch.close()


CROSS = [driver_to_actor_stream, actor_to_actor_pipeline, cross_process_tensor_stream]


@pytest.mark.parametrize("case", CROSS, ids=[c.__name__ for c in CROSS])
def test_cross_process_cases_match_jax(clusters, case):
    got = both(case)
    assert got[0] == "ok"
    if case is driver_to_actor_stream:
        assert got[1][0] == got[1][1]


def test_bfloat16_device_channel_between_processes_bit_exact(clusters):
    """An actor writes bfloat16 CPU tensors through rdt.DeviceTensorChannel;
    the driver reads them on the CPU (``device="cpu"``): the same bits as
    written, and as JAX's DeviceTensorChannel delivers for the same
    values."""
    src = np.random.default_rng(SEED + 6).standard_normal((3, 4, 16)).astype(np.float32) * 8
    ch = TORCH.rdt.DeviceTensorChannel((4, 16), torch.bfloat16)
    rd = ch.reader(0, device="cpu")

    @ray_tpu_torch.remote
    class Producer:
        def __init__(self, channel):
            self.ch = channel

        def send(self, rows):
            import torch as _torch

            for r in rows:
                self.ch.write(_torch.from_numpy(r).to(_torch.bfloat16), timeout=60)
            return len(rows)

    p = Producer.remote(ch)
    try:
        fut = p.send.remote(list(src))
        got = [rd.read(timeout=60) for _ in range(len(src))]
        assert ray_tpu_torch.get(fut, timeout=60) == len(src)
    finally:
        ray_tpu_torch.kill(p)
        ch.close()
    want = torch.from_numpy(src).to(torch.bfloat16)
    assert all(g.dtype == torch.bfloat16 and g.device.type == "cpu" for g in got)
    assert torch.equal(torch.stack(got).view(torch.int16), want.view(torch.int16))

    import jax.numpy as jnp

    jch = JAX.rdt.DeviceTensorChannel((4, 16), "bfloat16")
    jrd = jch.reader(0)
    jbits = []
    for r in src:
        jch.write(jnp.asarray(r, jnp.bfloat16), timeout=10)
        jbits.append(np.asarray(jrd.read(timeout=10)).view(np.int16))
    jch.close()
    assert np.array_equal(np.stack(jbits), want.view(torch.int16).numpy())


def test_killed_reader_leaves_the_segment_mapped(clusters):
    """A reader process attaches the writer's segment; killing it must
    not unlink the segment (the resource tracker of the process that
    attached would, cpython#82300): the writer keeps writing and a new
    reader reads."""
    rng = np.random.default_rng(SEED + 7)
    ch = TORCH.exp.TensorChannel((32,), "float64")
    path = f"/dev/shm/{ch.name}"

    @ray_tpu_torch.remote
    class Reader:
        def __init__(self, reader):
            self.r = reader

        def read(self):
            return self.r.read(timeout=60).tolist()

        def pid(self):
            return os.getpid()

    a = Reader.remote(ch.reader())
    try:
        x = rng.standard_normal(32)
        fut = a.read.remote()
        ch.write(x, timeout=60)
        assert ray_tpu_torch.get(fut, timeout=60) == x.tolist()
        pid = ray_tpu_torch.get(a.pid.remote(), timeout=60)
        ray_tpu_torch.kill(a)
        deadline = time.monotonic() + 30
        while os.path.exists(f"/proc/{pid}") and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not os.path.exists(f"/proc/{pid}")
        time.sleep(1.0)  # a tracker that would unlink does so on the reader's exit
        assert os.path.exists(path)
        y = rng.standard_normal(32)
        ch.write(y, timeout=10)  # the dead reader acked its value
        r = ch.reader()
        assert r.read(timeout=10).tolist() == y.tolist()
        r.close()
    finally:
        ch.close()
    assert not os.path.exists(path)  # the writer, which created it, unlinks it
