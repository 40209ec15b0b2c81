"""The v2 collective stack's host layers, held against the JAX package's on
the same seeded numpy inputs (tests/test_collective_v2.py:25-260, no
cluster): the topology model, the policy's selection table, knob merge,
chunk sizes and quant gating, the segment and shard bounds, and the
int8 block codec and the exact codec, each **bitwise** equal to JAX's
(the modules are numpy: the port keeps its own copy), with the JAX
tests' own invariants asserted on the port's.
"""

import warnings

import numpy as np
import pytest

from ray_tpu.util.collective import v2 as jv2
from ray_tpu.util.collective.types import ReduceOp as JReduceOp
from ray_tpu_torch.util.collective import v2
from ray_tpu_torch.util.collective.types import ReduceOp
from ray_tpu_torch.util.collective.v2 import quant as quant_mod

POLICY = dict(channels_enabled=True, channel_max_bytes=2 << 20, pipe_chunk_bytes=1 << 20,
              algo="auto", quant_mode="off", quant_min_bytes=1 << 20, quant_block=512,
              small_max_bytes=64 << 10, hier_min_bytes=256 << 10)
KEYS = {"one": ["h", "h"], "four": ["h"] * 4, "xh": ["a", "a", "b", "b"],
        "skew": ["a", "a", "b"], "interleaved": ["a", "b", "a", "b"], "eight": ["h"] * 8}


def pols(**kw):
    return v2.GroupPolicy(**dict(POLICY, **kw)), jv2.GroupPolicy(**dict(POLICY, **kw))


# ---- topology -------------------------------------------------------------------
@pytest.mark.parametrize("keys", list(KEYS))
def test_topology_matches_jax(keys):
    for rank in range(len(KEYS[keys])):
        t, j = v2.Topology(rank, KEYS[keys]), jv2.Topology(rank, KEYS[keys])
        for attr in ("hosts", "n_hosts", "local_peers", "local_rank", "local_world",
                     "single_host", "uniform", "is_local_leader", "my_host"):
            assert getattr(t, attr) == getattr(j, attr), (keys, rank, attr)
        assert t.describe() == j.describe() and repr(t) == repr(j)
        for h in t.hosts:
            assert t.leader(h) == j.leader(h) and t.local_ranks(h) == j.local_ranks(h)
        if t.uniform:
            for li in range(t.local_world):
                assert t.counterparts(li) == j.counterparts(li)


def test_topology_cases():
    """TestTopology's cases on the port's model."""
    t = v2.Topology(3, KEYS["xh"])
    assert not t.single_host and t.uniform and t.n_hosts == 2
    assert t.local_rank == 1 and t.local_peers == (2, 3)
    assert t.leader("b") == 2 and not t.is_local_leader
    assert t.counterparts() == (1, 3) and t.counterparts(0) == (0, 2)
    assert not v2.Topology(0, KEYS["skew"]).uniform
    t = v2.Topology(2, KEYS["interleaved"])
    assert t.local_peers == (0, 2) and t.local_rank == 1 and t.counterparts() == (2, 3)


# ---- the selection table, merge, chunks, quant gating -----------------------------
SIZES = [0, 1 << 10, 8 << 10, 32 << 10, 64 << 10, (64 << 10) + 1, 255 << 10, 256 << 10,
         1 << 20, 2 << 20, (2 << 20) + 1, 8 << 20]
OVERRIDES = [{}, {"algo": "flat"}, {"algo": "hier"}, {"channels_enabled": False},
             {"small_max_bytes": 1 << 20}, {"hier_min_bytes": 4 << 20}]
OPS = ["allreduce", "allgather", "reducescatter", "broadcast"]


@pytest.mark.parametrize("override", range(len(OVERRIDES)))
def test_selection_table_matches_jax(override):
    mine, theirs = pols(**OVERRIDES[override])
    n = 0
    for keys in KEYS.values():
        for rank in range(len(keys)):
            t, j = v2.Topology(rank, keys), jv2.Topology(rank, keys)
            for nbytes in SIZES:
                for dt in (np.float32, np.int64, np.bool_, np.object_):
                    for op in OPS:
                        assert v2.select_algorithm(nbytes, dt, t, mine, op) == \
                            jv2.select_algorithm(nbytes, dt, j, theirs, op), \
                            (keys, rank, nbytes, dt, op)
                        n += 1
    assert n == sum(len(k) for k in KEYS.values()) * len(SIZES) * 4 * len(OPS)


def test_selection_table_cases():
    """TestPolicy.test_selection_table's rows on the port's table."""
    pol, _ = pols()
    one, four, xh = (v2.Topology(0, KEYS[k]) for k in ("one", "four", "xh"))
    sel = v2.select_algorithm
    assert sel(1 << 10, np.float32, one, pol) == "channel"
    assert sel(8 << 20, np.float32, one, pol) == "pipe"
    assert sel(32 << 10, np.float32, four, pol) == "channel"
    assert sel(1 << 20, np.float32, four, pol) == "hier"
    assert sel(1 << 20, np.float32, xh, pol) == "hier"
    assert sel(8 << 10, np.float32, xh, pol) == "object"
    assert sel(1 << 20, np.float32, v2.Topology(0, KEYS["skew"]), pol) == "object"
    assert sel(1 << 20, np.float32, four, pols(algo="flat")[0]) == "channel"
    assert sel(1 << 10, np.float32, four, pols(algo="hier")[0]) == "hier"
    assert sel(1 << 20, np.float32, four, pols(channels_enabled=False)[0]) == "object"
    assert sel(1 << 20, np.object_, four, pol) == "object"
    for kind in ("reducescatter", "broadcast"):
        assert sel(1 << 10, np.float32, four, pol, kind) == "hier"
        assert sel(1 << 20, np.float32, xh, pol, kind) == "hier"
        assert sel(8 << 10, np.float32, xh, pol, kind) == "object"
        assert sel(1 << 20, np.float32, four, pols(algo="flat")[0], kind) == "object"
    assert sel(8 << 20, np.float32, xh, pol, "allgather") == "object"
    assert sel(8 << 20, np.float32, four, pol, "allgather") == "hier"


ENV = {"RAY_TPU_COLLECTIVE_ALGO": "hier", "RAY_TPU_COLLECTIVE_QUANT": "int8",
       "RAY_TPU_COLLECTIVE_QUANT_MIN_BYTES": "65536", "RAY_TPU_COLLECTIVE_QUANT_BLOCK": "128",
       "RAY_TPU_COLLECTIVE_OP_TIMEOUT_S": "8", "RAY_TPU_COLLECTIVE_WAN_GBPS": "4",
       "RAY_TPU_COLLECTIVE_OVERLAP": "0", "RAY_TPU_COLLECTIVE_OVERLAP_BLOCK_BYTES": "32768",
       "RAY_TPU_COLLECTIVE_CHANNELS": "0", "RAY_TPU_COLLECTIVE_PIPE_CHUNK_BYTES": "12",
       "RAY_TPU_COLLECTIVE_SMALL_MAX_BYTES": "not a number"}


@pytest.mark.parametrize("env", ["default", "set"])
def test_knobs_and_merge_match_jax(env, monkeypatch):
    """The environment knobs under the same names give the same tuple, and
    every merge of two ranks' knobs the same agreed policy."""
    if env == "set":
        for k, val in ENV.items():
            monkeypatch.setenv(k, val)
    a = v2.local_knobs()
    assert a == jv2.local_knobs()
    base = list(a)
    variants = [base]
    for i, alt in ((3, "flat"), (3, "hier"), (4, "off"), (4, "int8"), (5, 4 << 20),
                   (9, 0.5), (10, 0.0), (10, 2.0), (11, False), (13, 1 << 20)):
        v = list(base)
        v[i] = alt
        variants.append(v)
    for x in variants:
        for y in variants:
            assert v2.merge_knobs([x, y]).__dict__ == jv2.merge_knobs([x, y]).__dict__


def test_merge_is_conservative():
    a = list(v2.local_knobs())
    b = list(a)
    a[3], b[3] = "hier", "flat"
    a[4], b[4] = "int8", "int8"
    a[5], b[5] = 1 << 20, 4 << 20
    pol = v2.merge_knobs([tuple(a), tuple(b)])
    assert (pol.algo, pol.quant_mode, pol.quant_min_bytes) == ("flat", "int8", 4 << 20)
    b[4] = "off"
    assert v2.merge_knobs([tuple(a), tuple(b)]).quant_mode == "off"


def test_chunks_and_quant_gating_match_jax():
    mine, theirs = pols(quant_mode="int8")
    for nbytes in SIZES + [3 << 20, 64 << 20]:
        for world in (1, 2, 3, 4, 8, 16):
            assert v2.chunk_bytes_for(nbytes, world, mine) == \
                jv2.chunk_bytes_for(nbytes, world, theirs)
    pol, _ = pols()
    assert v2.chunk_bytes_for(8 << 20, 2, pol) == 1 << 20
    assert v2.chunk_bytes_for(256 << 10, 2, pol) == 64 << 10
    assert v2.chunk_bytes_for(8 << 20, 8, pol) == 256 << 10
    four, jfour = v2.Topology(0, KEYS["four"]), jv2.Topology(0, KEYS["four"])
    for quant in ("int8", "off"):
        mine, theirs = pols(quant_mode=quant)
        for nbytes in (8 << 10, 1 << 20, 2 << 20):
            for dt in (np.float32, np.float64, np.int32):
                for op in ReduceOp:
                    c = v2.quant_codec_for(nbytes, dt, op, four, mine)
                    j = jv2.quant_codec_for(nbytes, dt, JReduceOp(op.value), jfour, theirs)
                    assert (c is None) == (j is None)
                    if c is not None:
                        assert (c.block, c.dtype) == (j.block, j.dtype)
    pol, _ = pols(quant_mode="int8")
    assert isinstance(v2.quant_codec_for(2 << 20, np.float32, ReduceOp.SUM, four, pol),
                      v2.Int8BlockCodec)
    assert v2.quant_codec_for(2 << 20, np.float32, ReduceOp.MAX, four, pol) is None


# ---- bounds -------------------------------------------------------------------------
@pytest.mark.parametrize("parts", [2, 3, 4, 8])
def test_bounds_match_jax(parts):
    for n in (0, 1, 7, 100000, 100003):
        for align in (1, 128, 512):
            assert v2.seg_bounds(n, parts, align) == jv2.seg_bounds(n, parts, align)
    b = v2.seg_bounds(100000, parts, align=512)
    assert b[0] == 0 and b[-1] == 100000 and b == sorted(b)
    assert all(x % 512 == 0 for x in b[1:-1])
    for shape in [(10, 3), (7,), (13, 2, 2), (3, 5)]:
        offs, shapes = v2.shard_bounds(shape, parts)
        assert (offs, shapes) == jv2.shard_bounds(shape, parts)
        arr = np.arange(int(np.prod(shape))).reshape(shape)
        for i, r in enumerate(np.array_split(arr, parts, axis=0)):
            np.testing.assert_array_equal(arr.reshape(-1)[offs[i]:offs[i + 1]].reshape(shapes[i]),
                                          r)
    for dt in (np.float32, np.int8, np.uint16, np.bool_):
        for op in ReduceOp:
            assert v2.acc_dtype(dt, op) == jv2.acc_dtype(dt, JReduceOp(op.value))
    with pytest.raises(ValueError):
        v2.shard_bounds((), parts)


# ---- the int8 codec, bitwise ----------------------------------------------------------
def adversarial(case: str) -> np.ndarray:
    rng = np.random.RandomState(list(CODEC_CASES).index(case))
    if case == "randn":
        return (rng.randn(100003) * 100).astype(np.float32)
    if case == "short":
        return (rng.randn(129) * 3).astype(np.float32)
    if case == "outlier":
        x = np.ones(256, np.float32)
        x[10] = 1e8
        return x
    if case == "denormal":
        return np.full(128, 1e-40, np.float32)
    if case == "zeros":
        return np.zeros(384, np.float32)
    if case == "mixed":
        x = np.zeros(1024, np.float32)
        x[0] = 3e7
        x[100:128] = -1e-39
        x[300:420] = np.linspace(-5, 5, 120, dtype=np.float32)
        x[700] = np.float32(np.finfo(np.float32).tiny)
        return x
    if case == "nonfinite":
        x = np.ones(384, np.float32)
        x[10], x[200] = np.inf, np.nan
        return x
    return rng.randn(999)  # float64


CODEC_CASES = {"randn": 128, "short": 128, "outlier": 128, "denormal": 128, "zeros": 128,
               "mixed": 128, "nonfinite": 128, "float64": 512}


def encode(mod, x, block, lo=0, hi=None):
    c = mod.Int8BlockCodec(x.dtype, block=block)
    buf = np.zeros(c.wire_nbytes(x.size), np.uint8)
    c.encode_into(x, memoryview(buf), lo, x.size if hi is None else hi)
    return c, buf


@pytest.mark.parametrize("case", list(CODEC_CASES))
def test_int8_codec_bitwise(case):
    """Wire bytes, decoded values (added into a buffer too) and the error
    bound equal JAX's bit for bit; the roundtrip within the bound."""
    x, block = adversarial(case), CODEC_CASES[case]
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no undefined-cast warnings
        c, buf = encode(v2, x, block)
        j, jbuf = encode(jv2, x, block)
        np.testing.assert_array_equal(buf, jbuf)
        y = c.decode_slice(memoryview(buf), x.size, 0, x.size)
        np.testing.assert_array_equal(y, j.decode_slice(memoryview(jbuf), x.size, 0, x.size))
        out, jout = np.full(x.size, 5.0, y.dtype), np.full(x.size, 5.0, y.dtype)
        c.decode_slice(memoryview(buf), x.size, 0, x.size, out=out, add=True)
        j.decode_slice(memoryview(jbuf), x.size, 0, x.size, out=jout, add=True)
        np.testing.assert_array_equal(out, jout)
    for steps in (1, quant_mod.QUANT_STEPS_SINGLE_HOST, quant_mod.QUANT_STEPS_MULTI_HOST):
        b = v2.sum_error_bound([x, x], block, steps=steps)
        with np.errstate(invalid="ignore"):
            np.testing.assert_array_equal(b, jv2.sum_error_bound([x, x], block, steps=steps))
    np.testing.assert_array_equal(v2.block_amax(x, block), jv2.block_amax(x, block))
    if case == "nonfinite":
        assert np.all(np.isnan(y[:256])) and np.allclose(y[256:], 1.0, rtol=0.01)
    else:
        assert np.all(np.abs(x - y) <= v2.sum_error_bound([x], block, steps=1))
    if case == "denormal":
        assert np.all(y == 0.0)
    if case in ("zeros", "outlier"):
        assert np.all(y[128:] == x[128:]) if case == "zeros" else np.allclose(y[128:], 1.0,
                                                                              rtol=0.01)
    assert (v2.QUANT_RTOL, quant_mod.DEFAULT_BLOCK) == (jv2.QUANT_RTOL,
                                                        jv2.quant.DEFAULT_BLOCK)


def test_range_encode_and_exact_codec_bitwise():
    x = (np.random.RandomState(2).randn(512) * 3).astype(np.float32)
    bufs = []
    for mod in (v2, jv2):
        c = mod.Int8BlockCodec(np.float32, block=128)
        buf = np.zeros(c.wire_nbytes(512), np.uint8)
        c.encode_into(x, memoryview(buf), 0, 128)
        c.encode_into(x, memoryview(buf), 256, 512)
        bufs.append((buf, c.decode_slice(memoryview(buf), 512, 256, 512)))
    np.testing.assert_array_equal(bufs[0][0], bufs[1][0])
    np.testing.assert_array_equal(bufs[0][1], bufs[1][1])
    assert np.all(np.abs(x[256:] - bufs[0][1]) <= v2.sum_error_bound([x], 128, steps=1)[256:])
    for dt in (np.float32, np.int64, np.int8):
        x = np.arange(-50, 50).astype(dt)
        got = []
        for mod in (v2, jv2):
            c = mod.ExactCodec(dt)
            buf = np.empty(c.wire_nbytes(x.size), np.uint8)
            c.encode_into(x, memoryview(buf))
            got.append((buf, c.decode_slice(memoryview(buf), x.size, 7, 63)))
        np.testing.assert_array_equal(got[0][0], got[1][0])
        np.testing.assert_array_equal(got[0][1], x[7:63])
        np.testing.assert_array_equal(got[1][1], x[7:63])
