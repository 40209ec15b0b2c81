"""Sebulba's parts in process, held against the JAX package's on the CPU
(tests/test_podracer.py:43-195, no cluster):

- the fragment and weight codec (``codec.py``): packed vectors, unpacked
  fragments and params **bitwise** equal to JAX's;
- a pod actor (``_PodActorImpl``, the numpy policy over its two channel
  slots), given JAX's params through its weights channel and the same
  seed: every fragment **bit-equal** to JAX's pod actor's; the credit
  backpressure, a slow reader seeing every fragment once, the
  shape-drift fallback (TestBackpressure);
- a learner (``_PodLearnerImpl`` on the CPU) started from a JAX
  learner's params and Adam state as numpy (``rllib/convert.py``), after
  N updates on the same fragments, params and metrics within 2e-5 of
  JAX's learner's; ``sync_params``' flat vector bit-equal to the one
  JAX's lays out with ``jax.tree.flatten``; a checkpoint restoring
  params, the port's Adam layout and ``updates`` bit for bit.
"""

import dataclasses
import functools
import threading
import time
import uuid

import jax
import numpy as np
import pytest
import torch

from ray_tpu.experimental import channel as jchannel
from ray_tpu.rllib.podracer import codec as jcodec
from ray_tpu.rllib.podracer import sebulba as jseb
from ray_tpu.rllib.ppo import init_policy
from ray_tpu_torch.experimental import channel as tchannel
from ray_tpu_torch.rllib.podracer import codec as tcodec
from ray_tpu_torch.rllib.podracer import sebulba as tseb
from ray_tpu_torch.rllib.rollout import worker_seed

TOL = 2e-5
HIDDEN = (32,)
OBS, ACTS = 4, 2


def make_fragment(spec, seed=0):
    rng = np.random.RandomState(seed)
    t, d = spec.num_steps, spec.obs_dim
    return {"obs": rng.rand(t, d).astype(np.float32),
            "actions": rng.randint(0, 2, t).astype(np.int32),
            "rewards": np.ones(t, np.float32), "terminateds": rng.rand(t) < 0.1,
            "truncs": np.zeros(t, bool), "logp": -rng.rand(t).astype(np.float32),
            "last_obs": rng.rand(d).astype(np.float32)}


@functools.lru_cache(maxsize=None)
def jax_params(hidden=HIDDEN, seed=0):
    p = init_policy(jax.random.key(seed), OBS, ACTS, hidden)
    return jax.tree.map(np.asarray, p)


# ---- the codec ----------------------------------------------------------------------
@pytest.mark.parametrize("num_steps,obs_dim", [(32, 4), (7, 3), (1, 1)])
def test_codec_bitwise(num_steps, obs_dim):
    spec, jspec = (m.FragmentSpec(num_steps, obs_dim) for m in (tcodec, jcodec))
    assert spec.flat_size == jspec.flat_size and spec.to_dict() == jspec.to_dict()
    for seed in range(3):
        frag = make_fragment(spec, seed)
        vec, jvec = spec.pack(frag, 5 + seed), jspec.pack(frag, 5 + seed)
        np.testing.assert_array_equal(vec, jvec)
        (kind, idx, out), (jkind, jidx, jout) = spec.unpack(vec), jspec.unpack(jvec)
        assert (kind, idx) == (jkind, jidx) == (tcodec.KIND_DATA, 5 + seed)
        for k in jout:
            assert out[k].dtype == jout[k].dtype
            np.testing.assert_array_equal(out[k], jout[k])
            np.testing.assert_array_equal(out[k], np.asarray(frag[k]).astype(out[k].dtype))
    np.testing.assert_array_equal(spec.pack_eos(9), jspec.pack_eos(9))
    assert spec.unpack(spec.pack_eos(9)) == (tcodec.KIND_EOS, 9, None)
    bad = dict(make_fragment(spec), obs=np.zeros((num_steps + 1, obs_dim), np.float32))
    for s in (spec, jspec):
        with pytest.raises(ValueError):
            s.pack(bad, 0)


@pytest.mark.parametrize("hidden", [(32,), (64, 64), (8, 16, 8)])
def test_params_codec_bitwise(hidden):
    net = jax_params(hidden)["pi"]
    assert tcodec.flat_param_size(OBS, hidden, ACTS) == jcodec.flat_param_size(OBS, hidden, ACTS)
    vec = tcodec.pack_params(net, OBS, hidden, ACTS, version=7)
    np.testing.assert_array_equal(vec, jcodec.pack_params(net, OBS, hidden, ACTS, version=7))
    version, out = tcodec.unpack_params(vec, OBS, hidden, ACTS)
    jversion, jout = jcodec.unpack_params(vec, OBS, hidden, ACTS)
    assert version == jversion == 7 and list(out) == list(jout)
    for k in net:
        np.testing.assert_array_equal(out[k], jout[k])
        np.testing.assert_array_equal(out[k], net[k])


# ---- the pod actor ------------------------------------------------------------------
def inproc_actor(mod, chan, uid, num_steps=16, obs_dim=OBS, hidden=HIDDEN,
                 enqueue_timeout_s=10.0, seed=None):
    """A pod actor of ``mod`` wired to in-process channels, JAX's init
    weights already published (the transport, minus the cluster)."""
    codec = tcodec if mod is tseb else jcodec
    spec = codec.FragmentSpec(num_steps=num_steps, obs_dim=obs_dim)
    uid = f"tpod{uid}{uuid.uuid4().hex[:8]}"
    slots = [chan.TensorChannel((spec.flat_size,), "float32", num_readers=1,
                                name=f"{uid}s{k}") for k in range(2)]
    weights = chan.TensorChannel((1 + codec.flat_param_size(OBS, hidden, ACTS),), "float32",
                                 name=f"{uid}w")
    actor = mod._PodActorImpl("CartPole-v1", hidden,
                              seed=worker_seed(0, 0) if seed is None else seed,
                              actor_index=0, frag_spec=spec.to_dict(),
                              enqueue_timeout_s=enqueue_timeout_s)
    actor.attach_stream(slots, weights.reader(0))
    weights.write(codec.pack_params(jax_params(hidden)["pi"], OBS, hidden, ACTS, version=1),
                  timeout=5.0)
    return actor, spec, slots, weights


def close(*chans):
    for ch in chans:
        ch.close()


def test_pod_actor_fragments_bit_equal_jax():
    """Both pod actors pump the same fragment indices with the same seed
    and weights: the packed vectors in their slots are bit-equal, and the
    reports agree but for the stage timings."""
    sides = [inproc_actor(tseb, tchannel, "eqt", hidden=(64, 64)),
             inproc_actor(jseb, jchannel, "eqj", hidden=(64, 64))]
    try:
        readers = [[s.reader(0) for s in slots] for _a, _s, slots, _w in sides]
        for _ in range(3):
            reps = [a.pump(2) for a, *_ in sides]
            for k in (0, 1):
                vec, jvec = (rd[k].read(timeout=5.0) for rd in readers)
                np.testing.assert_array_equal(vec, jvec)
            for r in reps:
                r.pop("stage_s")
            assert reps[0] == reps[1] and reps[0]["fragments"] == 2
    finally:
        for _a, _s, slots, w in sides:
            close(*slots, w)


def test_writer_lead_is_bounded_by_credits():
    actor, _spec, slots, weights = inproc_actor(tseb, tchannel, "bp1", enqueue_timeout_s=0.3)
    try:
        out = actor.pump(4)
        assert out["stalled"] and out["fragments"] == 2 and out["next_frag_index"] == 2
    finally:
        close(*slots, weights)


def test_slow_reader_sees_every_fragment_once():
    actor, spec, slots, weights = inproc_actor(tseb, tchannel, "bp2", enqueue_timeout_s=20.0)
    readers = [s.reader(0) for s in slots]
    n, result, seen = 8, {}, []
    t = threading.Thread(target=lambda: result.update(actor.pump(n)), daemon=True)
    t.start()
    try:
        for i in range(n):
            time.sleep(0.05)
            kind, idx, frag = spec.unpack(readers[i % 2].read(timeout=20.0))
            assert kind == tcodec.KIND_DATA and frag["obs"].shape == (spec.num_steps, 4)
            seen.append(idx)
        t.join(timeout=30)
        assert not t.is_alive()
    finally:
        close(*slots, weights)
    assert seen == list(range(n))
    assert not result["stalled"] and result["fragments"] == n


def test_shape_drift_falls_back_to_object_path():
    actor, _spec, slots, weights = inproc_actor(tseb, tchannel, "fb1", obs_dim=6, seed=0)
    try:
        out = actor.pump(2)
        assert out["fragments"] == 0 and len(out["fallback"]) == 2
        assert [f["frag_index"] for f in out["fallback"]] == [0, 1]
        assert out["fallback"][0]["frag"]["obs"].shape == (16, 4)
    finally:
        close(*slots, weights)


# ---- the learner --------------------------------------------------------------------
CFG = dataclasses.asdict(tseb.SebulbaConfig(rollout_fragment_length=16, hidden=(64, 64)))


def learners(tmp=""):
    """JAX's learner one update in (so its Adam state is not the initial
    one), and the port's on the CPU from its params and Adam state as
    numpy."""
    spec = tcodec.FragmentSpec(16, OBS)
    jl = jseb._PodLearnerImpl(dict(CFG), OBS, ACTS)
    jl._update(make_fragment(spec, 100))
    tl = tseb._PodLearnerImpl(dict(CFG), OBS, ACTS, device="cpu", checkpoint_dir=tmp)
    tl.inner.set_weights(jl.get_params_np(), jax.tree.map(np.asarray, jl.inner.opt_state))
    tl.updates, tl.frames = jl.updates, jl.frames
    return jl, tl, spec


def max_diff(a, b):
    return max(float(np.max(np.abs(np.asarray(a[k][n]) - np.asarray(b[k][n]))))
               for k in a for n in a[k])


def test_learner_matches_jax_after_updates():
    jl, tl, spec = learners()
    assert tl.device == torch.device("cpu")
    for i in range(5):
        frag = make_fragment(spec, i)
        jl._update(frag)
        tl._update(frag)
        for k, v in jl._last_metrics.items():
            assert abs(tl._last_metrics[k] - float(v)) <= TOL * max(1.0, abs(float(v))), k
    assert max_diff(tl.get_params_np(), jl.get_params_np()) <= TOL
    js, ts = jl.stats(), tl.stats()
    for k in ("updates", "frames", "weights_version", "order_errors", "live_streams"):
        assert ts[k] == js[k], k


def test_adam_state_forms_agree():
    """JAX's Adam state converts alike from optax's tuple and from its
    ``ScaleByAdamState`` alone, and anything else is refused."""
    from ray_tpu_torch.rllib.convert import adam_state_from_jax

    jl, _tl, _spec = learners()
    jstate = jax.tree.map(np.asarray, jl.inner.opt_state)
    whole, alone = adam_state_from_jax(jstate, "cpu"), adam_state_from_jax(jstate[0], "cpu")
    for x, y in zip(tseb.flat_leaves(whole), tseb.flat_leaves(alone)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    with pytest.raises(TypeError, match="not an optax.adam state"):
        adam_state_from_jax({"mu": {}}, "cpu")


def test_sync_params_flat_vector_equals_jax():
    jl, tl, _spec = learners()
    leaves, _ = jax.tree.flatten(jl.inner.params)
    jflat = np.concatenate([np.asarray(x, np.float32).ravel() for x in leaves])
    np.testing.assert_array_equal(tseb.flat_params(tl.inner.params), jflat)
    assert [tuple(t.shape) for t in tseb.flat_leaves(tl.inner.params)] == \
        [tuple(np.shape(x)) for x in leaves]


def test_checkpoint_round_trip(tmp_path):
    ckpt = str(tmp_path / "rank0")
    _jl, tl, spec = learners(ckpt)
    for i in range(3):
        tl._update(make_fragment(spec, i))
    assert tl.save_checkpoint() == tl.updates == 4
    back = tseb._PodLearnerImpl(dict(CFG), OBS, ACTS, device="cpu", checkpoint_dir=ckpt)
    assert back.updates == 4
    for a, b in ((tl.inner.params, back.inner.params), (tl.inner.opt_state, back.inner.opt_state)):
        for x, y in zip(tseb.flat_leaves(a), tseb.flat_leaves(b)):
            assert x.dtype == y.dtype and torch.equal(x.detach(), y.detach())
    frag = make_fragment(spec, 9)
    tl._update(frag)
    back._update(frag)
    assert max_diff(tl.get_params_np(), back.get_params_np()) == 0.0
