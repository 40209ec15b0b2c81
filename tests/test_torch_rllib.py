"""The port's RL learners (ray_tpu_torch.rllib) held against the JAX
package's on the CPU.

Both sides start from JAX's parameters (the port's through
``rllib/convert.py``: it cannot draw ``jax.random``'s bits) and take the
same numpy batches, made from a seed. Each learner runs 3–5 updates, the
first included (every head starts at zero, so its Q values and logits
tie); params and metrics are held within 2e-5 (absolute and relative,
tests/test_ops.py's fp32 tolerance). ``vtrace`` is held against
``vtrace_np`` and ``vtrace_jax`` as tests/test_rllib.py:118 holds them
(rtol 1e-5), ``Adam`` against ``optax.adam`` at 1e-6 relative (elementwise
math only). The numpy copies (GAE, the replay buffer, the JSON reader and
writer) give what the JAX package's give. Small nets: hidden (8,) or (16,).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ray_tpu.rllib as jrl
import ray_tpu_torch.rllib as trl
from ray_tpu.rllib import dqn as jdqn, impala as jimpala, ppo as jppo
from ray_tpu.rllib import sac as jsac
from ray_tpu_torch.rllib import dqn as tdqn, impala as timpala
from ray_tpu_torch.rllib import ppo as tppo, sac as tsac
from ray_tpu_torch.rllib.adam import Adam, tree_leaves
from ray_tpu_torch.rllib.convert import adam_state_from_jax, params_from_jax, to_numpy

TOL = dict(rtol=2e-5, atol=2e-5)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def assert_trees_close(port, ref, **tol):
    ref = dict(_flat(ref))
    got = dict(_flat(port))
    assert got.keys() == ref.keys()
    for path, a in got.items():
        np.testing.assert_allclose(a, ref[path], err_msg=path, **(tol or TOL))


def assert_metrics_close(port, ref):
    assert port.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(port[k], ref[k], err_msg=k, **TOL)


def _jax_cfg(jcls, tcfg):
    """The JAX config with the port config's fields."""
    return jcls(**{f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)})


# ---------------------------------------------------------------------------
# V-trace and Adam
# ---------------------------------------------------------------------------
def _vtrace_inputs(rng, shape):
    values = rng.randn(*shape)
    next_values = np.concatenate([values[1:], rng.randn(1, *shape[1:])])
    rewards = rng.randn(*shape)
    discounts = 0.97 * (rng.rand(*shape) > 0.1)
    rhos = np.exp(rng.randn(*shape) * 0.5)  # genuinely off-policy ratios
    return values, next_values, rewards, discounts, rhos


@pytest.mark.parametrize("shape", [(16,), (16, 5)], ids=["T", "TxB"])
@pytest.mark.parametrize("clip", [1.0, 0.8])
def test_vtrace_matches_numpy_and_jax(shape, clip):
    """T = 16 as tests/test_rllib.py:118; batched [T, B] column by column."""
    values, next_values, rewards, discounts, rhos = _vtrace_inputs(np.random.RandomState(1),
                                                                   shape)
    vs, pg = timpala.vtrace(*(torch.tensor(a, dtype=torch.float32) for a in
                              (values, next_values, rewards, discounts, rhos, rhos)),
                            rho_bar=clip, c_bar=clip)
    assert vs.dtype == pg.dtype == torch.float32 and vs.shape == shape
    cols = [slice(None)] if len(shape) == 1 else [(slice(None), b) for b in range(shape[1])]
    for col in cols:
        args = [a[col] for a in (values, next_values, rewards, discounts, rhos, rhos)]
        vs_np, pg_np = jimpala.vtrace_np(*args, rho_bar=clip, c_bar=clip)
        vs_j, pg_j = jimpala.vtrace_jax(*map(jnp.asarray, args), rho_bar=clip, c_bar=clip)
        np.testing.assert_allclose(vs[col].numpy(), vs_np, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(pg[col].numpy(), pg_np, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(vs[col].numpy(), np.asarray(vs_j), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(pg[col].numpy(), np.asarray(pg_j), rtol=1e-5, atol=1e-6)
    # the numpy copy is the JAX package's
    np.testing.assert_array_equal(trl.vtrace_np(*[a[cols[0]] for a in (
        values, next_values, rewards, discounts, rhos, rhos)])[0],
        jimpala.vtrace_np(*[a[cols[0]] for a in (
            values, next_values, rewards, discounts, rhos, rhos)])[0])


def test_adam_matches_optax():
    """5 steps on random grads of a nested tree with a 0-d leaf; then a
    JAX Adam state converted mid-run continues as optax does."""
    rng = np.random.default_rng(3)
    shapes = {"pi": {"w0": (4, 8), "b0": (8,)}, "vf": {"head_w": (8, 1)}, "log_alpha": ()}
    params = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                          is_leaf=lambda s: isinstance(s, tuple))
    tx = optax.adam(1e-2)
    jparams = jax.tree.map(jnp.array, params)
    jstate = tx.init(jparams)
    tparams = params_from_jax(params, "cpu")
    opt = Adam(1e-2)
    tstate = opt.init(tparams)
    for step in range(5):
        grads = jax.tree.map(lambda a: (10.0 ** step * rng.standard_normal(a.shape))
                             .astype(np.float32), params)
        upd, jstate = tx.update(jax.tree.map(jnp.array, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tg = [torch.tensor(a) for a in tree_leaves(grads)]
        opt.update_(tparams, tg, tstate)
        assert_trees_close(to_numpy(tparams), jparams, rtol=1e-6, atol=1e-7)
    assert int(tstate["count"]) == int(jstate[0].count) == 5
    assert tstate["count"].dtype == torch.int32
    assert_trees_close(to_numpy(tstate["mu"]), jstate[0].mu, rtol=1e-6, atol=1e-9)
    assert_trees_close(to_numpy(tstate["nu"]), jstate[0].nu, rtol=1e-6, atol=1e-9)
    # converted mid-run: both continue 2 more steps
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    tstate = adam_state_from_jax(jstate, "cpu")
    for _ in range(2):
        grads = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
        upd, jstate = tx.update(jax.tree.map(jnp.array, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        opt.update_(tparams, [torch.tensor(a) for a in tree_leaves(grads)], tstate)
    assert_trees_close(to_numpy(tparams), jparams, rtol=1e-6, atol=1e-7)
    assert int(tstate["count"]) == 7


# ---------------------------------------------------------------------------
# The learners, from JAX's parameters, on the same batches
# ---------------------------------------------------------------------------
def _run(jl, tl, batches):
    """Each batch through both learners: the metrics of every update held
    equal, and the params after each."""
    for b in batches:
        mj = jl.update(b)
        mt = tl.update(b)
        assert_metrics_close(mt, mj)
        assert_trees_close(tl.get_weights_np(), jl.get_weights_np())
    return mt


def _fragment(rng, T=16):
    logits = rng.randn(T, 2)
    actions = rng.randint(0, 2, T).astype(np.int32)
    logp = logits[np.arange(T), actions] - np.log(np.exp(logits).sum(1))
    return {"obs": rng.randn(T, 4).astype(np.float32),
            "actions": actions,
            "rewards": rng.randn(T).astype(np.float32),
            "terminateds": rng.rand(T) < 0.1,
            "truncs": rng.rand(T) < 0.05,
            "logp": logp.astype(np.float32),
            "last_obs": rng.randn(4).astype(np.float32)}


def test_impala_learner_matches_jax():
    cfg = timpala.IMPALAConfig(hidden=(16,), seed=0, lr=1e-2)
    jl = jimpala.IMPALALearner(_jax_cfg(jimpala.IMPALAConfig, cfg), 4, 2)
    tl = timpala.IMPALALearner(cfg, 4, 2, device="cpu")
    tl.set_weights(jl.get_weights_np())
    rng = np.random.RandomState(1)
    m = _run(jl, tl, [_fragment(rng) for _ in range(5)])
    assert 0 < m["mean_rho"] <= 1.0
    assert tl.get_policy_np().keys() == {"pi"}


def test_ppo_learner_matches_jax():
    """batch 64 in minibatches of 32 over 2 epochs: 4 Adam steps an update."""
    cfg = tppo.PPOConfig(hidden=(16,), seed=0, lr=1e-2, num_epochs=2, minibatch_size=32)
    jl = jppo.PPOLearner(_jax_cfg(jppo.PPOConfig, cfg), 4, 2)
    tl = tppo.PPOLearner(cfg, 4, 2, device="cpu")
    tl.set_weights(jl.get_weights_np())
    rng = np.random.RandomState(2)
    n = 64

    def batch():
        return {"obs": rng.randn(n, 4).astype(np.float32),
                "actions": rng.randint(0, 2, n).astype(np.int32),
                "logp": np.log(rng.uniform(0.3, 0.7, n)).astype(np.float32),
                "adv": rng.randn(n).astype(np.float32),
                "returns": rng.randn(n).astype(np.float32)}

    _run(jl, tl, [batch() for _ in range(3)])


def _transitions(rng, n=32):
    return {"obs": rng.randn(n, 4).astype(np.float32),
            "next_obs": rng.randn(n, 4).astype(np.float32),
            "actions": rng.randint(0, 2, n).astype(np.int32),
            "rewards": rng.randn(n).astype(np.float32),
            "terminateds": rng.rand(n) < 0.2}


@pytest.mark.parametrize("double_q", [True, False])
def test_dqn_learner_matches_jax(double_q):
    """5 updates with the target copied every 2: the first update's
    online Q values tie (zero head) and argmax takes the first index."""
    cfg = tdqn.DQNConfig(hidden=(16,), seed=0, lr=1e-2, target_network_update_freq=2,
                         double_q=double_q)
    jl = jdqn.DQNLearner(_jax_cfg(jdqn.DQNConfig, cfg), 4, 2)
    tl = tdqn.DQNLearner(cfg, 4, 2, device="cpu")
    tl.set_weights(jl.get_weights_np())
    rng = np.random.RandomState(3)
    _run(jl, tl, [_transitions(rng) for _ in range(5)])
    assert tl.num_updates == jl.num_updates == 5
    assert_trees_close(to_numpy(tl.target_params), jl.target_params)  # copied at update 4


def test_sac_learner_matches_jax():
    """Twin critics, the actor against a frozen min-Q, log α toward
    0.98·log(2), Polyak targets: params, targets and metrics."""
    cfg = tsac.SACConfig(hidden=(16,), seed=0, lr=1e-2, tau=0.1)
    jl = jsac.SACLearner(_jax_cfg(jsac.SACConfig, cfg), 4, 2)
    tl = tsac.SACLearner(cfg, 4, 2, device="cpu")
    tl.set_weights(jl.get_weights_np())
    assert tl.target_entropy == jl.target_entropy
    rng = np.random.RandomState(4)
    _run(jl, tl, [_transitions(rng) for _ in range(4)])
    assert_trees_close(to_numpy(tl.target), jl.target)
    assert tl.get_policy_np().keys() == {"pi"}


def _expert(obs):  # tests/test_rllib.py's scripted CartPole expert
    return 1 if obs[2] + 0.5 * obs[3] > 0 else 0


def test_bc_matches_jax(tmp_path):
    """BCConfig.build() reads the data in process; both sides draw the
    same batch indices from np.random.RandomState(seed)."""
    path = trl.collect_offline_data("CartPole-v1", _expert, str(tmp_path / "expert"),
                                    num_episodes=3, seed=0)
    cfg = trl.BCConfig(env="CartPole-v1", lr=5e-3, hidden=(16,), train_batch_size=64,
                       seed=0).offline_data(path)
    jbc = _jax_cfg(jrl.BCConfig, cfg).build()
    tbc = cfg.build(device="cpu")
    assert isinstance(tbc, trl.BC)
    tbc.set_weights(jax.tree.map(np.asarray, jbc.params))
    for _ in range(5):
        rj, rt = jbc.train(), tbc.train()
        assert rt["training_iteration"] == rj["training_iteration"]
        np.testing.assert_allclose(rt["bc_loss"], rj["bc_loss"], **TOL)
    assert_trees_close(tbc.get_weights_np(), jbc.params)
    states = np.random.RandomState(7).uniform(-0.2, 0.2, (20, 4)).astype(np.float32)
    assert [tbc.compute_single_action(s) for s in states] == \
        [jbc.compute_single_action(s) for s in states]


def test_learner_continues_a_jax_run():
    """set_weights with optax's state: a learner taken over mid-training
    (after 2 JAX updates) gives JAX's third update."""
    cfg = timpala.IMPALAConfig(hidden=(8,), seed=5, lr=1e-2)
    jl = jimpala.IMPALALearner(_jax_cfg(jimpala.IMPALAConfig, cfg), 4, 2)
    rng = np.random.RandomState(6)
    frags = [_fragment(rng) for _ in range(3)]
    jl.update(frags[0])
    jl.update(frags[1])
    tl = timpala.IMPALALearner(cfg, 4, 2, device="cpu")
    tl.set_weights(jl.get_weights_np(), jl.opt_state)
    assert int(tl.opt_state["count"]) == 2
    assert_metrics_close(tl.update(frags[2]), jl.update(frags[2]))
    assert_trees_close(tl.get_weights_np(), jl.get_weights_np())


# ---------------------------------------------------------------------------
# The numpy copies, through the port's names
# ---------------------------------------------------------------------------
def test_compute_gae_copy():
    rng = np.random.RandomState(8)
    T = 32
    args = (rng.randn(T).astype(np.float32), rng.randn(T).astype(np.float32),
            rng.rand(T) < 0.1, 0.7, 0.99, 0.95)
    kw = {"truncs": rng.rand(T) < 0.1, "bootstrap_values": rng.randn(T).astype(np.float32)}
    for k in ({}, kw):
        for port, ref in zip(trl.compute_gae(*args, **k), jrl.compute_gae(*args, **k)):
            np.testing.assert_array_equal(port, ref)


def test_replay_buffer_copy():
    bufs = [trl.ReplayBuffer(capacity=8, obs_dim=2, seed=3),
            jrl.ReplayBuffer(capacity=8, obs_dim=2, seed=3)]
    frag = {"obs": np.arange(20, dtype=np.float32).reshape(10, 2),
            "next_obs": np.arange(20, dtype=np.float32).reshape(10, 2) + 1,
            "actions": np.arange(10, dtype=np.int32),
            "rewards": np.ones(10, np.float32),
            "terminateds": np.zeros(10, np.bool_)}
    for b in bufs:
        b.add_batch(frag)
    assert len(bufs[0]) == len(bufs[1]) == 8
    for _ in range(3):
        s = [b.sample(4) for b in bufs]
        for k in s[1]:
            np.testing.assert_array_equal(s[0][k], s[1][k])
    assert trl.worker_seed(7, 3) == jrl.worker_seed(7, 3)


def test_json_round_trip_both_ways(tmp_path):
    """The port's writer read by JAX's reader and the other way round;
    collect_offline_data writes the same files."""
    batch = {"type": "episode", "obs": np.ones((3, 4), np.float32),
             "actions": np.asarray([0, 1, 0], np.int32),
             "rewards": np.asarray([1.0, 1.0, 0.0], np.float32),
             "dones": np.asarray([False, False, True])}
    for writer, reader, d in ((trl.JsonWriter, jrl.JsonReader, "a"),
                              (jrl.JsonWriter, trl.JsonReader, "b")):
        w = writer(str(tmp_path / d))
        w.write(batch)
        w.close()
        (got,) = list(reader(str(tmp_path / d)))
        for k, v in batch.items():
            np.testing.assert_array_equal(got[k], v)
    for mod, d in ((trl, "port"), (jrl, "jax")):
        mod.collect_offline_data("CartPole-v1", _expert, str(tmp_path / d), num_episodes=2,
                                 seed=1)
    assert (tmp_path / "port" / "output-00001.jsonl").read_text() == \
        (tmp_path / "jax" / "output-00001.jsonl").read_text()
    env = trl.make_env("CartPole-v1")
    assert isinstance(env, trl.CartPole) and env.num_actions == 2


# ---------------------------------------------------------------------------
# What waits for the actor runtime, and the card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", [
    "PPO", "IMPALA", "DQN", "SAC", "SampleRunner", "Sebulba", "SebulbaConfig",
    "MultiAgentPPO", "MultiAgentPPOConfig", "CoordinationGame", "MultiAgentEnv",
    "PPOConfig.build", "IMPALAConfig.build", "DQNConfig.build", "SACConfig.build",
    "EnvRunner",
])
def test_item_8c_names_raise(name):
    if name.endswith(".build"):
        call = getattr(trl, name.split(".")[0])().build
    elif name == "EnvRunner":
        call = tppo.EnvRunner
    else:
        call = getattr(trl, name)
    with pytest.raises(NotImplementedError, match="Queue A item 8c"):
        call()


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["PPOLearner", "IMPALALearner", "DQNLearner", "SACLearner",
                                   "BC", "Anakin", "params_from_jax", "adam_state_from_jax"])
def test_device_none_needs_cuda(no_cuda, entry, tmp_path):
    path = trl.collect_offline_data("CartPole-v1", _expert, str(tmp_path / "d"),
                                    num_episodes=1)
    calls = {
        "PPOLearner": lambda: tppo.PPOLearner(tppo.PPOConfig(), 4, 2),
        "IMPALALearner": lambda: timpala.IMPALALearner(timpala.IMPALAConfig(), 4, 2),
        "DQNLearner": lambda: tdqn.DQNLearner(tdqn.DQNConfig(), 4, 2),
        "SACLearner": lambda: tsac.SACLearner(tsac.SACConfig(), 4, 2),
        "BC": lambda: trl.BCConfig().offline_data(path).build(),
        "Anakin": lambda: trl.AnakinConfig().build(),
        "params_from_jax": lambda: params_from_jax({"w": np.zeros(2)}),
        "adam_state_from_jax": lambda: adam_state_from_jax(optax.adam(1e-3).init({})),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
