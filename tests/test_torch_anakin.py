"""The port's Anakin (ray_tpu_torch.rllib.podracer) held against the JAX
package's on the CPU: the batched torch CartPole against ``jax_env`` step
by step (1e-6; the JAX state is fed to both sides at every step, so a
difference of an ulp cannot compound), ``fragment_loss`` against JAX's,
and ``learn`` against one step of JAX's ``Anakin`` from JAX's pre-update
params on JAX's own trajectory (2e-5 on params and metrics, absolute
and relative). The port cannot draw ``jax.random``'s bits, so the
random inputs (actions, reset observations) are fed in. Then the port's
versions of tests/test_podracer.py's TestAnakin cases, a save/restore
round trip, and the sampler's action frequencies against the softmax.
Small nets: hidden (16,).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from ray_tpu.rllib import ppo as jppo
from ray_tpu.rllib.podracer import anakin as janakin, jax_env
from ray_tpu_torch.rllib import impala as timpala
from ray_tpu_torch.rllib.convert import params_from_jax, to_numpy
from ray_tpu_torch.rllib.podracer import anakin as tanakin, torch_env

TOL = dict(rtol=2e-5, atol=2e-5)
ENV_TOL = dict(rtol=1e-6, atol=1e-6)
HIDDEN = (16,)
KW = dict(gamma=0.99, vf_coeff=0.5, entropy_coeff=0.01, rho_bar=1.0, c_bar=1.0, n_hidden=1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), **{**TOL, **tol})


def _trees_close(port, ref):
    for k, v in ref.items():
        if isinstance(v, dict):
            _trees_close(port[k], v)
        else:
            _close(port[k], v, err_msg=k)


# ---------------------------------------------------------------------------
# The env
# ---------------------------------------------------------------------------
def test_env_steps_match_jax_env():
    """64 envs for 120 steps of random actions from JAX's reset (episodes
    end and auto-reset; t near 500 is set for a few, so truncation
    shows): step and step_autoreset against jax_env's on the same
    state, actions and reset observations."""
    b = 64
    rng = np.random.RandomState(0)
    key = jax.random.key(1)
    obs, t = jax.vmap(jax_env.reset)(jax.random.split(key, b))
    t = t.at[:4].set(495)
    jstep = jax.jit(jax.vmap(jax_env.step))
    jauto = jax.jit(jax.vmap(jax_env.step_autoreset))
    seen = {"term": 0, "trunc": 0}
    for i in range(120):
        actions = jnp.asarray(rng.randint(0, 2, b).astype(np.int32))
        key, k = jax.random.split(key)
        keys = jax.random.split(k, b)
        robs = jax.vmap(jax_env.reset)(keys)[0]
        (jn, jt), jr, jterm, jtrunc = jstep((obs, t), actions)
        (tn, tt), tr, tterm, ttrunc = torch_env.step((_t(obs), _t(t)), _t(actions))
        _close(tn, jn, **ENV_TOL)
        assert tn.dtype == torch.float32 and tt.dtype == torch.int32
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_array_equal(tr, np.broadcast_to(jr, (b,)))
        np.testing.assert_array_equal(tterm, jterm)
        np.testing.assert_array_equal(ttrunc, jtrunc)
        (an, at), _, aterm, atrunc = jauto((obs, t), actions, keys)
        (pn, pt), _, pterm, ptrunc = torch_env.step_autoreset(
            (_t(obs), _t(t)), _t(actions), _t(robs))
        _close(pn, an, **ENV_TOL)
        np.testing.assert_array_equal(pt, at)
        np.testing.assert_array_equal(pterm, aterm)
        seen["term"] += int(aterm.sum())
        seen["trunc"] += int(atrunc.sum())
        obs, t = an, at  # JAX's state goes to both sides next step
    assert seen["term"] > 0 and seen["trunc"] == 4


def test_reset_draws_from_the_generator():
    gen = torch.Generator().manual_seed(0)
    obs, t = torch_env.reset(1000, gen)
    assert obs.shape == (1000, 4) and obs.dtype == torch.float32
    assert float(obs.min()) >= -0.05 and float(obs.max()) < 0.05
    assert t.dtype == torch.int32 and int(t.abs().sum()) == 0
    assert torch.equal(torch_env.reset(1000, torch.Generator().manual_seed(0))[0], obs)


# ---------------------------------------------------------------------------
# The loss and the learn step
# ---------------------------------------------------------------------------
def _jax_params(seed=0):
    """JAX's init after one Adam step on unit grads: the heads non-zero."""
    params = jppo.init_policy(jax.random.key(seed), 4, 2, HIDDEN)
    tx = optax.adam(0.05)
    upd, _ = tx.update(jax.tree.map(jnp.ones_like, params), tx.init(params), params)
    return optax.apply_updates(params, upd)


def _random_fragment(rng, T, b):
    shape = (T, b)
    return {"obs": rng.randn(*shape, 4).astype(np.float32),
            "actions": rng.randint(0, 2, shape).astype(np.int32),
            "rewards": rng.randn(*shape).astype(np.float32),
            "dones": rng.rand(*shape) < 0.15,
            "logp": np.log(rng.uniform(0.2, 0.8, shape)).astype(np.float32),
            "last_obs": rng.randn(b, 4).astype(np.float32)}


def test_fragment_loss_matches_jax():
    """One fragment [T], and B fragments [T, B] against JAX's per
    fragment."""
    jparams = _jax_params()
    jloss_fn = jax.jit(functools.partial(janakin.fragment_loss, **KW))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    frag = _random_fragment(np.random.RandomState(2), 16, 5)
    tloss, taux = tanakin.fragment_loss(tparams, {k: _t(v) for k, v in frag.items()}, **KW)
    assert tloss.shape == (5,) and set(taux) == {"pg_loss", "vf_loss", "entropy"}
    for b in range(5):
        one = {k: v[:, b] if k != "last_obs" else v[b] for k, v in frag.items()}
        jloss, jaux = jloss_fn(jparams, jax.tree.map(jnp.asarray, one))
        _close(tloss[b].detach(), jloss)
        for k in jaux:
            _close(taux[k][b].detach(), jaux[k])
        oloss, _ = tanakin.fragment_loss(tparams, {k: _t(v) for k, v in one.items()}, **KW)
        assert oloss.shape == ()
        _close(oloss.detach(), jloss)


def _cfgs(**kw):
    base = dict(num_envs=8, rollout_fragment_length=16, iterations_per_train=1, seed=0,
                max_devices=1, hidden=HIDDEN)
    base.update(kw)
    return janakin.AnakinConfig(**base), tanakin.AnakinConfig(**base)


def traj_of(frag):
    """A JAX Anakin's last_fragment (numpy [T, B]) as the port's trajectory."""
    return {k: _t(v) for k, v in frag.items()}


def test_learn_matches_one_jax_step():
    """JAX's whole fused step (max_devices=1) against the port's learn on
    JAX's trajectory from JAX's pre-update params: params after the step
    and the metrics (of the pre-update params, as train() reports)."""
    jcfg, tcfg = _cfgs()
    ja = janakin.Anakin(jcfg)
    pre = jax.tree.map(np.array, ja.params)
    r = ja.train()
    ta = tanakin.Anakin(tcfg, device="cpu")
    params = params_from_jax(pre, "cpu")
    state = ta.tx.init(params)
    m = ta.learn(params, state, traj_of(ja.last_fragment))
    _trees_close(to_numpy(params), jax.tree.map(np.asarray, ja.params))
    assert set(m) == {"pg_loss", "vf_loss", "entropy", "total_loss"}
    for k, v in m.items():
        _close(v, r[k], err_msg=k)
    assert int(state["count"]) == 1


def test_rollout_is_consistent():
    """The port's own rollout: each step's next obs is torch_env.step of
    the last (or a reset obs after done), logp is the policy's log-prob
    of the action taken, ret_done the episode's return where it ended."""
    _, tcfg = _cfgs(num_envs=32, rollout_fragment_length=40)
    ta = tanakin.Anakin(tcfg, device="cpu")
    ta.params = params_from_jax(jax.tree.map(np.asarray, _jax_params(1)), "cpu")
    env0 = ta._env
    env, traj = ta.rollout(ta.params, env0, torch.Generator().manual_seed(0))
    obs, act = traj["obs"], traj["actions"]
    assert obs.shape == (40, 32, 4) and act.dtype == torch.int32
    assert torch.equal(obs[0], env0[0])
    t = env0[1]
    for i in range(40):
        (nobs, t_next), _, term, trunc = torch_env.step((obs[i], t), act[i])
        done = term | trunc
        nxt = obs[i + 1] if i + 1 < 40 else traj["last_obs"]
        assert torch.equal(nxt[~done], nobs[~done])
        assert torch.equal(traj["terminateds"][i], term)
        assert torch.equal(traj["truncs"][i], trunc & ~term)
        assert torch.isnan(traj["ret_done"][i][~done]).all()
        assert (traj["ret_done"][i][done] >= 1).all()
        t = torch.where(done, 0, t_next)
        logits = tanakin.policy_logits(ta.params, obs[i], 1).detach()
        _close(traj["logp"][i], F.log_softmax(logits, -1).gather(
            -1, act[i].long()[:, None])[:, 0], **ENV_TOL)
    assert torch.equal(env[0], traj["last_obs"]) and torch.equal(env[1], t)


def test_action_frequencies_match_the_softmax():
    """Gumbel-max from a seeded generator: 40,000 draws a row, each
    action's frequency within 4.5 standard errors of its probability."""
    logits = torch.tensor([[0.0, 0.0], [1.5, -0.5], [-3.0, 1.0], [0.2, 0.1]])
    n = 40_000
    draws = tanakin.categorical(logits.expand(n, 4, 2), torch.Generator().manual_seed(0))
    assert draws.dtype == torch.int32 and draws.shape == (n, 4)
    p1 = torch.softmax(logits, -1)[:, 1].numpy()
    freq = draws.float().mean(0).numpy()
    se = np.sqrt(p1 * (1 - p1) / n)
    assert (np.abs(freq - p1) < 4.5 * se).all(), (freq, p1)
    again = tanakin.categorical(logits.expand(n, 4, 2), torch.Generator().manual_seed(0))
    assert torch.equal(draws, again)


# ---------------------------------------------------------------------------
# tests/test_podracer.py's TestAnakin, through the port
# ---------------------------------------------------------------------------
def test_trains_on_the_cpu():
    cfg = tanakin.AnakinConfig(num_envs=16, rollout_fragment_length=16,
                               iterations_per_train=2, seed=0, hidden=HIDDEN)
    algo = cfg.build(device="cpu")
    algo.train()
    r2 = algo.train()
    assert r2["training_iteration"] == 2
    assert r2["num_env_steps_sampled"] == 16 * 16 * 2 * 2
    assert np.isfinite(r2["total_loss"])
    assert r2["stage_s"]["podracer.update"]["n"] == 4
    assert algo.num_devices == 1  # no process group: alone


def test_loss_parity_with_impala_learner():
    """Same fragment, same params ⇒ the loss Anakin reports (of the
    pre-update params) equals the port's IMPALALearner's (the same seed
    gives both the same init)."""
    cfg = tanakin.AnakinConfig(num_envs=1, rollout_fragment_length=16,
                               iterations_per_train=1, seed=3, max_devices=1)
    algo = cfg.build(device="cpu")
    r = algo.train()
    frag = algo.fragment_for_env(0)
    icfg = timpala.IMPALAConfig(seed=3, hidden=cfg.hidden, lr=cfg.lr, gamma=cfg.gamma,
                                vf_coeff=cfg.vf_coeff, entropy_coeff=cfg.entropy_coeff,
                                rho_bar=cfg.rho_bar, c_bar=cfg.c_bar)
    learner = timpala.IMPALALearner(icfg, 4, 2, device="cpu")
    m = learner.update(frag)
    assert r["total_loss"] == pytest.approx(m["total_loss"], abs=1e-6)
    _trees_close(learner.get_weights_np(), to_numpy(algo.params))


def test_rejects_env_off_the_device():
    with pytest.raises(ValueError):
        tanakin.Anakin(tanakin.AnakinConfig(env="NotAJaxEnv-v0"), device="cpu")


def test_save_restore_round_trip(tmp_path):
    """params and Adam state (its int32 count) bit for bit; the restored
    Anakin takes the same next update as the saved one."""
    cfg = tanakin.AnakinConfig(num_envs=8, rollout_fragment_length=8,
                               iterations_per_train=2, seed=1, hidden=HIDDEN)
    a = cfg.build(device="cpu")
    a.train()
    a.save(str(tmp_path / "ckpt"))
    b = cfg.build(device="cpu")
    b.restore(str(tmp_path / "ckpt"))
    for x, y in zip(_leaves({"p": a.params, "o": a.opt_state}),
                    _leaves({"p": b.params, "o": b.opt_state})):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert int(b.opt_state["count"]) == 2
    assert all(t.requires_grad for t in _leaves(b.params))
    traj = {k: torch.from_numpy(v) for k, v in a.last_fragment.items()}
    ma = a.learn(a.params, a.opt_state, traj)
    mb = b.learn(b.params, b.opt_state, traj)
    assert {k: float(v) for k, v in ma.items()} == {k: float(v) for k, v in mb.items()}
    for x, y in zip(_leaves(a.params), _leaves(b.params)):
        assert torch.equal(x, y)


def _leaves(tree):
    return [x for v in tree.values() for x in (_leaves(v) if isinstance(v, dict) else [v])]
