"""Anakin's data axis held against JAX's pmap on the CPU: one group of 4
gloo ranks (tests/torch_ranks.py), each stepping 4 of 16 envs.

JAX's Anakin at ``max_devices=4`` shards 16 envs over 4 of the CPU
devices that tests/conftest.py makes, and ``lax.pmean``s the grads, loss
and metrics. The port's ``learn`` on each rank's shard of JAX's own
trajectory, from JAX's pre-update params, must give JAX's post-update
params and metrics (2e-5, absolute and relative), as must ``learn`` at
world 1 on the whole trajectory in this process (the mean of equal
shards' means is the global mean). The ranks also keep one set of
params through ``train()`` (the init broadcast, the grads averaged) and
raise JAX's ValueError when the envs do not split.
"""

import jax
import numpy as np

import torch_ranks
from ray_tpu.rllib.podracer import anakin as janakin
from ray_tpu_torch.rllib.convert import params_from_jax, to_numpy
from ray_tpu_torch.rllib.podracer import anakin as tanakin

WORLD = 4
CFG = dict(num_envs=16, rollout_fragment_length=16, iterations_per_train=1, seed=0,
           hidden=(16,))
TOL = dict(rtol=2e-5, atol=2e-5)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _close(port, ref):
    ref = dict(_flat(ref))
    for path, a in _flat(port):
        np.testing.assert_allclose(a, ref[path], err_msg=path, **TOL)


def test_data_axis_matches_pmap(tmp_path):
    world = torch_ranks.World(WORLD, tmp_path)  # the ranks import torch meanwhile
    try:
        ja = janakin.Anakin(janakin.AnakinConfig(max_devices=WORLD, **CFG))
        assert ja.num_devices == WORLD
        pre = jax.tree.map(lambda x: np.array(x[0]), ja.params)
        r = ja.train()
        post = jax.tree.map(lambda x: np.array(x[0]), ja.params)
        frag = ja.last_fragment  # [device, T, 4 envs, ...]; last_obs [device, 4 envs, 4]
        traj = {k: np.concatenate(list(v), axis=0 if k == "last_obs" else 1)
                for k, v in frag.items()}
        assert traj["obs"].shape == (16, 16, 4) and traj["last_obs"].shape == (16, 4)
        world.send({"anakin": ("anakin", {"cfg": CFG, "params": pre, "traj": traj})})

        # world 1, here: the whole trajectory
        alone = tanakin.Anakin(tanakin.AnakinConfig(max_devices=1, **CFG), device="cpu")
        params = params_from_jax(pre, "cpu")
        metrics = alone.learn(params, alone.tx.init(params),
                              {k: torch_ranks.torch.from_numpy(v) for k, v in traj.items()})
        _close(to_numpy(params), post)
        for k, v in metrics.items():
            np.testing.assert_allclose(float(v), r[k], err_msg=k, **TOL)

        results = world.results()
    finally:
        world.stop()
    assert all(res["jax_imported"] == [] for res in results)
    ranks = [res["anakin"] for res in results]
    for rank, out in enumerate(ranks):
        assert out["num_devices"] == WORLD and out["envs"] == (4, 4)
        _close(out["params"], post)
        for k, v in out["metrics"].items():
            np.testing.assert_allclose(v, r[k], err_msg=f"rank {rank} {k}", **TOL)
        assert "must divide evenly across 4 ranks" in out["indivisible"]
        assert out["alone"] == 1
        assert "max_devices=2 under a process group of 4" in out["part_of_the_group"]
        for path, a in _flat(out["init"]):  # the broadcast init: rank 0's
            np.testing.assert_array_equal(a, dict(_flat(ranks[0]["init"]))[path])
        for path, a in _flat(out["trained"]):  # one update of averaged grads
            np.testing.assert_array_equal(a, dict(_flat(ranks[0]["trained"]))[path])
        rep = out["report"]
        assert rep["num_env_steps_sampled"] == 16 * 16
        assert rep == ranks[0]["report"]  # metrics and returns over all 16 envs
