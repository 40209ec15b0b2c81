"""A retry of the port's worker group on the CPU: rank 1 of a group of 2
``TrainWorker`` actors on 2 fake cards (gloo, ``debug`` in fp32 at
``MeshSpec(data=2)`` from the port's init) fails after step 0, when both
ranks have saved the state through DCP and rank 0 has reported it. The
controller kills the failed rank's worker, so its peer's next collective
fails too; the group is killed, and the retry's new group (a fresh
rendezvous port) restores the latest checkpoint bit for bit and takes
step 1. Both steps' losses are held within 2e-5 of the port's
single-device steps from the same state (the data=2 step itself is held
against JAX's in tests/test_torch_worker_group.py).
"""

import os

import numpy as np
import pytest

import sharded_step_ref as R
import torch_ranks
import worker_group_ref as W
from ray_tpu_torch import train as ttrain


@pytest.fixture(scope="module")
def cluster():
    with W.fake_card_cluster():
        yield


@pytest.fixture(scope="module")
def reference():
    """The port's own init of ``debug`` (fp32) as state_from_jax takes a
    state, the tokens, and the port's single-device steps from it."""
    tcfg = R.configs("debug")[1]
    state0, toks = R.port_np_state(tcfg), R.tokens(tcfg.vocab_size)
    return {"state": state0, "tokens": toks,
            "single": R.port_steps(tcfg, state0, {"tokens": toks}, steps=W.STEPS)}


def test_group_retry_resumes_from_the_latest_checkpoint(cluster, reference, tmp_path):
    out = str(tmp_path)
    config = {"preset": "debug", "state": reference["state"], "tokens": reference["tokens"],
              "steps": W.STEPS, "fail_after": 0, "fail_rank": 1, "out": out}
    res = W.fit(ttrain.TorchTrainer(
        torch_ranks.group_resume, train_loop_config=config,
        scaling_config=ttrain.ScalingConfig(num_workers=W.WORLD, use_gpu=True),
        run_config=ttrain.RunConfig(name="retry", storage_path=os.path.join(out, "store"),
                                    failure_config=ttrain.FailureConfig(max_failures=1),
                                    checkpoint_config=ttrain.CheckpointConfig(num_to_keep=1))))
    assert res.error is None and res.metrics["step"] == W.STEPS - 1
    assert sorted(os.listdir(res.path)) == [".ckpt_index.json", "checkpoint_000001"]
    single = [m["loss"] for m in reference["single"]["metrics"]]
    for r in range(W.WORLD):
        first, second = (W.load(out, f"rank{r}_attempt{a}") for a in (0, 1))
        # the failed attempt took step 0 (rank 0's step 1 failed, its peer gone)
        assert first["start"] == 0 and len(first["saved"]) == 1
        assert second["start"] == 1 and second["restored_from"].endswith("checkpoint_000000")
        # the retry starts from the state saved after step 0, bit for bit
        saved = first["saved"][0]
        assert second["start_state"].keys() == saved.keys()
        for p, a in saved.items():
            np.testing.assert_array_equal(second["start_state"][p], a, err_msg=p)
        np.testing.assert_allclose(first["losses"][:1] + second["losses"], single,
                                   atol=R.ATOL)
