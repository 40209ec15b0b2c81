"""Job submission through the dashboard: JAX's tests/test_dashboard.py
``TestJobLifecycle`` cases through the port's ``JobSubmissionClient`` and
``DashboardHead`` on a port ``Cluster``, held against JAX's on a JAX
``Cluster``: the same jobs reach the same terminal states with the same
messages (``exit code 3``, ``already exists``, ``STOPPED``), env vars and
logs, and the same record keys.

A submitted job's ``init()`` with no address joins the cluster it was
submitted to (``RAY_TPU_ADDRESS``, which the job manager exports): its
task reports that cluster's node id. JAX's ``init()`` reads no such
variable and starts a fresh single-node cluster for the job (ROADMAP.md
Queue C); the test prints JAX's node ids beside the port's and holds the
port alone to the contract.

Both heads serve from threads of this process; JAX's cluster runs with the
collector paused (ROADMAP.md Queue C).
"""

import pytest

import ray_tpu.job_submission as jax_jobs
import ray_tpu_torch.job_submission as port_jobs
from front_door_ref import PACKAGES, ROOT, TERMINAL, both_clusters, http_get, wait_status
from ray_tpu.dashboard import DashboardHead as JaxDashboardHead
from ray_tpu_torch.dashboard import DashboardHead

HEADS = {"jax": JaxDashboardHead, "port": DashboardHead}
CLIENTS = {"jax": jax_jobs.JobSubmissionClient, "port": port_jobs.JobSubmissionClient}
# the canonical job: remote work on the cluster, and the node its task ran on
CLUSTER_JOB = (
    "import {pkg} as rt; rt.init(); "
    "f = rt.remote(lambda x: x * 2); "
    "node = rt.remote(lambda: rt.get_runtime_context().get_node_id()); "
    "print('answer', sum(rt.get([f.remote(i) for i in range(5)]))); "
    "print('node', rt.get(node.remote())); "
    "rt.shutdown()")


@pytest.fixture(scope="module")
def jobs():
    """(client, the cluster's node id, the canonical job's submission id)
    a side: the canonical job is submitted first, so that it runs while
    the other cases do."""
    with both_clusters(num_cpus=2) as clusters:
        heads = {}
        try:
            for side, cls in HEADS.items():
                heads[side] = cls(clusters[side].gcs_addr, port=0)
            out = {}
            for side, head in heads.items():
                client = CLIENTS[side](head.address)
                sid = client.submit_job(
                    entrypoint=f'python -c "{CLUSTER_JOB.format(pkg=PACKAGES[side])}"',
                    metadata={"owner": "test"},
                    runtime_env={"env_vars": {"PYTHONPATH": ROOT}})
                node = http_get(head.address + "/api/nodes")[1][0]["NodeID"]
                out[side] = (client, node, sid)
            yield out
        finally:
            for head in heads.values():
                head.shutdown()


def on_both(jobs, entrypoint, want, **kw):
    """Submit ``entrypoint`` on both sides, then wait for each to reach a
    state in ``want``: {side: (client, sid, state)}."""
    sids = {side: c.submit_job(entrypoint=entrypoint, **kw) for side, (c, _, _) in jobs.items()}
    return {side: (jobs[side][0], sid, wait_status(jobs[side][0], sid, want))
            for side, sid in sids.items()}


def test_failing_job_reports_failed(jobs):
    got = on_both(jobs, "python -c 'raise SystemExit(3)'", TERMINAL)
    for side, (client, sid, state) in got.items():
        assert state == "FAILED", side
        assert "exit code 3" in client.get_job_info(sid)["message"]


def test_stop_long_running_job(jobs):
    got = on_both(jobs, "sleep 600", {"RUNNING"})
    for side, (client, sid, _) in got.items():
        assert client.stop_job(sid) is True, side
        assert wait_status(client, sid, {"STOPPED"}) == "STOPPED"
        assert client.stop_job(sid) is False


def test_env_vars_runtime_env(jobs):
    got = on_both(jobs, "python -c \"import os; print('V=', os.environ['MY_FLAG'])\"",
                  TERMINAL, runtime_env={"env_vars": {"MY_FLAG": "hello42"}})
    for side, (client, sid, state) in got.items():
        assert state == "SUCCEEDED" and "V= hello42" in client.get_job_logs(sid), side


def test_duplicate_submission_id_rejected(jobs):
    got = on_both(jobs, "true", {"SUCCEEDED"}, submission_id="dup_1")
    for side, (client, _, _) in got.items():
        with pytest.raises(RuntimeError, match="already exists"):
            client.submit_job(entrypoint="true", submission_id="dup_1")


def test_tail_logs(jobs):
    for side, (client, _, _) in jobs.items():
        sid = client.submit_job(entrypoint="python -c \"print('line1'); print('line2')\"")
        text = "".join(client.tail_job_logs(sid, poll_s=0.1))
        assert "line1" in text and "line2" in text, side


def test_job_status_names_match(jobs):
    """``job_submission.JobStatus``: the same states as JAX's."""
    assert vars(port_jobs.JobStatus).items() >= {
        k: v for k, v in vars(jax_jobs.JobStatus).items() if not k.startswith("_")}.items()


def test_submit_run_against_cluster_logs(jobs):
    """The canonical flow, on the cluster it was submitted to: the port's
    job's task ran on the port cluster's node."""
    nodes = {}
    for side, (client, node, sid) in jobs.items():
        assert wait_status(client, sid, TERMINAL, timeout=120) == "SUCCEEDED", side
        logs = client.get_job_logs(sid)
        assert "answer 20" in logs, (side, logs)
        nodes[side] = (node, logs.split("node ", 1)[1].split()[0])
        info = client.get_job_info(sid)
        assert info["metadata"] == {"owner": "test"}
        assert any(j["submission_id"] == sid for j in client.list_jobs())
    print(f"cluster node vs the job's task's node: {nodes}")
    assert nodes["port"][1] == nodes["port"][0]
    keys = {side: sorted(c.get_job_info(sid)) for side, (c, _, sid) in jobs.items()}
    assert keys["port"] == keys["jax"]
