"""The port's GCE GPU-VM provider against a recording fake ``gcloud``
(``compute instances create / delete / list``), written here as
tests/test_autoscaler.py writes its TPU one: JAX's four
``TestGceTpuProvider`` cases and ``TestGceAutoscalerLoop::
test_demand_create_preempt_replace`` with JAX's assertions, on a port
``Cluster``. The startup script every VM boots with joins the cluster
with the type's ``--num-gpus``; a two-host type creates both VMs in one
call; a VM GCE keeps as TERMINATED (a preempted Spot VM) is not live.
"""

import json
import os
import stat
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.autoscaler import Autoscaler, GCEGpuNodeProvider, NodeTypeConfig
from ray_tpu_torch.cluster_utils import Cluster

_FAKE_GCLOUD = r'''#!/usr/bin/env python3
import json, os, shutil, sys

d = os.environ["FAKE_GCLOUD_DIR"]
vms_path = os.path.join(d, "vms.json")
vms = json.load(open(vms_path)) if os.path.exists(vms_path) else {}
args = sys.argv[1:]
with open(os.path.join(d, "calls.log"), "a") as f:
    f.write(json.dumps(args) + "\n")
flags = {a.split("=", 1)[0]: a.split("=", 1)[1]
         for a in args if a.startswith("--") and "=" in a}
names = [a for a in args[3:] if not a.startswith("--")]
cmd = args[:3]
if cmd == ["compute", "instances", "create"]:
    mff = flags.get("--metadata-from-file", "")
    for name in names:
        if mff.startswith("startup-script="):
            src = mff.split("=", 1)[1]
            if os.path.exists(src):
                shutil.copy(src, os.path.join(d, "script-" + name + ".sh"))
        vms[name] = {"machine_type": flags.get("--machine-type", ""),
                     "accelerator": flags.get("--accelerator", ""),
                     "zone": flags.get("--zone", ""), "status": "RUNNING"}
    json.dump(vms, open(vms_path, "w"))
elif cmd == ["compute", "instances", "delete"]:
    if names[0] not in vms:
        sys.stderr.write("NOT_FOUND\n")
        sys.exit(1)
    vms.pop(names[0])
    json.dump(vms, open(vms_path, "w"))
elif cmd == ["compute", "instances", "list"]:
    sys.stdout.write("".join(f"{n}\t{v['status']}\n" for n, v in vms.items()))
else:
    sys.exit(2)
'''


@pytest.fixture
def fake_gcloud(tmp_path, monkeypatch):
    state = tmp_path / "gcloud_state"
    state.mkdir()
    bindir = tmp_path / "bin"
    bindir.mkdir()
    exe = bindir / "gcloud"
    exe.write_text(_FAKE_GCLOUD)
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    monkeypatch.setenv("FAKE_GCLOUD_DIR", str(state))
    yield state


def _gce_calls(state):
    log = state / "calls.log"
    if not log.exists():
        return []
    return [json.loads(line) for line in log.read_text().splitlines()]


def _vms(state):
    return json.loads((state / "vms.json").read_text())


def _provider():
    return GCEGpuNodeProvider(
        project="proj", zone="us-central1-a",
        head_address="10.0.0.2:6379", prefix="rt",
        setup_command="pip install ray-tpu")


H100_8 = {"machine_type": "a3-highgpu-8g", "resources": {"CPU": 208.0, "GPU": 8.0}}


class TestGceGpuProvider:
    def test_create_list_terminate(self, fake_gcloud):
        p = _provider()
        ids = p.create_node("h100x8", H100_8,
                            labels={"node_type": "h100x8", "slice_id": "s1"})
        assert len(ids) == 1  # one VM
        assert p.non_terminated_nodes() == {ids[0]: "h100x8"}
        create = [c for c in _gce_calls(fake_gcloud) if "create" in c][0]
        assert "--machine-type=a3-highgpu-8g" in create
        assert "--maintenance-policy=TERMINATE" in create
        assert "--project=proj" in create and "--zone=us-central1-a" in create
        assert not any(c.startswith("--accelerator") for c in create)  # a3 brings its cards
        p.terminate_node(ids[0])
        assert p.non_terminated_nodes() == {}
        assert any("delete" in c for c in _gce_calls(fake_gcloud))

    def test_startup_script_joins_cluster(self, fake_gcloud):
        """The script every VM boots with must start a raylet against the
        head GCS, carrying the autoscaler's labels (the join key that
        matches GCS nodes back to provider VMs) and the type's cards."""
        p = _provider()
        (name,) = p.create_node("h100x8", H100_8,
                                labels={"node_type": "h100x8", "slice_id": "abc123"})
        script = (fake_gcloud / f"script-{name}.sh").read_text()
        assert "python3 -m ray_tpu_torch.scripts.scripts start" in script
        assert "--address 10.0.0.2:6379" in script
        assert "slice_id" in script and "abc123" in script
        assert "pip install ray-tpu" in script
        assert "--num-gpus 8" in script.replace("8.0", "8")
        assert "--num-cpus 208" in script.replace("208.0", "208")

    def test_type_recovery_for_preexisting_vms(self, fake_gcloud):
        """VMs created by an earlier provider incarnation (fresh process,
        empty _name_to_type) must still map back to their node type."""
        p1 = _provider()
        p1.create_node("gpu-h100-8", H100_8, labels={})
        p2 = _provider()  # new incarnation, no memory
        nodes = p2.non_terminated_nodes()
        assert list(nodes.values()) == ["gpu-h100-8"]

    def test_terminate_missing_vm_raises(self, fake_gcloud):
        p = _provider()
        with pytest.raises(Exception):
            p.terminate_node("rt-gone-99")

    def test_attached_cards_and_two_hosts_in_one_call(self, fake_gcloud):
        """A machine type that takes attached cards gets --accelerator with
        the type's GPU count; a two-host type creates both VMs in one create
        call, each booting with the launch's labels."""
        p = _provider()
        ids = p.create_node(
            "g2x2", {"machine_type": "n1-standard-16", "accelerator_type": "nvidia-h100-80gb",
                     "resources": {"CPU": 16.0, "GPU": 2.0}, "slice_hosts": 2},
            labels={"node_type": "g2x2", "slice_id": "sl9"})
        assert len(ids) == 2
        creates = [c for c in _gce_calls(fake_gcloud) if "create" in c]
        assert len(creates) == 1 and all(n in creates[0] for n in ids)
        assert "--accelerator=type=nvidia-h100-80gb,count=2" in creates[0]
        for name in ids:
            script = (fake_gcloud / f"script-{name}.sh").read_text()
            assert "sl9" in script and "--num-gpus 2" in script.replace("2.0", "2")
        assert p.non_terminated_nodes() == {n: "g2x2" for n in ids}
        # GCE keeps a preempted Spot VM as TERMINATED: not a live node
        vms = _vms(fake_gcloud)
        vms[ids[0]]["status"] = "TERMINATED"
        (fake_gcloud / "vms.json").write_text(json.dumps(vms))
        assert p.non_terminated_nodes() == {ids[1]: "g2x2"}

    def test_no_gcloud_raises_runtime_error(self, monkeypatch, tmp_path):
        monkeypatch.setenv("PATH", str(tmp_path))
        with pytest.raises(RuntimeError, match="gcloud CLI not available"):
            _provider().non_terminated_nodes()


class TestGceAutoscalerLoop:
    def test_demand_create_preempt_replace(self, fake_gcloud):
        """Full reconcile loop on a live GCS: card demand → VM create; the
        VM is then taken away under the autoscaler (preemption) → the
        next reconcile launches a replacement."""
        cluster = Cluster()
        cluster.add_node(num_cpus=1)
        cluster.wait_for_nodes()
        provider = GCEGpuNodeProvider(
            project="proj", zone="us-central1-a",
            head_address=cluster.address, prefix="rt")
        asc = Autoscaler(
            cluster.gcs_addr,
            {"h100x8": NodeTypeConfig(resources={"CPU": 8.0, "GPU": 8.0}, max_workers=2,
                                      node_config={"machine_type": "a3-highgpu-8g"})},
            provider, idle_timeout_s=3600.0, interval_s=0.5)
        try:
            ray_tpu_torch.init(address=cluster.address)
            # let the autoscaler-enabled lease reach the raylet via its
            # heartbeat FIRST: an infeasible request that lands earlier
            # fails fast instead of queueing as demand
            time.sleep(2.0)

            @ray_tpu_torch.remote(num_gpus=8)
            def train():
                return "unreachable"  # the fake VM never joins

            _ref = train.remote()  # card demand the cluster can't serve
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline and not any(
                    "create" in c for c in _gce_calls(fake_gcloud)):
                asc.update()
                time.sleep(0.3)
            vms = provider.non_terminated_nodes()
            assert len(vms) == 1, "demand did not launch a VM"
            (victim,) = vms
            creates = [c for c in _gce_calls(fake_gcloud) if "create" in c]
            assert len(creates) == 1
            script = (fake_gcloud / f"script-{victim}.sh").read_text()
            assert f"--address {cluster.address}" in script
            assert "--num-gpus 8" in script.replace("8.0", "8")
            # --- preemption: GCE takes the VM away ---
            state_vms = _vms(fake_gcloud)
            state_vms.pop(victim)
            (fake_gcloud / "vms.json").write_text(json.dumps(state_vms))
            # next reconciles notice the loss and relaunch
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                asc.update()
                new_vms = provider.non_terminated_nodes()
                if new_vms and victim not in new_vms:
                    break
                time.sleep(0.3)
            new_vms = provider.non_terminated_nodes()
            assert len(new_vms) == 1 and victim not in new_vms, \
                "preempted VM was not replaced"
        finally:
            asc.stop()
            try:
                ray_tpu_torch.shutdown()
            except Exception:
                pass  # teardown is best-effort: cluster may already be down
            cluster.shutdown()
