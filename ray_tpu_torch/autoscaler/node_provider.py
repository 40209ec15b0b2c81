"""Node providers — how the autoscaler acquires/releases machines
(PyTorch port of ray_tpu/autoscaler/node_provider.py).

Reference: python/ray/autoscaler/node_provider.py (`NodeProvider` ABC)
and autoscaler/v2/instance_manager/cloud_providers/. Three providers:

- ``FakeNodeProvider`` — in-memory bookkeeping for unit tests.
- ``LocalNodeProvider`` — spawns REAL raylet daemons on this machine,
  registering with a live GCS (the cluster_utils.Cluster mechanism) —
  the end-to-end test path and the single-host dev story. A node type
  with ``"GPU": n`` gets n of the host's cards that no live node owns.
- ``GCEGpuNodeProvider`` — shells out to gcloud for GPU VMs
  (``gcloud compute instances``); a multi-host type creates its hosts
  in one call. Requires a GCP environment; methods raise a clear error
  when gcloud is absent.
"""

from __future__ import annotations

import os
import subprocess
import tempfile
from typing import Dict, List, Optional, Tuple


class NodeProvider:
    """Minimal provider contract. ``create_node`` returns provider node
    ids — for multi-host slice types one create call may return SEVERAL
    host nodes (the slice is atomic: all hosts or none)."""

    def create_node(self, node_type: str, node_config: dict,
                    labels: Dict[str, str]) -> List[str]:
        raise NotImplementedError

    def terminate_node(self, provider_node_id: str) -> None:
        raise NotImplementedError

    def non_terminated_nodes(self) -> Dict[str, str]:
        """provider_node_id -> node_type"""
        raise NotImplementedError


class FakeNodeProvider(NodeProvider):
    def __init__(self):
        self.launches: List[Tuple[str, dict]] = []
        self.terminated: List[str] = []
        self._nodes: Dict[str, str] = {}
        self._n = 0

    def create_node(self, node_type, node_config, labels):
        count = int(node_config.get("slice_hosts", 1))
        ids = []
        for _ in range(count):
            self._n += 1
            nid = f"fake-{node_type}-{self._n}"
            self._nodes[nid] = node_type
            ids.append(nid)
        self.launches.append((node_type, dict(node_config)))
        return ids

    def terminate_node(self, provider_node_id):
        self._nodes.pop(provider_node_id, None)
        self.terminated.append(provider_node_id)

    def non_terminated_nodes(self):
        return dict(self._nodes)


class LocalNodeProvider(NodeProvider):
    """Real raylet daemons joining an existing GCS — provider node id ==
    raylet node id, so the autoscaler can match GCS state directly.

    Cards: a node type whose resources hold ``"GPU": n`` gets n host card
    ids that no live node owns, leased by its raylet (``spawn_raylet(
    gpu_ids=)``), as ``Cluster.add_node(num_gpus=n)`` does. The free cards
    are read at each launch: the host's (``RAY_TPU_FAKE_GPUS`` first),
    less those of this provider's live nodes and, with ``cluster=``, less
    those the ``Cluster``'s nodes own. Fewer free cards than asked, or a
    fraction of a card, raises ValueError."""

    def __init__(self, gcs_addr: Tuple[str, int],
                 session_dir: Optional[str] = None, cluster=None):
        self.gcs_addr = tuple(gcs_addr)
        self.session_dir = session_dir or tempfile.mkdtemp(
            prefix="ray_tpu_torch_autoscaler_")
        self.cluster = cluster
        # node id -> (raylet process, node type, its card ids)
        self._nodes: Dict[str, Tuple[subprocess.Popen, str, List[int]]] = {}

    def free_gpu_ids(self) -> List[int]:
        """The host's card ids that no live node of this provider (nor,
        with ``cluster=``, of the Cluster) owns."""
        from ray_tpu_torch.cluster_utils import host_gpu_count

        owned = {i for p, _t, ids in self._nodes.values()
                 if p.poll() is None for i in ids}
        free = [i for i in range(host_gpu_count()) if i not in owned]
        if self.cluster is not None:
            theirs = set(self.cluster.free_gpu_ids())
            free = [i for i in free if i in theirs]
        return free

    def _take_gpus(self, node_type: str, res: Dict[str, float],
                   taken: List[int]) -> List[int]:
        want = res.get("GPU", 0)
        if not want:
            return []
        if int(want) != want or want < 0:
            raise ValueError(
                f"node type {node_type!r}: GPU={want}: a node owns whole cards")
        free = [i for i in self.free_gpu_ids() if i not in taken]
        if want > len(free):
            raise ValueError(
                f"node type {node_type!r} wants {int(want)} card(s); the free "
                f"cards are {free}")
        return free[:int(want)]

    def create_node(self, node_type, node_config, labels):
        from ray_tpu_torch._private.config import config
        from ray_tpu_torch._private.ids import NodeID
        from ray_tpu_torch._private.node import spawn_raylet

        count = int(node_config.get("slice_hosts", 1))
        res = dict(node_config.get("resources") or {"CPU": 1.0})
        res.setdefault("memory", 1 * 1024**3)
        # every host's cards are chosen before any raylet starts: a slice
        # that does not fit launches none of its hosts
        cards: List[List[int]] = []
        for _ in range(count):
            cards.append(self._take_gpus(
                node_type, res, [i for ids in cards for i in ids]))
        ids = []
        for gpu_ids in cards:
            node_id = NodeID.from_random().hex()
            node_dir = os.path.join(self.session_dir,
                                    f"as-{node_type}-{node_id[:8]}")
            os.makedirs(node_dir, exist_ok=True)
            proc, _port = spawn_raylet(
                gcs_addr=self.gcs_addr,
                node_id=node_id,
                resources=res,
                store_socket=os.path.join(node_dir, "store.sock"),
                store_capacity=int(
                    node_config.get("object_store_memory")
                    or config.object_store_memory_bytes),
                session_dir=node_dir,
                is_head=False,
                labels=dict(labels),
                gpu_ids=gpu_ids,
            )
            self._nodes[node_id] = (proc, node_type, gpu_ids)
            ids.append(node_id)
        return ids

    def node_gpu_ids(self, provider_node_id: str) -> List[int]:
        """The host card ids a launched node owns."""
        return list(self._nodes[provider_node_id][2])

    def terminate_node(self, provider_node_id):
        from ray_tpu_torch._private.node import kill_process_tree

        ent = self._nodes.pop(provider_node_id, None)
        if ent is not None:
            kill_process_tree(ent[0])

    def non_terminated_nodes(self):
        return {nid: t for nid, (p, t, _ids) in self._nodes.items()
                if p.poll() is None}

    def shutdown(self) -> None:
        for nid in list(self._nodes):
            self.terminate_node(nid)


class GCEGpuNodeProvider(NodeProvider):
    """GPU-VM provider via gcloud (reference: autoscaler/_private/gcp/
    node_provider.py). A node type's ``node_config`` names the VM:
    ``machine_type`` (e.g. "a3-highgpu-1g", whose H100s come with the
    machine type) and, for machine types that take attached cards,
    ``accelerator_type`` (e.g. "nvidia-h100-80gb", as many as the type's
    ``GPU`` resource). A type with ``slice_hosts > 1`` creates that many
    VMs in one ``create`` call, all carrying the launch's labels.

    ``head_address`` (GCS host:port reachable from the VMs) is required
    for the VM to JOIN the cluster: a startup script runs
    ``python3 -m ray_tpu_torch.scripts.scripts start --address`` on every
    host with the launch labels and the type's CPUs and cards, so the
    raylets register carrying node_type/slice_id — the autoscaler's join
    key for matching GCS nodes back to VMs. ``setup_command`` prepends
    e.g. a pip install of this package. A stopped or preempted VM (GCE
    keeps a preempted Spot VM as TERMINATED) is not a live node."""

    # instance states that hold no running machine
    _DOWN = ("STOPPING", "STOPPED", "SUSPENDING", "SUSPENDED", "TERMINATED")

    def __init__(self, project: str, zone: str, head_address: str,
                 prefix: str = "ray-tpu", setup_command: str = ""):
        self.project = project
        self.zone = zone
        self.head_address = head_address
        self.prefix = prefix
        self.setup_command = setup_command
        self._n = 0
        # name → node_type, recorded at create time: parsing the type back
        # out of the VM name breaks for dashed type keys / custom prefixes
        self._name_to_type: Dict[str, str] = {}

    def _gcloud(self, *args: str) -> str:
        try:
            return subprocess.check_output(
                ("gcloud",) + args, text=True,
                stderr=subprocess.STDOUT)
        except FileNotFoundError as e:
            raise RuntimeError(
                "gcloud CLI not available — GCEGpuNodeProvider needs a "
                "GCP environment") from e

    def _startup_script(self, node_config: dict,
                        labels: Dict[str, str]) -> str:
        import json as _json
        import shlex

        resources = node_config.get("resources") or {}
        return "\n".join([
            "#! /bin/bash",
            self.setup_command,
            "python3 -m ray_tpu_torch.scripts.scripts start "
            f"--address {shlex.quote(self.head_address)} "
            f"--labels {shlex.quote(_json.dumps(labels))} "
            + (f"--num-cpus {resources['CPU']} "
               if resources.get("CPU") else "")
            + (f"--num-gpus {resources['GPU']}"
               if resources.get("GPU") else ""),
        ])

    def _create_flags(self, node_config: dict) -> List[str]:
        flags = [f"--project={self.project}", f"--zone={self.zone}",
                 f"--machine-type={node_config.get('machine_type', 'a3-highgpu-1g')}",
                 # a VM with cards cannot live-migrate
                 "--maintenance-policy=TERMINATE"]
        acc = node_config.get("accelerator_type")
        if acc:
            count = int((node_config.get("resources") or {}).get("GPU") or 1)
            flags.append(f"--accelerator=type={acc},count={count}")
        return flags

    def create_node(self, node_type, node_config, labels):
        names = []
        for _ in range(int(node_config.get("slice_hosts", 1))):
            self._n += 1
            names.append(f"{self.prefix}-{node_type}-{self._n}")
        # --metadata splits on commas (the JSON labels always contain
        # one) — the script must go through --metadata-from-file
        with tempfile.NamedTemporaryFile(
                "w", suffix=".sh", delete=False) as f:
            f.write(self._startup_script(node_config, labels))
            script_path = f.name
        try:
            self._gcloud(
                "compute", "instances", "create", *names,
                *self._create_flags(node_config),
                f"--metadata-from-file=startup-script={script_path}",
            )
        finally:
            try:
                os.unlink(script_path)
            except OSError:
                pass
        for name in names:
            self._name_to_type[name] = node_type
        return names

    def terminate_node(self, provider_node_id):
        self._gcloud(
            "compute", "instances", "delete", provider_node_id,
            f"--project={self.project}", f"--zone={self.zone}", "--quiet",
        )
        self._name_to_type.pop(provider_node_id, None)

    def non_terminated_nodes(self):
        out = self._gcloud(
            "compute", "instances", "list",
            f"--project={self.project}", f"--zones={self.zone}",
            "--format=value(name,status)",
        )
        nodes = {}
        for line in out.splitlines():
            fields = line.split()
            if not fields or not fields[0].startswith(self.prefix + "-"):
                continue
            if len(fields) > 1 and fields[1] in self._DOWN:
                continue
            nodes[fields[0]] = self._name_to_type.get(
                fields[0], self._parse_type(fields[0]))
        return nodes

    def _parse_type(self, name: str) -> str:
        # nodes created by an earlier provider incarnation: strip the
        # "<prefix>-" head and the "-<counter>" tail; what remains is the
        # type key even when it contains dashes
        body = name[len(self.prefix) + 1:]
        head, _, tail = body.rpartition("-")
        return head if head and tail.isdigit() else body
