"""Ranks of an OBJSTORE collective group on the port's cluster, for the
tests/test_torch_objstore*.py files: ``Member`` (one rank, its
environment staged before the group initializes, since the policy and
topology knobs are read at the group's first agreement), ``spawn`` and
``teardown``. The member actors take no CPU (``num_cpus=0``), as the JAX
package's test ranks do, so 8 of them fit a 4-CPU node.
"""

import os

import numpy as np
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.util import collective as col
from ray_tpu_torch.util.collective.types import ReduceOp

FAKE_HOSTS = ["hostA", "hostA", "hostB", "hostB"]
REDUCERS = {"sum": lambda xs: np.sum(xs, axis=0), "mean": lambda xs: np.mean(xs, axis=0),
            "max": lambda xs: np.max(xs, axis=0), "min": lambda xs: np.min(xs, axis=0),
            "product": lambda xs: np.prod(xs, axis=0)}


def host_envs(extra=None, per_rank=None, op_timeout=None):
    """One environment a rank of FAKE_HOSTS: two fake hosts of two ranks."""
    out = []
    for i, k in enumerate(FAKE_HOSTS):
        e = {"RAY_TPU_COLLECTIVE_TOPOLOGY_KEY": k}
        if op_timeout is not None:
            e["RAY_TPU_COLLECTIVE_OP_TIMEOUT_S"] = op_timeout
        e.update(extra or {})
        e.update((per_rank or {}).get(i, {}))
        out.append(e)
    return out


def as_input(arr, kind: str):
    """The op's input as the caller hands it: numpy or a CPU torch tensor."""
    return torch.from_numpy(np.array(arr)) if kind == "torch" else arr


@rt.remote(num_cpus=0, max_restarts=0)
class Member:
    def __init__(self, rank, world, gname, env=None):
        for k, val in (env or {}).items():
            os.environ[k] = val
        self.rank = rank
        self.gname = gname
        col.init_collective_group(world, rank, backend="objstore", group_name=gname)

    def allreduce(self, arr, op="sum", kind="numpy"):
        return col.allreduce(as_input(arr, kind), group_name=self.gname, op=ReduceOp(op))

    def reducescatter(self, arr, op="sum"):
        return col.reducescatter(arr, group_name=self.gname, op=ReduceOp(op))

    def allgather(self, arr, kind="numpy"):
        return col.allgather(as_input(arr, kind), group_name=self.gname)

    def broadcast(self, arr, src):
        return col.broadcast(arr, src_rank=src, group_name=self.gname)

    def send(self, arr, dst):
        col.send(arr, dst_rank=dst, group_name=self.gname)
        return True

    def recv(self, src):
        return col.recv(src_rank=src, group_name=self.gname)

    def barrier(self):
        col.barrier(group_name=self.gname)
        return True

    def async_round(self, arrs):
        """Every allreduce submitted up front, resolved in order."""
        handles = [col.async_allreduce(a, group_name=self.gname) for a in arrs]
        return [h.result(timeout=120) for h in handles]

    def async_snapshot(self):
        """The buffer overwritten after submission: the op reduces what
        was submitted."""
        a = np.ones(64, np.float32)
        h = col.async_allreduce(a, group_name=self.gname)
        a[:] = 999.0
        return h.result(timeout=120)

    def last_op_event(self):
        from ray_tpu_torch.observability.events import local_events

        evs = local_events("collective_op")
        return evs[-1] if evs else None

    def view(self):
        g = col.collective._groups[self.gname]
        return {"epoch": g.epoch, "members": list(g.members)}

    def destroy(self):
        col.destroy_collective_group(self.gname)
        return True


def spawn(world, gname, env=None, envs=None):
    return [Member.remote(i, world, gname, envs[i] if envs else env) for i in range(world)]


def teardown(ws):
    try:
        rt.get([w.destroy.remote() for w in ws], timeout=60)
    except Exception:  # noqa: BLE001 — a chaos test may have killed some
        pass
    for w in ws:
        rt.kill(w)


def run(ws, method, args_per_rank, timeout=300):
    return rt.get([getattr(w, method).remote(*a) for w, a in zip(ws, args_per_rank)],
                  timeout=timeout)
