"""A worker that registers before its raylet has filed its handle is held,
not turned away.

``Raylet._spawn_worker`` runs on an executor thread: it forks the worker
through the zygote, then files the worker's handle. A worker forked from a
warm zygote can send ``RegisterWorker`` to the raylet's loop in between.
The JAX package's raylet (the same code) answers it ``{"ok": False}``: the
worker exits, and the lease that spawned it waits
``worker_startup_timeout_s`` (60 s) for a registration that never comes,
then fails. Under the 6-worker tier-1 run this cost a worker group's last
actor its 180 s scheduling deadline
(tests/test_torch_worker_group_actors.py::test_elastic_scaling_sizes_to_cluster,
ROADMAP.md Queue C). Here a fake zygote makes the race certain: its fork
registers the worker and holds the spawning thread until the raylet's loop
has taken the registration.
"""

import asyncio
import subprocess
import threading

from ray_tpu_torch._private.config import config
from ray_tpu_torch._private.raylet import raylet as R


class EarlyZygote:
    """A zygote whose worker registers from inside ``spawn``, before the
    spawning thread can file its handle; the pid is a sleeping stand-in."""

    def __init__(self, raylet, loop):
        self.raylet, self.loop = raylet, loop
        self.replies, self.children = [], []
        self.taken = threading.Event()

    def spawn(self, env, log_path):
        worker_id = env["RAY_TPU_WORKER_ID"]

        async def register():
            self.taken.set()  # the loop runs RegisterWorker before the handle exists
            return await self.raylet.RegisterWorker(worker_id, ("127.0.0.1", 1))

        self.replies.append(asyncio.run_coroutine_threadsafe(register(), self.loop))
        assert self.taken.wait(10)
        child = subprocess.Popen(["sleep", "30"])
        self.children.append(child)
        return child.pid

    def alive(self):
        return True

    def stop(self):
        for child in self.children:
            child.kill()
            child.wait()


def test_worker_registering_before_its_handle_is_filed(tmp_path, monkeypatch):
    monkeypatch.setitem(config._values, "worker_startup_timeout_s", 5.0)
    raylet = R.Raylet("n" * 32, ("127.0.0.1", 1), {"CPU": 1.0}, str(tmp_path / "store.sock"),
                      1 << 20, session_dir=str(tmp_path))

    async def run():
        zygote = EarlyZygote(raylet, asyncio.get_running_loop())
        monkeypatch.setattr(raylet, "_get_zygote", lambda: zygote)
        try:
            handle = await asyncio.wait_for(raylet._get_idle_worker(), timeout=30)
            reply = await asyncio.wrap_future(zygote.replies[0])
        finally:
            zygote.stop()
        return handle, reply

    handle, reply = asyncio.run(run())
    assert reply == {"ok": True, "node_id": raylet.node_id}
    assert handle is not None and handle.addr == ("127.0.0.1", 1)
    assert raylet.workers == {handle.worker_id: handle} and not raylet._spawning
