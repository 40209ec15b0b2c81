"""A garbage collection inside the memory store's lock must not deadlock.

The hang of ROADMAP.md Queue C, found in the JAX package and fixed in the
port's copy: an ObjectRef reachable only from a reference cycle,
collected while a thread holds the memory store's lock, released its
object by deleting from that store on the same thread, and the store's
plain Lock waited on itself. The port's store lock is reentrant, and
its cluster's releases are queued (``SimpleQueue.put``, reentrant) for a
release thread. Each mode runs in a process of
its own, ended after 60 s, so a deadlock fails the test instead of
hanging the run. On a cluster the same collection inside the borrow lock
and the store client's lock must not deadlock either: every release a
count reaching zero starts runs on the core worker's release thread.
"""

import os
import signal
import subprocess
import sys

import pytest

GC_IN_THE_STORE_LOCK = """
import gc, sys, time
import numpy as np
import ray_tpu_torch as rt
from ray_tpu_torch._private.ids import ObjectID

class CollectingID(ObjectID):
    # an ObjectID whose hash runs the collector, as any allocation
    # inside a locked section can
    def __hash__(self):
        gc.collect()
        return super().__hash__()

class Holder:
    pass

def cycle_ref(value):
    # an ObjectRef reachable only from a reference cycle
    h = Holder()
    h.cycle, h.ref = h, rt.put(value)
    oid = h.ref.id()
    del h
    return oid

def report(section, gone):
    deadline = time.monotonic() + 10
    while not gone() and time.monotonic() < deadline:
        time.sleep(0.05)
    print("released", section, gone(), flush=True)

local = sys.argv[1] == "local"
rt.init(local_mode=True) if local else rt.init(num_cpus=1)
core = rt._private.worker.global_worker.core
if not local:
    print("groups", core._node.gcs_proc.pid, core._node.raylet_proc.pid, flush=True)
store = core.store if local else core.memory_store
oid = cycle_ref(np.zeros(4))
key = CollectingID(oid.binary()[:-4] + bytes([254, 255, 255, 255]))
store.as_future(key)  # holds the store's lock while the cycle is collected
report("memory_store", lambda: not store.contains(oid))
if not local:
    oid = cycle_ref(np.zeros(4))
    with core._borrow_lock:
        gc.collect()
    report("borrow_lock", lambda: not store.contains(oid))
    oid = cycle_ref(np.zeros(200_000))  # past the inline size: in the shared store
    assert core.plasma.contains(oid)
    with core.plasma._lock:
        gc.collect()
    report("store_client", lambda: not core.plasma.contains(oid))
    # a value read from the shared store pins it until the value dies
    ref = rt.put(np.zeros(200_000))
    oid = ref.id()
    h = Holder()
    h.cycle, h.value = h, rt.get(ref)
    del h
    pinned = lambda: [p for (i, _, _, p) in core.plasma.list_objects() if i == oid.binary()]
    assert pinned() == [True]
    with core.plasma._lock:
        gc.collect()
    report("store_pin", lambda: pinned() == [False])
rt.shutdown()
"""


@pytest.mark.parametrize("mode", ["local", "cluster"])
def test_gc_inside_the_store_lock_does_not_deadlock(mode):
    """Collections inside locked sections: ``as_future``'s (local mode and
    a cluster), and on a cluster inside the borrow lock and the store
    client's lock, once for an object and once for a value's pin on it.
    Each is released and the process ends."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen([sys.executable, "-c", GC_IN_THE_STORE_LOCK, mode],
                            stdout=subprocess.PIPE, text=True,
                            env=dict(os.environ, PYTHONPATH=root))
    try:
        out, _ = proc.communicate(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
    finally:
        for line in (out or "").splitlines():  # the cluster's process groups
            if line.startswith("groups"):
                for g in line.split()[1:]:
                    try:
                        os.killpg(int(g), signal.SIGKILL)
                    except ProcessLookupError:
                        pass
    sections = ["memory_store"] + ([] if mode == "local" else
                                   ["borrow_lock", "store_client", "store_pin"])
    assert proc.returncode == 0, out
    assert [line for line in out.splitlines() if line.startswith("released")] == \
        [f"released {s} True" for s in sections], out
