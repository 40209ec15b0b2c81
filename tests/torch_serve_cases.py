"""Serve's cases through both packages' clusters.

A case is written once as a function of ``P``, a namespace holding one
package's ``rt`` (``ray_tpu`` or ``ray_tpu_torch``), its ``serve`` and
``slo`` modules and its ``name`` ("jax" or "torch"). A test file
registers its cases with ``case``. ``Reference`` runs every case of the
file on ``ray_tpu.init(num_cpus=4)`` in a child process, with the cyclic
collector paused there (JAX's cluster runtime deadlocks when a collection
finalizes an ObjectRef inside a locked section on the same thread,
ROADMAP.md Queue C), while ``port_cluster`` runs ``ray_tpu_torch.init(num_cpus=4)``
in the pytest process, where each case runs with the collector on. The
port's outcome of each case must equal JAX's: values, exception classes
and messages, HTTP statuses, headers and JSON bodies, with package names
and ids normalised. The two clusters run side by side, each in its own
process.

Deployments are defined inside the cases: a class or function defined in
a function is cloudpickled by value into the replica's process (a
module-level one would pickle by reference into a test module the
replica cannot import).

``python tests/torch_serve_cases.py <test module> <dir>`` is the child: it
writes the pickled outcome of each of the module's cases on JAX into
``<dir>``.
"""

import contextlib
import gc
import http.client
import importlib
import json
import os
import pickle
import re
import signal
import subprocess
import sys
import time
import types
import urllib.error
import urllib.request

import ray_tpu
import ray_tpu.serve
import ray_tpu.serve.slo
import ray_tpu_torch
import ray_tpu_torch.serve
import ray_tpu_torch.serve.slo

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
JAX = types.SimpleNamespace(name="jax", rt=ray_tpu, serve=ray_tpu.serve,
                            slo=ray_tpu.serve.slo)
TORCH = types.SimpleNamespace(name="torch", rt=ray_tpu_torch, serve=ray_tpu_torch.serve,
                              slo=ray_tpu_torch.serve.slo)
# ids as a cluster prints them (actor ids, object ids), and process ids
HEX_ID = re.compile(r"\b[0-9a-f]{12,}\b")
PID = re.compile(r"\bpid[= ]\d+\b")


def normalised(value):
    if isinstance(value, str):
        return PID.sub("pid=<n>", HEX_ID.sub("<id>", value.replace("ray_tpu_torch", "ray_tpu")))
    if isinstance(value, (list, tuple)):
        return type(value)(normalised(v) for v in value)
    if isinstance(value, dict):
        return {normalised(k): normalised(v) for k, v in value.items()}
    return value


def outcome(P, fn):
    """("ok", value), or the exception's class name, whether it is one of
    the package's own errors, and its message. A task's error is compared
    by its cause: the traceback names each package's files."""
    try:
        return ("ok", normalised(fn()))
    except Exception as e:  # noqa: BLE001 — the outcome is the exception
        msg = str(e.cause) if isinstance(e, P.rt.exceptions.RayTaskError) else str(e)
        return normalised((type(e).__name__, isinstance(e, P.rt.exceptions.RayTpuError), msg))


def registry():
    """A dict of cases and the decorator that fills it."""
    cases = {}

    def case(fn):
        cases[fn.__name__] = fn
        return fn

    return cases, case


@contextlib.contextmanager
def collector_paused():
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def run_case(P, fn):
    """One case on P's running cluster; its deployments are deleted and
    the proxies stopped after it (the controller stays up), so the next
    case starts from no deployment and no proxy."""
    try:
        return outcome(P, lambda: fn(P))
    finally:
        P.serve.stop_http_proxy()
        P.serve.stop_grpc_proxy()
        for name in P.serve.status()["deployments"]:
            P.serve.delete(name)


def write_jax_outcomes(cases, outdir, num_cpus=4):
    """Every case on JAX's cluster, in the order of their names, the
    collector paused throughout; each outcome is written to
    ``outdir/<name>.pkl`` as soon as it is known."""
    with collector_paused():
        ray_tpu.init(num_cpus=num_cpus)
        try:
            warm_up(ray_tpu)
            for name in sorted(cases):
                got = run_case(JAX, cases[name])
                tmp = os.path.join(outdir, f".{name}.tmp")
                with open(tmp, "wb") as f:
                    pickle.dump(got, f)
                os.replace(tmp, os.path.join(outdir, f"{name}.pkl"))
        finally:
            ray_tpu.serve.shutdown()
            ray_tpu.shutdown()


class Reference:
    """JAX's outcomes of ``module``'s cases, from a child process started
    at construction: it runs them while the port's cluster runs its own,
    and each outcome can be read as soon as the child has written it."""

    DEADLINE_S = 300

    def __init__(self, module: str, tmpdir):
        self.dir = str(tmpdir)
        self.log = os.path.join(self.dir, "jax.log")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [ROOT, os.environ.get("PYTHONPATH", "")]))
        with open(self.log, "wb") as log:
            self.proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), module, self.dir],
                cwd=HERE, env=env, stdout=log, stderr=subprocess.STDOUT,
                start_new_session=True)
        self.started = time.monotonic()

    def outcome(self, name: str):
        path = os.path.join(self.dir, f"{name}.pkl")
        while not os.path.exists(path):
            rc = self.proc.poll()
            if rc is not None and not os.path.exists(path):
                with open(self.log, errors="replace") as f:
                    raise RuntimeError(f"JAX's cases exited {rc} before {name!r}:\n"
                                       f"{f.read()[-4000:]}")
            if time.monotonic() - self.started > self.DEADLINE_S:
                self.close()
                raise RuntimeError(f"JAX's cases passed {self.DEADLINE_S} s before {name!r}")
            time.sleep(0.05)
        with open(path, "rb") as f:
            return pickle.load(f)

    def close(self) -> None:
        """Wait for the child to shut its cluster down (killed after a
        grace period)."""
        try:
            self.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait()


def warm_up(rt) -> None:
    """A task whose result nobody waits for: the cluster's zygote boots
    (imports its package's stack) while the first case gets ready."""
    rt.remote(lambda: None).remote()


@contextlib.contextmanager
def port_cluster(num_cpus=4):
    ray_tpu_torch.init(num_cpus=num_cpus)
    warm_up(ray_tpu_torch)
    try:
        yield
    finally:
        ray_tpu_torch.serve.shutdown()
        ray_tpu_torch.shutdown()


# ---- HTTP --------------------------------------------------------------
def post(port, path, payload=None, timeout_s=None, headers=None, read_timeout=30):
    """POST a JSON body; (status, Retry-After, JSON body) whether or not
    the status is an error."""
    hdrs = {"Content-Type": "application/json", **(headers or {})}
    if timeout_s is not None:
        hdrs["x-request-timeout-s"] = str(timeout_s)
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(payload).encode() if payload is not None else b"{}",
        headers=hdrs)
    try:
        with urllib.request.urlopen(req, timeout=read_timeout) as resp:
            return resp.status, resp.headers.get("Retry-After"), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Retry-After"), json.loads(e.read())


def post_stream(port, path, payload, timeout_s=None):
    """POST and read a chunked response: (status, its JSON lines)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    hdrs = {"Content-Type": "application/json"}
    if timeout_s is not None:
        hdrs["x-request-timeout-s"] = str(timeout_s)
    try:
        conn.request("POST", path, body=json.dumps(payload), headers=hdrs)
        resp = conn.getresponse()
        body = resp.read().decode()
        return resp.status, [json.loads(line) for line in body.strip().splitlines() if line]
    finally:
        conn.close()


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    write_jax_outcomes(importlib.import_module(sys.argv[1]).CASES, sys.argv[2])
