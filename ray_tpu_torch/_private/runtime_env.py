"""Runtime environments — per-job/task/actor execution environments (copy of
ray_tpu/_private/runtime_env.py).

Reference: python/ray/_private/runtime_env/ (plugins: working_dir.py,
py_modules.py, pip.py, ...) and the per-node runtime-env agent. Three
fields are supported natively:

- ``env_vars``: {name: value} exported in the worker before user code,
- ``working_dir``: a local directory, zipped by the driver into the GCS
  KV (content-addressed) and extracted + chdir'd + sys.path'd on the
  worker,
- ``py_modules``: list of local directories, shipped the same way and
  added to sys.path,
- ``pip`` / ``uv``: a list of requirement strings — the worker's node
  builds a virtualenv for that exact requirement set ONCE
  (content-hash-addressed under the node cache, ``uv`` preferred for
  speed, ``--system-site-packages`` so this framework and jax stay
  importable — reference: _private/runtime_env/pip.py:300, uv.py), and
  the worker activates it by prepending its site-packages. Workers are
  dedicated per env hash (raylet pool), so activation never crosses
  envs.

``conda``/``container`` are rejected with a clear error (reference
gates those behind the runtime-env agent + image tooling).

Worker semantics: applying an env marks the worker (env vars stay set,
paths stay on sys.path) — the reference dedicates workers to a runtime
env rather than sandboxing per task, and so do we; application is
idempotent per content hash.
"""

from __future__ import annotations

import hashlib
import io
import os
import sys
import zipfile
from typing import Any, Dict, List, Optional, Tuple

PKG_NAMESPACE = "runtime_env_packages"
_UNSUPPORTED = ("conda", "container", "image_uri")

# driver-side upload cache: abspath -> (signature, pkg_key)
_upload_cache: Dict[str, Tuple[Tuple, str]] = {}
# worker-side: applied env hashes + extracted package keys
_applied_envs: set = set()
_extracted: Dict[str, str] = {}


def _zip_dir(path: str) -> bytes:
    buf = io.BytesIO()
    base = os.path.abspath(path)
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for root, dirs, files in os.walk(base):
            dirs[:] = [d for d in dirs if d != "__pycache__"]
            for f in files:
                full = os.path.join(root, f)
                zf.write(full, os.path.relpath(full, base))
    return buf.getvalue()


# signature memo: path -> (checked_at, signature). Submitting many
# tasks with the same working_dir must not re-walk the tree every time.
# The TTL bounds staleness for an edit-and-resubmit loop to ~1s (the
# reference uploads working_dir once per JOB, i.e. unbounded staleness).
_SIG_TTL_S = 1.0
_sig_cache: Dict[str, Tuple[float, Tuple]] = {}


def _dir_signature(path: str) -> Tuple:
    """Cheap change detector: (max mtime incl. directories, file count).
    Directory mtimes change on deletion, and the count catches removals
    whose parent-dir mtime granularity misses them."""
    import time as _t

    cached = _sig_cache.get(path)
    now = _t.monotonic()
    if cached and now - cached[0] < _SIG_TTL_S:
        return cached[1]
    mx = os.path.getmtime(path)
    count = 0
    for root, dirs, files in os.walk(path):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        try:
            mx = max(mx, os.path.getmtime(root))
        except OSError:
            pass
        for f in files:
            count += 1
            try:
                mx = max(mx, os.path.getmtime(os.path.join(root, f)))
            except OSError:
                pass
    sig = (mx, count)
    _sig_cache[path] = (now, sig)
    return sig


def upload_package(gcs, path: str) -> str:
    """Zip ``path`` into the GCS KV; returns the content-addressed key
    (reference: runtime_env packaging.py upload_package_to_gcs)."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        raise ValueError(f"runtime_env directory not found: {path!r}")
    sig = _dir_signature(path)
    cached = _upload_cache.get(path)
    if cached and cached[0] == sig:
        return cached[1]
    blob = _zip_dir(path)
    key = "pkg_" + hashlib.sha256(blob).hexdigest()[:20]
    if not gcs.call("KVGet", ns=PKG_NAMESPACE, key=key, timeout=30):
        gcs.call("KVPut", ns=PKG_NAMESPACE, key=key, value=blob,
                 overwrite=True, timeout=60)
    _upload_cache[path] = (sig, key)
    return key


def prepare_runtime_env(env: Optional[Dict[str, Any]], gcs) -> Dict[str, Any]:
    """Driver side: validate + replace local dirs with package keys."""
    if not env:
        return {}
    for k in _UNSUPPORTED:
        if env.get(k):
            raise ValueError(
                f"runtime_env field {k!r} is not supported in this build "
                f"(supported: env_vars, working_dir, py_modules)")
    out: Dict[str, Any] = {}
    if env.get("env_vars"):
        out["env_vars"] = {str(k): str(v)
                           for k, v in env["env_vars"].items()}
    wd = env.get("working_dir")
    if wd:
        out["working_dir_pkg"] = wd if str(wd).startswith("pkg_") \
            else upload_package(gcs, wd)
    for m in env.get("py_modules") or []:
        out.setdefault("py_module_pkgs", []).append(
            m if str(m).startswith("pkg_") else upload_package(gcs, m))
    reqs = env.get("pip") or env.get("uv")
    if reqs:
        if isinstance(reqs, dict):  # reference accepts {"packages": [...]}
            reqs = reqs.get("packages") or []
        if not isinstance(reqs, (list, tuple)):
            raise ValueError("runtime_env pip/uv must be a list of "
                             "requirement strings")
        out["pip_requirements"] = sorted(str(r) for r in reqs)
    return out


def _extract_package(gcs, key: str, cache_dir: str) -> str:
    dest = _extracted.get(key)
    if dest:
        return dest
    dest = os.path.join(cache_dir, key)
    if not os.path.isdir(dest):
        blob = gcs.call("KVGet", ns=PKG_NAMESPACE, key=key, timeout=60)
        if blob is None:
            raise RuntimeError(f"runtime_env package {key} missing from GCS")
        # unique tmp dir per extractor: the cache dir is shared by every
        # worker process on the node, and a shared ".tmp" path would let
        # one extractor rename another's half-written tree into place
        import shutil
        import tempfile as _tf

        tmp = _tf.mkdtemp(prefix=key + ".", dir=cache_dir)
        with zipfile.ZipFile(io.BytesIO(blob)) as zf:
            zf.extractall(tmp)
        try:
            os.rename(tmp, dest)
        except OSError:
            shutil.rmtree(tmp, ignore_errors=True)  # concurrent winner
    _extracted[key] = dest
    return dest


def _venv_site_packages(venv_dir: str) -> str:
    import glob as _glob

    hits = _glob.glob(os.path.join(venv_dir, "lib", "python*",
                                   "site-packages"))
    if not hits:
        raise RuntimeError(f"no site-packages under venv {venv_dir}")
    return hits[0]


def build_pip_venv(requirements: List[str], cache_dir: str) -> str:
    """Build (or reuse) the virtualenv for an exact requirement set.

    Content-hash-addressed: every worker on the node asking for the
    same sorted requirement list shares one venv; concurrent builders
    race benignly (build into a private tmp dir, atomic rename, loser
    discards). ``uv`` is used when present (reference: uv.py — an
    order of magnitude faster than pip), else ``python -m venv`` +
    pip. ``--system-site-packages`` keeps this framework and its deps
    importable from inside the env, like the reference's pip plugin
    (reference: _private/runtime_env/pip.py:300 _install_pip_packages).

    Returns the venv's site-packages path.
    """
    import shutil
    import subprocess
    import tempfile as _tf

    key = "venv_" + hashlib.sha256(
        "\n".join(requirements).encode()).hexdigest()[:20]
    dest = os.path.join(cache_dir, key)
    if os.path.isdir(dest):
        return _venv_site_packages(dest)
    os.makedirs(cache_dir, exist_ok=True)
    tmp = _tf.mkdtemp(prefix=key + ".", dir=cache_dir)
    try:
        uv = shutil.which("uv")
        # bounded: a hung index connection must fail the TASK, not wedge
        # the env-dedicated worker (and every task queued on its env
        # hash) forever
        build_timeout = 600
        if uv:
            subprocess.run(
                [uv, "venv", "--system-site-packages", "--python",
                 sys.executable, tmp],
                check=True, capture_output=True, text=True,
                timeout=build_timeout)
            install = [uv, "pip", "install", "--python",
                       os.path.join(tmp, "bin", "python")]
        else:
            subprocess.run(
                [sys.executable, "-m", "venv", "--system-site-packages",
                 tmp],
                check=True, capture_output=True, text=True,
                timeout=build_timeout)
            install = [os.path.join(tmp, "bin", "python"), "-m", "pip",
                       "install", "--no-input"]
        proc = subprocess.run(install + list(requirements),
                              capture_output=True, text=True,
                              timeout=build_timeout)
        if proc.returncode != 0:
            raise RuntimeError(
                f"runtime_env pip install failed:\n{proc.stdout}\n"
                f"{proc.stderr}")
        try:
            os.rename(tmp, dest)
        except OSError:
            shutil.rmtree(tmp, ignore_errors=True)  # concurrent winner
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return _venv_site_packages(dest)


def env_hash(env: Dict[str, Any]) -> str:
    import json

    return hashlib.sha256(
        json.dumps(env, sort_keys=True, default=str).encode()).hexdigest()


def apply_runtime_env(env: Optional[Dict[str, Any]], gcs,
                      cache_dir: str) -> None:
    """Worker side: idempotently apply a PREPARED runtime env."""
    if not env:
        return
    h = env_hash(env)
    if h in _applied_envs:
        return
    for k, v in (env.get("env_vars") or {}).items():
        os.environ[k] = v
    reqs = env.get("pip_requirements")
    if reqs:
        sp = build_pip_venv(list(reqs),
                            os.path.join(cache_dir, "venvs"))
        if sp not in sys.path:
            sys.path.insert(0, sp)
    for key in env.get("py_module_pkgs") or []:
        p = _extract_package(gcs, key, cache_dir)
        if p not in sys.path:
            sys.path.insert(0, p)
    wd_key = env.get("working_dir_pkg")
    if wd_key:
        p = _extract_package(gcs, wd_key, cache_dir)
        if p not in sys.path:
            sys.path.insert(0, p)
        os.chdir(p)
    _applied_envs.add(h)


def merge_runtime_envs(job_env: Optional[Dict[str, Any]],
                       task_env: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Task env overrides job env; env_vars merge key-wise (reference:
    runtime_env merge semantics, _private/runtime_env/merge.py)."""
    job_env = job_env or {}
    task_env = task_env or {}
    out = dict(job_env)
    for k, v in task_env.items():
        if k == "env_vars":
            merged = dict(job_env.get("env_vars") or {})
            merged.update(v or {})
            out["env_vars"] = merged
        else:
            out[k] = v
    return out
