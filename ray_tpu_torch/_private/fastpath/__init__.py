"""Control-plane codec fast path: native C extension with a byte-identical
pure-Python fallback (copy of ray_tpu/_private/fastpath).

Reference analogue: the reference executes its per-call hot loop in C++
with the GIL dropped (src/ray/_raylet.pyx:2942, src/ray/rpc/); this module
is that native layer for the frame/codec work of the port's Python control
plane. Consumers import the module-level functions — whichever backend won
selection at import time is transparent:

    pack_header / unpack_header     RPC frame header ([u32][u64][u8])
    encode_body / decode_body       out-of-band body framing
    write_body_into                 single-pass frame layout into a mapping
                                    (GIL-released memcpy on the C backend)
    build_frame                     header + small body in one allocation
    id_from_index                   ObjectID::FromIndex derivation

Selection (``RAY_TPU_FASTPATH``):
    unset / "auto" / "1"  build and load the C extension; where that fails
                          (no compiler, a failed build), use the Python
                          backend and say so once at WARNING
    "0" / "python"        the pure-Python backend
    "require" / "c"       the C extension, or raise ImportError
    (any other value is read as "auto", as the JAX package reads it)

The build is make-driven (``csrc/Makefile``, the source ``csrc/fastpath.c``)
into ``_build/`` next to this file, serialized across processes with an
flock so a cluster boot (driver + GCS + raylet + workers importing
concurrently) compiles once. The compiler is the first of gcc, cc and g++
on PATH, passed to make as ``CC``. ``RAY_TPU_TORCH_FASTPATH_BUILD_DIR``
names another build directory (the sanitizer test builds an instrumented
extension there).
"""

from __future__ import annotations

import logging
import os
import shutil
import subprocess
import sys
import sysconfig
import time
from typing import Optional

from ray_tpu_torch._private.fastpath import _pyimpl

logger = logging.getLogger(__name__)

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC_DIR = os.path.join(_DIR, "csrc")
_SRC = os.path.join(_SRC_DIR, "fastpath.c")
_BUILD_DIR = os.environ.get("RAY_TPU_TORCH_FASTPATH_BUILD_DIR") or os.path.join(_DIR, "_build")
# ABI-tagged and built with THIS interpreter's headers: loading an
# extension built for another Python would be undefined behavior
_MODULE = "ray_tpu_torch_fastpath"
_SO_PATH = os.path.join(_BUILD_DIR, _MODULE + (sysconfig.get_config_var("EXT_SUFFIX") or ".so"))
_COMPILERS = ("gcc", "cc", "g++")
_PYTHON_MODES = ("0", "false", "off", "python")
_C_MODES = ("require", "c")

# seconds this process spent compiling the extension (None: it built nothing)
BUILD_SECONDS: Optional[float] = None


def _needs_build() -> bool:
    if not os.path.exists(_SRC):
        return False  # installed without sources: use what exists
    return not os.path.exists(_SO_PATH) or os.path.getmtime(_SO_PATH) < os.path.getmtime(_SRC)


def compiler() -> Optional[str]:
    """The C compiler the build uses, or None where there is none."""
    return next((c for c in _COMPILERS if shutil.which(c)), None)


def _build_locked() -> None:
    """Build the extension under an flock (many processes import this
    module at cluster boot; exactly one compiles). Raises with the
    compiler's output when the build fails."""
    global BUILD_SECONDS
    import fcntl

    if not _needs_build():
        return
    cc = compiler()
    if cc is None:
        raise ImportError(f"no C compiler on PATH (looked for {', '.join(_COMPILERS)})")
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _needs_build():  # the lock's winner built it meanwhile
            return
        t0 = time.perf_counter()
        cmd = ["make", "-C", _SRC_DIR, f"CC={cc}", f"PYTHON={sys.executable}",
               f"BUILD_DIR={_BUILD_DIR}"]
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if r.returncode != 0 or not os.path.exists(_SO_PATH):
            raise ImportError(f"building the fastpath extension failed ({' '.join(cmd)}, "
                              f"exit {r.returncode}):\n{r.stdout}{r.stderr}")
        BUILD_SECONDS = time.perf_counter() - t0


def _load_c():
    """Build if needed, then load the ABI-tagged extension from _build/."""
    import importlib.util

    _build_locked()
    if not os.path.exists(_SO_PATH):
        raise ImportError(f"no fastpath extension at {_SO_PATH} and no source to build it")
    spec = importlib.util.spec_from_file_location(_MODULE, _SO_PATH)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {_SO_PATH}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _select():
    mode = os.environ.get("RAY_TPU_FASTPATH", "auto").strip().lower()
    if mode in _PYTHON_MODES:
        return _pyimpl
    try:
        return _load_c()
    except Exception as e:  # noqa: BLE001 — no compiler, make missing, a failed build
        if mode in _C_MODES:
            raise ImportError(f"RAY_TPU_FASTPATH={mode} but the C extension is "
                              f"unavailable: {e}") from e
        logger.warning("fastpath: the C codec is unavailable (%s); this process uses "
                       "the Python backend", e)
        return _pyimpl


_impl = _select()

BACKEND: str = _impl.BACKEND
NOGIL_THRESHOLD: int = _impl.NOGIL_THRESHOLD
pack_header = _impl.pack_header
unpack_header = _impl.unpack_header
encode_body = _impl.encode_body
decode_body = _impl.decode_body
write_body_into = _impl.write_body_into
build_frame = _impl.build_frame
id_from_index = _impl.id_from_index


def backend() -> str:
    """"c" when the native extension serves the hot loop, else "python"."""
    return BACKEND


def available_backends() -> dict:
    """name -> impl module. The Python backend is always present; "c"
    appears when the extension loads (built here if a compiler exists)."""
    out = {"python": _pyimpl}
    if BACKEND == "c":
        out["c"] = _impl
    else:
        try:
            out["c"] = _load_c()
        except Exception:  # noqa: BLE001 — no C half to offer
            pass
    return out
