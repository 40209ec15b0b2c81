"""Build and load the port's CUDA extension from the sources in csrc/.

The first call on a process builds every kernel source with one
``torch.utils.cpp_extension.load`` (nvcc for ``sm_90a``, ninja in
parallel) into ``ray_tpu_torch/ops/_build/`` beside this file, and later
calls reuse it; a build already there and up to date is loaded as is. A
failed build raises: nothing falls back to the plain versions. Nothing
here runs at import time.
"""

from __future__ import annotations

import os
import threading

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
SOURCES = ("binding.cpp", "flash_fwd.cu")
CUDA_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a")

_lock = threading.Lock()
_ext = None


def load_extension(verbose: bool = False):
    """The compiled extension module (built on first use)."""
    global _ext
    with _lock:
        if _ext is None:
            from torch.utils.cpp_extension import load

            os.makedirs(BUILD_DIR, exist_ok=True)  # load() does not make it
            _ext = load(
                name="ray_tpu_torch_kernels",
                sources=[os.path.join(_CSRC, s) for s in SOURCES],
                build_directory=BUILD_DIR,
                extra_cflags=["-O3"],
                extra_cuda_cflags=list(CUDA_FLAGS),
                verbose=verbose,
            )
        return _ext
