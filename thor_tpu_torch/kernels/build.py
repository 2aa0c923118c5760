"""Build and bind the port's CUDA kernels.

`thor_tpu_torch/csrc/*.cu` is compiled by `nvcc` for Hopper (`sm_90a`)
into one shared library with a plain C interface, loaded with ctypes.
The library goes to `build/thor_tpu_torch/` at the repository root, under
a name keyed by the sources and flags, on first use; nothing is built
when the module is imported.  The build needs the CUDA toolkit
(`$CUDA_HOME/bin/nvcc`, default `/usr/local/cuda`, or `nvcc` on PATH).
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

from .._host import BUILD_DIR

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
build_log = ""   # the compiler's report (ptxas -v) of the last build


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "thor_tpu_torch need the CUDA toolkit")
    return found


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")) +
                  glob.glob(os.path.join(CSRC, "*.cuh")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libthor_kernels_{h.hexdigest()[:16]}.so")


def _bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.thor_mc_luma_cells.argtypes = [i, p, i, i, i, p, p, p, p, p, p, p,
                                       i, i, i, p, p, p, p]
    lib.thor_mc_luma_cells.restype = i
    lib.thor_mc_chroma_cells.argtypes = [i, p, p, i, i, i, p, p, p, p, p, p,
                                         i, i, i, p, p, p, p]
    lib.thor_mc_chroma_cells.restype = i
    lib.thor_cuda_error_string.argtypes = [i]
    lib.thor_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load():
    """The bound kernel library, built first if it is not there."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    so = library_path()
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               *[s for s in _sources() if s.endswith(".cu")]]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError("nvcc failed (%d):\n%s\n%s" % (
                r.returncode, r.stdout, r.stderr))
        build_log = r.stdout + r.stderr
        os.replace(tmp, so)
    _lib = _bind(ctypes.CDLL(so))
    return _lib


def check(lib, rc: int, what: str):
    """Raise on a non-zero cudaError_t returned by a launch."""
    if rc != 0:
        msg = lib.thor_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
