"""Build and bind the port's CUDA kernels.

Each `thor_tpu_torch/csrc/*.cu` is compiled by its own `nvcc` process for
Hopper (`sm_90a`), all started together, and the objects are linked into
one shared library with a plain C interface, loaded with ctypes.  The
library goes to `BUILD_DIR` (`build/thor_tpu_torch/` at the repository
root), under a name keyed by the sources and flags, on first use; nothing
is built when the module is imported.  The port's C host tier
(`_native/`) builds into the same directory.  The build needs the CUDA
toolkit (`$CUDA_HOME/bin/nvcc`, default `/usr/local/cuda`, or `nvcc` on
PATH).

`load` also reads back the taps that the kernels hold in `__constant__`
memory and raises unless they equal `tables.py`.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# what the port builds: the CUDA kernels and its copy of the C host tier
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "thor_tpu_torch")
CSRC = os.path.join(_PKG, "csrc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
_lock = threading.Lock()   # stream threads build and bind the library once
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
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.thor_mc_luma_cells.argtypes = [i, p, i, i, i, p, p, p, p, p, p, p,
                                       q, i, i, p, p]
    lib.thor_mc_luma_cells.restype = i
    lib.thor_mc_chroma_cells.argtypes = [i, p, p, i, i, i, p, p, p, p, p, p,
                                         q, i, i, p, p, p]
    lib.thor_mc_chroma_cells.restype = i
    lib.thor_mc_luma_taps.argtypes = [p, p]
    lib.thor_mc_luma_taps.restype = i
    lib.thor_mc_chroma_taps.argtypes = [p]
    lib.thor_mc_chroma_taps.restype = i
    lib.thor_intra_waves.argtypes = [i, p, p, p, i, i, i, i, p, p, p, i, i,
                                     i, i, i, i, p, p, p, i, p, i, i, i, p]
    lib.thor_intra_waves.restype = i
    lib.thor_cuda_error_string.argtypes = [i]
    lib.thor_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _compile(so: str) -> str:
    """One nvcc per source, all at once, then one link; returns the
    compilers' reports."""
    tmp = f"{so}.{os.getpid()}"
    srcs = [s for s in _sources() if s.endswith(".cu")]
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in srcs]
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", o, s],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for s, o in zip(srcs, objs)]
    logs, failed = [], []
    for s, pr in zip(srcs, procs):
        out = pr.communicate()[0]
        logs.append(out)
        if pr.returncode != 0:
            failed.append(f"{os.path.basename(s)} ({pr.returncode}):\n{out}")
    try:
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        r = subprocess.run([_nvcc(), "-shared", "-o", f"{tmp}.tmp", *objs],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError("nvcc link failed (%d):\n%s\n%s" % (
                r.returncode, r.stdout, r.stderr))
        os.replace(f"{tmp}.tmp", so)
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    return "".join(logs)


def _check_taps(lib):
    """The __constant__ taps equal tables.py's (read back once)."""
    from ..tables import CHROMA_BANK, LOWPASS_K, LUMA_BANK
    bank = np.zeros(LUMA_BANK.size, np.int32)
    lowpass = np.zeros(LOWPASS_K.size, np.int32)
    chroma = np.zeros(CHROMA_BANK.size, np.int32)
    check(lib, lib.thor_mc_luma_taps(bank.ctypes.data, lowpass.ctypes.data),
          "thor_mc_luma_taps")
    check(lib, lib.thor_mc_chroma_taps(chroma.ctypes.data),
          "thor_mc_chroma_taps")
    for name, got, want in (("luma", bank, LUMA_BANK),
                            ("lowpass", lowpass, LOWPASS_K),
                            ("chroma", chroma, CHROMA_BANK)):
        if not np.array_equal(got, want.reshape(-1)):
            raise RuntimeError(f"the {name} taps in csrc/ differ from "
                               f"tables.py: {got.tolist()}")


def load():
    """The bound kernel library, built first if it is not there.  Safe to
    call from several threads: one builds and binds, the others wait."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            build_log = _compile(so)
        lib = _bind(ctypes.CDLL(so))
        _check_taps(lib)
        _lib = lib
    return _lib


def check(lib, rc: int, what: str):
    """Raise on a non-zero cudaError_t returned by a launch."""
    if rc != 0:
        msg = lib.thor_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
