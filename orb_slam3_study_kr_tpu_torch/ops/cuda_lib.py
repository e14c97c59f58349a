"""Build and load the hand-written CUDA kernels under ``csrc/``.

All ``csrc/*.cu`` files compile into ONE shared library with a plain C
interface (nvcc, ``sm_90a``), loaded with ctypes.  The build happens at
first use into ``csrc/build/`` (git-ignored); the library name carries a
hash of the sources, so an edited kernel is rebuilt and a stale one is
never loaded.  Nothing here runs at import time: CPU-only machines import
the wrappers and never reach this module's build.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
SOURCES = ("fast_nms_blur.cu", "gated_nn.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def library_path() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libslam_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile csrc/*.cu into the shared library (no-op when present)."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp,
                    *[os.path.join(CSRC, s) for s in SOURCES]], check=True)
    os.replace(tmp, so)
    return so


def load():
    """The loaded library with every entry point's ctypes signature set."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    p = ctypes.c_void_p
    i = ctypes.c_int
    f = ctypes.c_float
    lib.fast_nms_blur.argtypes = [p, p, p, p, p, i, i, f, f, p, p]
    lib.fast_nms_blur.restype = i
    lib.gated_nn.argtypes = [p, p, p, p, p, p, p, p, p, p, p, p,
                             i, i, i, i, p]
    lib.gated_nn.restype = i
    _lib = lib
    return lib


def check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
