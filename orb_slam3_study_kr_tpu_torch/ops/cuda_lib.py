"""Build and load the hand-written CUDA kernels under ``csrc/``.

All ``csrc/*.cu`` files compile into ONE shared library with a plain C
interface (nvcc, ``sm_90a``), loaded with ctypes: one nvcc process per
source, all started together, then one link.  The build happens at first
use into ``csrc/build/`` (git-ignored); the library name carries a hash of
the sources, so an edited kernel is rebuilt and a stale one is never
loaded.  Nothing here runs at import time: CPU-only machines import
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
SOURCES = ("fast_nms_blur.cu", "gated_nn.cu", "hamming_nn.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

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
    nvcc = _nvcc()
    tmp = f"{so}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{name}.o" for name in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC, name),
                               "-o", obj])
             for name, obj in zip(SOURCES, objs)]
    failed = [name for name, p in zip(SOURCES, procs) if p.wait() != 0]
    try:
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}")
        subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs],
                       check=True)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
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
    lib.fast_nms_blur_pyramid.argtypes = [p, p, p, i, f, f, p, p]
    lib.fast_nms_blur_pyramid.restype = i
    lib.gated_nn.argtypes = [p, p, p, p, p, p, p, p, p, p, p, p,
                             i, i, i, i, p]
    lib.gated_nn.restype = i
    lib.hamming_nn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.hamming_nn.restype = i
    _lib = lib
    return lib


def check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
