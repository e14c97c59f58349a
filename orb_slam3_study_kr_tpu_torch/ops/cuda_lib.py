"""Build and load the hand-written CUDA kernels under ``csrc/``.

The ``csrc/*.cu`` files compile into shared libraries with a plain C
interface (nvcc, ``sm_90a``), loaded with ctypes, one library per source
group (``GROUPS``): ``slam_kernels`` holds the tracking kernels K1-K3,
``schur_pcg`` the global BAs' PCG loops (K4, visual and inertial) and
their reprojection pass (K5), so a global BA builds two small files and
never K1-K3.  A group's build runs one nvcc process per
source, all started together, then one link.  It happens at first use
into ``csrc/build/`` (git-ignored); the library name carries a hash of the
group's sources, so an edited kernel is rebuilt and a stale one is never
loaded.  Nothing here runs at import time: CPU-only machines import
the wrappers and never reach this module's build.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
GROUPS = {"slam_kernels": ("fast_nms_blur.cu", "gated_nn.cu", "hamming_nn.cu"),
          "schur_pcg": ("schur_pcg.cu", "reproj_lin.cu")}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_libs = {}
_load_lock = threading.Lock()
_count_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(group: str = "slam_kernels") -> str:
    h = hashlib.sha256()
    for name in GROUPS[group]:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{group}_{h.hexdigest()[:16]}.so")


def build(group: str = "slam_kernels") -> str:
    """Compile the group's sources into its shared library (no-op when
    present)."""
    so = library_path(group)
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tmp = f"{so}.{os.getpid()}.tmp"
    sources = GROUPS[group]
    objs = [f"{tmp}.{name}.o" for name in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC, name),
                               "-o", obj])
             for name, obj in zip(sources, objs)]
    failed = [name for name, p in zip(sources, procs) if p.wait() != 0]
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


def load(group: str = "slam_kernels"):
    """The group's loaded library with every entry point's ctypes signature
    set."""
    lib = _libs.get(group)
    if lib is not None:
        return lib
    # The tracker and the loop closer's thread may both come here first;
    # one builds (its temporary files are named by the process).
    with _load_lock:
        if group not in _libs:
            _libs[group] = _bind(ctypes.CDLL(build(group)), group)
    return _libs[group]


def _bind(lib, group):
    """Sets every entry point's ctypes signature; returns lib."""
    p = ctypes.c_void_p
    i = ctypes.c_int
    f = ctypes.c_float
    if group == "slam_kernels":
        lib.fast_nms_blur_pyramid.argtypes = [p, p, p, i, f, f, p, p]
        lib.fast_nms_blur_pyramid.restype = i
        lib.gated_nn.argtypes = [p, p, p, p, p, p, p, p, p, p, p, p,
                                 i, i, i, i, p]
        lib.gated_nn.restype = i
        lib.hamming_nn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, p]
        lib.hamming_nn.restype = i
    else:
        for fn in (lib.schur_pcg_f32, lib.schur_pcg_f64):
            fn.argtypes = [p] * 19 + [i, i, i, i, p]
            fn.restype = i
        for fn in (lib.vi_schur_pcg_f32, lib.vi_schur_pcg_f64):
            fn.argtypes = [p] * 23 + [i, i, i, i, p]
            fn.restype = i
        for fn in (lib.reproj_linearize_f32, lib.reproj_linearize_f64):
            fn.argtypes = [p] * 16 + [i] * 5 + [p]
            fn.restype = i
        for fn in (lib.reproj_cost_f32, lib.reproj_cost_f64):
            fn.argtypes = [p] * 10 + [i] * 3 + [p]
            fn.restype = i
    return lib


def check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def count_launch(wrapper, n: int = 1):
    """Add n to ``wrapper.launches``.  The tracker and the background
    mapping worker launch the same kernels from two threads, and ``+=`` on
    an attribute is not atomic."""
    with _count_lock:
        wrapper.launches += n
