"""Native (C++) map-index helpers, loaded via ctypes.

The compute path is PyTorch; this layer covers the host-orchestrator roles
the reference implements in C++ (map bookkeeping, queue/index maintenance).
`build()` compiles the shared library with the system toolchain; every entry
point has a numpy fallback so the framework works before/without building.
"""

import ctypes
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_HERE, "libmap_index.so")
_lib = None


def build(force=False):
    """Compile the native library (g++ -O3 -shared)."""
    if os.path.exists(_SO) and not force:
        return _SO
    src = os.path.join(_HERE, "map_index.cpp")
    subprocess.run(
        ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-o", _SO, src],
        check=True,
    )
    return _SO


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_SO):
        try:
            build()
        except Exception:
            return None
    lib = ctypes.CDLL(_SO)
    i64 = ctypes.c_int64
    i32 = ctypes.c_int32
    p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.covisibility_counts.argtypes = [p_i32, p_u8, i64, i64, i64, i64, p_u8, p_i32]
    lib.covisibility_counts.restype = None
    lib.landmark_obs_counts.argtypes = [p_i32, p_u8, i64, i64, i64, p_i32]
    lib.landmark_obs_counts.restype = None
    lib.observations_coo.argtypes = [p_i32, i64, p_i32, i64, p_i32, p_i32, p_i32]
    lib.observations_coo.restype = i64
    lib.replace_landmark.argtypes = [p_i32, i64, i32, i32]
    lib.replace_landmark.restype = i64
    _lib = lib
    return _lib


def available():
    return _load() is not None


def covisibility_counts(kf_kp_lm, kf_valid, kf_id, max_lm):
    lib = _load()
    n_kf, max_kp = kf_kp_lm.shape
    if lib is None:
        lms = kf_kp_lm[kf_id]
        lms = lms[lms >= 0]
        seen = np.zeros(max_lm, bool)
        seen[lms] = True
        shared = (seen[np.maximum(kf_kp_lm, 0)] & (kf_kp_lm >= 0)).sum(axis=1)
        shared[kf_id] = 0
        shared[~kf_valid] = 0
        return shared.astype(np.int32)
    out = np.empty(n_kf, np.int32)
    scratch = np.empty(max_lm, np.uint8)
    lib.covisibility_counts(
        np.ascontiguousarray(kf_kp_lm, np.int32),
        np.ascontiguousarray(kf_valid, np.uint8),
        n_kf, max_kp, max_lm, kf_id, scratch, out)
    return out


def landmark_obs_counts(kf_kp_lm, kf_valid, max_lm):
    lib = _load()
    n_kf, max_kp = kf_kp_lm.shape
    if lib is None:
        flat = kf_kp_lm[kf_valid].ravel()
        flat = flat[flat >= 0]
        return np.bincount(flat, minlength=max_lm).astype(np.int32)
    out = np.empty(max_lm, np.int32)
    lib.landmark_obs_counts(
        np.ascontiguousarray(kf_kp_lm, np.int32),
        np.ascontiguousarray(kf_valid, np.uint8),
        n_kf, max_kp, max_lm, out)
    return out


def observations_coo(kf_kp_lm, kf_ids):
    lib = _load()
    max_kp = kf_kp_lm.shape[1]
    kf_ids = np.ascontiguousarray(kf_ids, np.int32)
    if lib is None:
        sub = kf_kp_lm[kf_ids]
        r, c = np.nonzero(sub >= 0)
        return kf_ids[r], c.astype(np.int32), sub[r, c]
    cap = kf_ids.size * max_kp
    okf = np.empty(cap, np.int32)
    okp = np.empty(cap, np.int32)
    olm = np.empty(cap, np.int32)
    n = lib.observations_coo(
        np.ascontiguousarray(kf_kp_lm, np.int32), max_kp,
        kf_ids, kf_ids.size, okf, okp, olm)
    return okf[:n], okp[:n], olm[:n]


def replace_landmark(kf_kp_lm, b, a):
    lib = _load()
    if lib is None:
        n = int((kf_kp_lm == b).sum())
        kf_kp_lm[kf_kp_lm == b] = a
        return n
    assert kf_kp_lm.dtype == np.int32 and kf_kp_lm.flags["C_CONTIGUOUS"]
    return int(lib.replace_landmark(kf_kp_lm, kf_kp_lm.size, int(b), int(a)))
