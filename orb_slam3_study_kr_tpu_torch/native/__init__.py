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
    """Compile the native library (g++ -O3 -shared), again when the source
    is newer than the library."""
    src = os.path.join(_HERE, "map_index.cpp")
    if (os.path.exists(_SO) and not force
            and os.path.getmtime(_SO) >= os.path.getmtime(src)):
        return _SO
    tmp = f"{_SO}.{os.getpid()}"
    subprocess.run(
        ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-o", tmp, src],
        check=True,
    )
    os.replace(tmp, _SO)
    return _SO


def _load():
    global _lib
    if _lib is not None:
        return _lib
    try:
        build()
    except Exception:
        if not os.path.exists(_SO):
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
    if hasattr(lib, "unbind_landmarks"):
        lib.unbind_landmarks.argtypes = [p_i32, i64, p_u8, i64]
        lib.unbind_landmarks.restype = i64
    if hasattr(lib, "gather_observations"):
        p_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.gather_observations.argtypes = [
            p_i32, p_f32, p_i32, p_f32, i64, p_i32, i64, p_i32, i64, i64,
            p_i32, p_i32, p_i32, p_i32, p_f32, p_i32, p_f32]
        lib.gather_observations.restype = i64
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


def unbind_landmarks(kf_kp_lm, ids, max_lm):
    """Clear, in place, every binding to the landmarks ``ids``; returns how
    many bindings were cleared."""
    # NO_LM reads the table's last entry, past max_lm, which stays 0.
    dead = np.zeros(max_lm + 1, np.uint8)
    dead[np.asarray(ids, np.int64)] = 1
    lib = _load()
    if lib is None or not hasattr(lib, "unbind_landmarks"):
        kill = dead.view(bool)[kf_kp_lm]
        kf_kp_lm[kill] = -1
        return int(kill.sum())
    assert kf_kp_lm.dtype == np.int32 and kf_kp_lm.flags["C_CONTIGUOUS"]
    return int(lib.unbind_landmarks(kf_kp_lm, kf_kp_lm.size, dead, max_lm))


def gather_observations(kf_kp_lm, kf_kp_uv, kf_kp_level, kf_kp_ur, kf_ids,
                        lm_index, n, size):
    """The global BA's observation rows: every binding of ``kf_ids``'s
    keyframes to a landmark with ``lm_index`` >= 0, in keyframe-then-slot
    order.  ``n`` is their number and ``size`` >= n the rows returned, the
    tail padded.  Returns okf, okp (n,) the keyframe and slot; op, ol
    (size,) int32 the position in ``kf_ids`` and ``lm_index`` of the
    landmark (0 in the tail); uv (size, 2), level (size,), ur (size,) the
    slot's pixel, level and right coordinate (0, 0 and -1 in the tail)."""
    kf_ids = np.ascontiguousarray(kf_ids, np.int32)
    lm_index = np.ascontiguousarray(lm_index, np.int32)
    op = np.zeros(size, np.int32)
    ol = np.zeros(size, np.int32)
    uv = np.zeros((size, 2), np.float32)
    level = np.zeros(size, np.int32)
    ur = np.full(size, -1.0, np.float32)
    lib = _load()
    if lib is None or not hasattr(lib, "gather_observations"):
        sub = kf_kp_lm[kf_ids]
        live = sub >= 0
        live[live] = lm_index[sub[live]] >= 0
        r, c = np.nonzero(live)
        if r.size != n:
            raise ValueError(f"{r.size} observations found, {n} expected")
        okf = kf_ids[r]
        op[:n], ol[:n] = r, lm_index[sub[r, c]]
        uv[:n], level[:n], ur[:n] = (kf_kp_uv[okf, c], kf_kp_level[okf, c],
                                     kf_kp_ur[okf, c])
        return okf, c.astype(np.int32), op, ol, uv, level, ur
    okf = np.empty(n, np.int32)
    okp = np.empty(n, np.int32)
    found = lib.gather_observations(
        np.ascontiguousarray(kf_kp_lm, np.int32),
        np.ascontiguousarray(kf_kp_uv, np.float32),
        np.ascontiguousarray(kf_kp_level, np.int32),
        np.ascontiguousarray(kf_kp_ur, np.float32), kf_kp_lm.shape[1],
        kf_ids, kf_ids.size, lm_index, lm_index.size, n,
        okf, okp, op, ol, uv, level, ur)
    if found != n:
        raise ValueError(f"{found} observations found, {n} expected")
    return okf, okp, op, ol, uv, level, ur
