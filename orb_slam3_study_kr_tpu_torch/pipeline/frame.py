"""Per-frame container: extracted features + pose + landmark bindings.

Host-side record (reference src/Frame.cc); heavy work (extraction,
undistortion) happens in jitted ops before this is built.

The per-keypoint arrays are LAZY: a tracked (non-keyframe) frame never
needs the extractor's outputs on the host — the fused tracking rounds
consume the device-resident mirrors — so the (single, batched) device->
host fetch is deferred until something actually reads a host array
(keyframe creation, initialization, relocalization).  On a remote-attached
chip that fetch costs a full link round trip per frame; deferring it
removes it from the steady-state frame path entirely.
"""

import numpy as np

from orb_slam3_study_kr_tpu_torch.slam_map.map_state import NO_LM

# Host arrays that can be materialized lazily from a deferred fetch.
_LAZY = ("uv", "level", "angle", "response", "desc", "valid", "patch",
         "uv_raw")


class Frame:
    def __init__(self, frame_id, timestamp, uv=None, level=None, angle=None,
                 response=None, desc=None, valid=None, patch=None,
                 uv_raw=None, pyr=None, depth=None, u_r=None, stereo_pc=None,
                 v_w=None, R_cw=None, t_cw=None, kp_lm=None, ref_kf=-1,
                 pose_ok=False, n_kp=None, fetch=None, device="cpu"):
        self.frame_id = frame_id
        self.device = device         # torch device of the _dev mirrors
        self.timestamp = timestamp
        self._host = {}
        for name, val in (("uv", uv), ("level", level), ("angle", angle),
                          ("response", response), ("desc", desc),
                          ("valid", valid), ("patch", patch),
                          ("uv_raw", uv_raw)):
            if val is not None:
                self._host[name] = val
        self._fetch = fetch          # () -> dict of the lazy host arrays
        self.pyr = pyr               # (L, H, W) device blurred pyramid
        self.depth = depth           # (N,) metric depth, -1 = none
        self.u_r = u_r               # (N,) right-image u coord, -1 = mono
        self.stereo_pc = stereo_pc   # (N, 3) camera-frame stereo points
        self.v_w = v_w               # (3,) body velocity in world (inertial)
        self.R_cw = R_cw
        self.t_cw = t_cw
        self.ref_kf = ref_kf
        self.pose_ok = pose_ok
        # Pose relative to rel_ref at solve time (Tracking::UpdateLastFrame
        # / SaveTrajectoryEuRoC replay): re-anchors the pose after map BA.
        self.rel_ref = -1
        self.rel_R = None
        self.rel_t = None
        # Device-resident copies of the per-keypoint arrays (populated by
        # the extractor).  The tracking hot path passes these to its jitted
        # stages so the same (N, 256) descriptor block etc. is not
        # re-uploaded to the chip on every match/optimize round.
        self._dev = {}
        if kp_lm is None:
            n = n_kp if n_kp is not None else self.uv.shape[0]
            kp_lm = np.full(n, NO_LM, np.int32)
        self.kp_lm = kp_lm

    # -- lazy host arrays ----------------------------------------------
    def _materialize(self):
        if self._fetch is not None:
            fetch, self._fetch = self._fetch, None
            for k, v in fetch().items():
                self._host.setdefault(k, v)

    def fill_host(self, **arrays):
        """Install host copies produced as a by-product of another fetch
        (e.g. the fused round returns the full updated uv arrays) without
        triggering the deferred extractor fetch."""
        self._host.update(arrays)

    @property
    def materialized(self) -> bool:
        return self._fetch is None

    def dev(self, name):
        """Device array for field `name` (uploads and caches on miss)."""
        import torch
        a = self._dev.get(name)
        if a is None:
            a = torch.as_tensor(getattr(self, name), device=self.device)
            self._dev[name] = a
        return a

    def set_dev(self, name, arr):
        self._dev[name] = arr

    def invalidate_dev(self, *names):
        for n in names:
            self._dev.pop(n, None)

    @property
    def n_matches(self):
        return int((self.kp_lm != NO_LM).sum())

    def bound_obs(self):
        kp = np.nonzero(self.kp_lm != NO_LM)[0].astype(np.int32)
        return kp, self.kp_lm[kp]


def _make_lazy(name):
    def get(self):
        v = self._host.get(name)
        if v is None and self._fetch is not None:
            self._materialize()
            v = self._host.get(name)
        return v

    def set(self, val):
        self._host[name] = val

    return property(get, set)


for _n in _LAZY:
    setattr(Frame, _n, _make_lazy(_n))
