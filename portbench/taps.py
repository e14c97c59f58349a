"""Taps on the timed path's kernel entry points.

The benchmark judges what the timed path itself produced: K1's pyramid
and maps and K2's inputs and outputs are copied, as the main path calls
them, on the window's sampled frames.  In a traced window the tap also
keeps K2's shapes and gate inputs, from which the kernel's bound is
counted.  When neither is on, a tap is one Python call around the
program's own function.
"""

import contextlib


class KernelTap:
    """Wraps ``ops.cuda_fast.fast_nms_blur_pyramid`` (looked up by
    ``ops.orb.extract_orb`` at each call) and ``ops.track_match.gated_nn``
    (the name the local-map matcher calls)."""

    def __init__(self):
        self.capture = False
        self.trace = False
        self.k1 = []        # (levels, th_min, th_ini, maps), cloned
        self.k2 = []        # (inputs, outputs, level_slack), cloned
        self.k2_traced = []  # (gate inputs, level_slack) of traced calls
        self.k1_traced = []  # level shapes of traced calls
        self._undo = []

    def install(self):
        from orb_slam3_study_kr_tpu_torch.ops import cuda_fast, track_match
        k1_orig = cuda_fast.fast_nms_blur_pyramid
        k2_orig = track_match.gated_nn

        def k1(levels, th_min, th_ini):
            maps = k1_orig(levels, th_min, th_ini)
            if self.capture:
                self.k1.append(([x.clone() for x in levels], th_min, th_ini,
                                [m.clone() for m in maps]))
            if self.trace:
                self.k1_traced.append([tuple(x.shape) for x in levels])
            return maps

        def k2(*args, level_slack=1):
            out = k2_orig(*args, level_slack=level_slack)
            if self.capture:
                self.k2.append(([a.clone() for a in args],
                                [o.clone() for o in out], level_slack))
            if self.trace:
                q_desc, q_uv, q_level, q_valid, t_desc = args[:5]
                gates = (q_uv, q_level, q_valid) + tuple(args[5:])
                self.k2_traced.append(([g.clone() for g in gates],
                                       level_slack))
            return out

        for k in (k1, k2):
            k.launches = 0
        cuda_fast.fast_nms_blur_pyramid = k1
        track_match.gated_nn = k2
        self._undo = [(cuda_fast, "fast_nms_blur_pyramid", k1_orig),
                      (track_match, "gated_nn", k2_orig)]
        return self

    def uninstall(self):
        for mod, name, orig in self._undo:
            setattr(mod, name, orig)
        self._undo = []

    @contextlib.contextmanager
    def capturing(self, on):
        self.capture = bool(on)
        try:
            yield
        finally:
            self.capture = False
