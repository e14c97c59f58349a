"""The 90th percentile of the window's frame times (``SlamSystem.timings``:
one tracked frame, host clock, ending when the tracker's stream is done).
A host-paced tail of a few tens of frames: per-layer, never a bound."""

import numpy as np


def read(ctx):
    w = ctx.get("window")
    if not w or not w["frame_s"]:
        return None
    return 1e3 * float(np.percentile(np.asarray(w["frame_s"]), 90))
