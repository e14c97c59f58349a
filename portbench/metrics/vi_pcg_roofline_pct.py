"""The inertial BA's PCG loop against its roofline: the bound of one CG
iteration (``vipcg.iteration_bound_s``, bytes at the cell's K, M and O)
over the device time of one iteration, from the trace's kernels of the
loop (the landmark sweep, the inertial pose sweep and the CG update) over
the pose sweep's launches, one an iteration.  The cell's K, M and O come
from ``kinds/vigba_map.py``'s record ``ctx["gba"]``; a trace without the
inertial pose sweep reads nothing."""

from portbench import vipcg
from portbench.trace import kernel_seconds


def read(ctx):
    s, g = ctx.get("trace"), ctx.get("gba")
    if s is None or not g:
        return None
    n, _ = kernel_seconds(s, "pose_sweep_vi")
    if not n:
        return None
    t = sum(kernel_seconds(s, k)[1] for k in ("landmark_sweep",
                                              "pose_sweep_vi", "cg_update"))
    return 100.0 * vipcg.iteration_bound_s(g["K"], g["M"], g["O"]) / (t / n)
