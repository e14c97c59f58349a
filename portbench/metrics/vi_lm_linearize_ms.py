"""Device milliseconds per LM step of the full inertial BA in
``viba/linearize`` (``solvers/inertial_ba``: the visual residuals and
Jacobians, the four segment sums and the cross blocks E), between the
span's CUDA events, over the ``viba/lm_steps`` count of ``gba/call``
requests."""


def read(ctx):
    if not ctx.get("trace"):
        return None
    from orb_slam3_study_kr_tpu_torch.utils import profiling
    timers = getattr(profiling, "DEFAULT_TIMERS", None)
    if timers is None:          # a port without the span log
        return None
    t = timers.totals("gba/call")
    ms, n = t["device_ms"].get("viba/linearize"), t["counts"].get(
        "viba/lm_steps")
    return None if ms is None or not n else ms / n
