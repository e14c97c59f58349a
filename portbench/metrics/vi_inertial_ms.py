"""Device milliseconds per LM step of the full inertial BA in
``viba/inertial`` (``solvers/inertial_ba``: the preintegration edges'
residuals, their closed-form Jacobians, the random-walk edges and the
states' 15x15 blocks), over the ``viba/lm_steps`` count of ``gba/call``
requests."""


def read(ctx):
    if not ctx.get("trace"):
        return None
    from orb_slam3_study_kr_tpu_torch.utils import profiling
    timers = getattr(profiling, "DEFAULT_TIMERS", None)
    if timers is None:          # a port without the span log
        return None
    t = timers.totals("gba/call")
    ms, n = t["device_ms"].get("viba/inertial"), t["counts"].get(
        "viba/lm_steps")
    return None if ms is None or not n else ms / n
