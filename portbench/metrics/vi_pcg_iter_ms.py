"""Device milliseconds per conjugate-gradient iteration of the full
inertial BA's reduced solve: ``viba/pcg_loop``
(``solvers/inertial_ba._vi_schur_pcg``) over its ``viba/cg_iters`` count,
in ``gba/call`` requests."""


def read(ctx):
    if not ctx.get("trace"):
        return None
    from orb_slam3_study_kr_tpu_torch.utils import profiling
    timers = getattr(profiling, "DEFAULT_TIMERS", None)
    if timers is None:          # a port without the span log
        return None
    t = timers.totals("gba/call")
    ms, n = t["device_ms"].get("viba/pcg_loop"), t["counts"].get(
        "viba/cg_iters")
    return None if ms is None or not n else ms / n
