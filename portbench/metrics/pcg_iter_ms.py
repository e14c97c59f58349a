"""Device milliseconds per conjugate-gradient iteration of the global BA's
reduced camera solve: ``ba/pcg_loop`` (``solvers/local_ba._schur_pcg``)
over its ``ba/cg_iters`` count, in ``gba/call`` requests."""


def read(ctx):
    if not ctx.get("trace"):
        return None
    from orb_slam3_study_kr_tpu_torch.utils import profiling
    timers = getattr(profiling, "DEFAULT_TIMERS", None)
    if timers is None:          # a port without the span log
        return None
    t = timers.totals("gba/call")
    ms, n = t["device_ms"].get("ba/pcg_loop"), t["counts"].get("ba/cg_iters")
    return None if ms is None or not n else ms / n
