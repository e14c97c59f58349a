"""Device milliseconds per LM step of the global BA in ``ba/schur``
(``solvers/local_ba.bundle_adjust``: damping, the landmark blocks'
inverses and the reduced camera system's solve, ``_schur_pcg`` on the
PCG assembly), over the ``ba/lm_steps`` count of ``gba/call`` requests."""


def read(ctx):
    if not ctx.get("trace"):
        return None
    from orb_slam3_study_kr_tpu_torch.utils import profiling
    timers = getattr(profiling, "DEFAULT_TIMERS", None)
    if timers is None:          # a port without the span log
        return None
    t = timers.totals("gba/call")
    ms, n = t["device_ms"].get("ba/schur"), t["counts"].get("ba/lm_steps")
    return None if ms is None or not n else ms / n
