"""Host milliseconds per traced full inertial BA in ``gba/preintegrate``:
the chain's IMU intervals padded and integrated in one batched call
(``pipeline/global_ba._assemble_inertial``, under the map's lock), from
the port's span log (``gba/call`` requests)."""


def read(ctx):
    if not ctx.get("trace"):
        return None
    from orb_slam3_study_kr_tpu_torch.utils import profiling
    timers = getattr(profiling, "DEFAULT_TIMERS", None)
    if timers is None:          # a port without the span log
        return None
    t = timers.totals("gba/call")
    ms = t["host_ms"].get("gba/preintegrate")
    return None if ms is None or not t["requests"] else ms / t["requests"]
