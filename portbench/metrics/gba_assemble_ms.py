"""Host milliseconds per traced global BA in ``gba/assemble``: the map's
snapshot (``pipeline/global_ba._assemble_gba``, under the map's lock),
from the port's span log (``utils.profiling.DEFAULT_TIMERS``, the spans of
``gba/call`` requests)."""


def read(ctx):
    if not ctx.get("trace"):
        return None
    from orb_slam3_study_kr_tpu_torch.utils import profiling
    timers = getattr(profiling, "DEFAULT_TIMERS", None)
    if timers is None:          # a port without the span log
        return None
    t = timers.totals("gba/call")
    ms = t["host_ms"].get("gba/assemble")
    return None if ms is None else ms / t["requests"]
