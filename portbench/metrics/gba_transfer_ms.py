"""Host milliseconds per traced global BA in ``gba/upload`` and
``gba/download``: the snapshot's copies to the card and the solution's
``.cpu().numpy()`` (``pipeline/global_ba._solve_gba``), from the port's
span log (the spans of ``gba/call`` requests).  ``gba/download`` is host
time: it is the copy alone because the traced runs of
``kinds/gba_map.py`` drain the card at the end of ``bundle_adjust``
(``timed_ba``); without that drain it would also hold the tail of the
queued solve."""


def read(ctx):
    if not ctx.get("trace"):
        return None
    from orb_slam3_study_kr_tpu_torch.utils import profiling
    timers = getattr(profiling, "DEFAULT_TIMERS", None)
    if timers is None:          # a port without the span log
        return None
    t = timers.totals("gba/call")
    up, down = (t["host_ms"].get(k) for k in ("gba/upload", "gba/download"))
    return None if up is None or down is None else (up + down) / t["requests"]
