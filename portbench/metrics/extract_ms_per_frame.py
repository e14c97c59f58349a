"""ORB extraction with K1 (``StageTimers`` "track/extract"; both images of a
stereo pair) summed over the window, per frame."""


def read(ctx):
    return _stage_ms(ctx, "track/extract", per="frame")


def _stage_ms(ctx, stage, per):
    w = ctx.get("window")
    if not w or stage not in w["stages"]:
        return None
    calls, seconds = w["stages"][stage]
    n = w["frames"] if per == "frame" else calls
    return None if n == 0 else 1e3 * seconds / n
