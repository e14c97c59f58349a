"""Loop detection (and correction, had one landed) per keyframe of the
window (``StageTimers`` "loop/detect_correct")."""


def read(ctx):
    return _stage_ms(ctx, "loop/detect_correct", per="call")


def _stage_ms(ctx, stage, per):
    w = ctx.get("window")
    if not w or stage not in w["stages"]:
        return None
    calls, seconds = w["stages"][stage]
    n = w["frames"] if per == "frame" else calls
    return None if n == 0 else 1e3 * seconds / n
