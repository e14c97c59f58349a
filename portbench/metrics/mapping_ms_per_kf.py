"""Local mapping of a keyframe (``StageTimers`` "mapping/keyframe":
triangulation, fusion, local BA, culling), per keyframe of the window."""


def read(ctx):
    return _stage_ms(ctx, "mapping/keyframe", per="call")


def _stage_ms(ctx, stage, per):
    w = ctx.get("window")
    if not w or stage not in w["stages"]:
        return None
    calls, seconds = w["stages"][stage]
    n = w["frames"] if per == "frame" else calls
    return None if n == 0 else 1e3 * seconds / n
