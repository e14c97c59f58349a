"""Keyframes the window's frames made, per 100 frames (one
"mapping/keyframe" stage per keyframe)."""


def read(ctx):
    w = ctx.get("window")
    if not w or not w["frames"]:
        return None
    calls = w["stages"].get("mapping/keyframe", (0, 0.0))[0]
    return 100.0 * calls / w["frames"]
