"""Kernel launches on the card per traced frame (the trace's kernels,
copies and fills left out)."""


def read(ctx):
    s, w = ctx.get("trace"), ctx.get("window")
    if s is None or not w:
        return None
    return s["launches"] / w["trace_frames"]
