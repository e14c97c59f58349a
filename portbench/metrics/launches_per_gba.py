"""Kernel launches on the card per traced global BA (the trace's kernels,
copies and fills left out)."""


def read(ctx):
    s, g = ctx.get("trace"), ctx.get("gba")
    if s is None or not g:
        return None
    return s["launches"] / g["trace_solves"]
