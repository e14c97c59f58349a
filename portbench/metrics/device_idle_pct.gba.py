"""The card's idle share of the traced solves: 100 (1 - busy / window)
from the profiler's trace."""


def read(ctx):
    s = ctx.get("trace")
    return None if s is None else 100.0 * (1.0 - s["busy_s"] / s["window_s"])
