"""The share of the traced window's device time in kernels whose names
hold ``segment_reduce`` (``ops/segment.py``'s fixed-order sums)."""


def read(ctx):
    from portbench.trace import kernel_seconds
    s = ctx.get("trace")
    if s is None:
        return None
    busy = sum(v[1] for v in s["kernels"].values())
    n, t = kernel_seconds(s, "segment_reduce")
    return None if n == 0 or busy <= 0 else 100.0 * t / busy
