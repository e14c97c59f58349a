"""The share of the traced window's device time in cuBLAS's matrix
kernels (names holding ``gemv`` or ``gemm``): the batched 3x3, 3x6 and 6x6
products of the BA's Jacobians and of every PCG matvec, which torch's
``einsum`` hands to cuBLAS one tiny matrix at a time."""


def read(ctx):
    s = ctx.get("trace")
    if s is None:
        return None
    busy = sum(v[1] for v in s["kernels"].values())
    t = sum(v[1] for k, v in s["kernels"].items()
            if "gemv" in k or "gemm" in k)
    return None if busy <= 0 else 100.0 * t / busy
