"""K1's (``csrc/fast_nms_blur.cu``) share of its roofline over the traced
frames: the bound of each launch at its own level shapes
(``peaks.k1_bound_s``) over the device time of the kernels named
``fast_nms_blur`` in the trace."""


def read(ctx):
    from portbench.kinds.session import k1_roofline
    return k1_roofline(ctx)
