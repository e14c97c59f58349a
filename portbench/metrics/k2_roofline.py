"""K2's (``csrc/gated_nn.cu``) share of its roofline over the traced
frames: the bound of each launch at its own shapes and passing pairs
(``peaks.k2_bound_s``) over the device time of the kernels named
``gated_nn`` in the trace."""


def read(ctx):
    from portbench.kinds.session import k2_roofline
    return k2_roofline(ctx)
