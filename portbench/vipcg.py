"""The inertial BA's PCG loop (K4 at a state width of 15,
``ops/cuda_schur.vi_schur_pcg``): bytes and operations of one CG
iteration, frozen from the kernels' reads and writes, and its bound on
the card (``peaks.bound_s``).

Per observation: E's 18 values read once, y's 6 values written and read,
its pose and its pose-ordered position (two int32).  Per landmark:
Hll_inv's 9 values and an int32 offset.  Per state: D, U and Minv (225
values each), the pose's free flag and the 15 values' flags, an offset and
the chain's two neighbours (int32), and 177 values of the (K, 15) vectors
(A reads z and p over the pose slice, 12; B reads z and p and writes p and
Ap, 60; C reads p, Ap, x and r and writes x, r and z, 105).  Operations:
per observation E^T v and E z (2 x 18 multiply-adds), the direction and
the free flag (2 x 6), the pose sum (6); per landmark Hll_inv t (9
multiply-adds); per state D v, U v and U^T v and Minv r (4 x 225
multiply-adds) and about 100 for the updates.
"""

from portbench.peaks import bound_s

STATE = 15
OPS_PER_OBS = 2 * 2 * 18 + 2 * 6 + 6
OPS_PER_LM = 2 * 9
OPS_PER_STATE = 2 * 4 * STATE * STATE + 100


def iteration_bytes(K, M, O, item=4):
    return (O * (18 + 2 * 6) * item + O * 2 * 4 + M * (9 * item + 4)
            + K * ((3 * STATE * STATE + 1 + STATE + 177) * item + 3 * 4))


def iteration_ops(K, M, O):
    return O * OPS_PER_OBS + M * OPS_PER_LM + K * OPS_PER_STATE


def iteration_bound_s(K, M, O, item=4):
    """The least time one CG iteration could take on the card."""
    return bound_s(iteration_bytes(K, M, O, item), iteration_ops(K, M, O))
