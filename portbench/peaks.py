"""The card's published peaks and the hand-written kernels' byte and
operation counts, frozen from the port's own bound formulas
(``chip_smoke.py`` ``_bound`` and its constants).

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, 700 W):
HBM3 at 3.35 TB/s, float32 outside the tensor cores at 67 T/s, which the
integer and compare work of K1 and K2 is counted against.
"""

PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12

# K1 per pixel: FAST 16 differences + 2 polarities x (42 shared arc
# min/max + 15 max over the arcs) + 3, NMS 8 max + 2 thresholds + 2 maps x
# 3 compare/select, 2 blur passes x (7 mul + 6 add).  Bytes: the level's
# float32 pixel in, four float32 maps out.
K1_OPS_PER_PX = 16 + 2 * (42 + 15) + 3 + (8 + 2 + 2 * 3) + 2 * 13
K1_BYTES_PER_PX = 4 + 16
# K2 per pair: the gates = 10; a pair that passes adds 8 xor, 8 popcounts
# and 8 adds or compares = 24.  Bytes per query: 8 words, uv, level,
# validity in, best, second, idx out; per landmark: 8 words, uv, radius,
# level, validity.
K2_GATE_OPS, K2_PAIR_OPS = 10, 24
K2_Q_BYTES = 32 + 8 + 4 + 1 + 12
K2_T_BYTES = 32 + 8 + 4 + 4 + 1


def bound_s(nbytes, ops):
    """The least time the card could take: the larger of the bytes over
    the bandwidth and the operations over the rate."""
    return max(nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S)


def k1_bound_s(level_shapes):
    px = sum(h * w for h, w in level_shapes)
    return bound_s(px * K1_BYTES_PER_PX, px * K1_OPS_PER_PX)


def k2_bound_s(B, N, L, passing):
    """One launch over B batches of N queries against L landmarks, with
    ``passing`` pairs through the gates over the batch."""
    nbytes = B * N * K2_Q_BYTES + L * 32 + B * L * (K2_T_BYTES - 32)
    return bound_s(nbytes, B * N * L * K2_GATE_OPS + passing * K2_PAIR_OPS)
