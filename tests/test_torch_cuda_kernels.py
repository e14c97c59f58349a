"""The hand-written CUDA kernels (K1 fast_nms_blur, K2 gated_nn, K3
hamming_nn) against their plain PyTorch versions on the card.  CUDA kernels have no CPU mode:
these tests skip where no card is present.  On a GPU machine run

    python -m pytest -q -m gpu tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from orb_slam3_study_kr_tpu_torch.ops import cuda_fast, cuda_hamming, cuda_matching
from orb_slam3_study_kr_tpu_torch.ops import orb, track_match

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build with nvcc for sm_90a")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("shape", [(480, 752), (134, 210), (33, 47)])
def test_k1_kernel_matches_plain(dev, shape):
    """Score and NMS maps bit-exact (wrapping shifts in both); blur within
    1e-4 (same tap order, round-to-nearest products in both)."""
    rng = np.random.default_rng(0)
    img = torch.as_tensor(rng.integers(0, 255, shape).astype(np.float32), device=dev)
    img = img + torch.rand(shape, device=dev) * (shape[0] % 2)
    ker = cuda_fast.fast_nms_blur(img, 7.0, 20.0)
    ref = cuda_fast.fast_nms_blur_plain(img, 7.0, 20.0)
    torch.cuda.synchronize()
    for a, b in zip(ker[:3], ref[:3]):
        assert torch.equal(a, b)
    assert float((ker[3] - ref[3]).abs().max()) < 1e-4


def _k2_args(dev, N, L, n_proto, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    proto = (torch.rand((n_proto, 256), generator=g, device=dev) < 0.5).to(torch.uint8)
    q = proto[torch.randint(0, n_proto, (N,), generator=g, device=dev)]
    t = proto[torch.randint(0, n_proto, (L,), generator=g, device=dev)]
    flip = torch.rand((L, 256), generator=g, device=dev) < 0.02
    t = torch.where(flip, 1 - t, t)
    return (q, torch.rand((N, 2), generator=g, device=dev) * 100,
            torch.randint(0, 8, (N,), generator=g, device=dev, dtype=torch.int32),
            torch.rand(N, generator=g, device=dev) < 0.9,
            t, torch.rand((L, 2), generator=g, device=dev) * 100,
            torch.rand(L, generator=g, device=dev) * 30,
            torch.randint(0, 8, (L,), generator=g, device=dev, dtype=torch.int32),
            torch.rand(L, generator=g, device=dev) < 0.8)


def _k2_equal(args, slack):
    """The kernel on bits and on packed words against the plain version
    on bits and on words: all four (best, second, idx) identical."""
    words = list(args)
    words[0] = cuda_matching.pack_desc(args[0])
    words[4] = cuda_matching.pack_desc(args[4])
    ref = cuda_matching.gated_nn_plain(*args, level_slack=slack)
    for out in (cuda_matching.gated_nn(*args, level_slack=slack),
                cuda_matching.gated_nn(*words, level_slack=slack),
                cuda_matching.gated_nn_plain(*words, level_slack=slack)):
        for a, b in zip(out, ref):
            assert torch.equal(a, b)
    return ref


@pytest.mark.parametrize("L", [1, 17, 255, 511, 4096, 5000])
def test_k2_kernel_matches_plain(dev, L):
    """(best, second, idx) identical, any L (smaller than the cluster, a
    ragged last chunk, chunks longer than one staged tile), on bits and on
    packed words, with ties among 6 prototypes and gated rows; the fuse
    step's batched layout (B = 3) too."""
    args = _k2_args(dev, 1000, L, 6, L)
    _k2_equal(args, 1)
    B = 3
    bargs = [a.expand(B, *a.shape) if i != 4 else a for i, a in enumerate(args)]
    _k2_equal(bargs, 7)


def test_k2_kernel_ties_and_all_gated(dev):
    """4 prototypes (nearly every distance ties), a quarter of the queries
    invalid, then every landmark gated: idx 0 and best = second = BIG."""
    args = list(_k2_args(dev, 1000, 4096, 4, 7))
    args[3][:250] = False
    best, second, idx = _k2_equal(args, 1)
    assert bool((best[:250] == cuda_matching.BIG).all())
    assert int((best < cuda_matching.BIG).sum()) > 100
    args[8] = torch.zeros_like(args[8])
    best, second, idx = _k2_equal(args, 1)
    assert bool((best == cuda_matching.BIG).all())
    assert bool((second == cuda_matching.BIG).all())
    assert not bool(idx.any())


def _pyramid(dev, sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.integers(0, 255, s).astype(np.float32)
                            + rng.random(s).astype(np.float32) * (i % 2),
                            device=dev) for i, s in enumerate(sizes)]


@pytest.mark.parametrize("sizes", [orb.OrbConfig().level_sizes,
                                   ((7, 7), (33, 47), (65, 33))],
                         ids=["752x480_pyramid", "odd_sizes"])
def test_k1_pyramid_matches_plain(dev, sizes):
    """One launch over all levels against the per-level plain version:
    score and NMS maps exact (interior and border), blur within 1e-4."""
    levels = _pyramid(dev, sizes)
    n0 = cuda_fast.fast_nms_blur_pyramid.launches
    ker = cuda_fast.fast_nms_blur_pyramid(levels, 7.0, 20.0)
    assert cuda_fast.fast_nms_blur_pyramid.launches == n0 + 1
    ref = cuda_fast.fast_nms_blur_pyramid_plain(levels, 7.0, 20.0)
    torch.cuda.synchronize()
    for k, r in zip(ker, ref):
        for a, b in zip(k[:3], r[:3]):
            assert torch.equal(a, b)
        assert float((k[3] - r[3]).abs().max()) < 1e-4


def test_wrappers_count_launches(dev):
    """One K1 launch per pyramid (and per single level), one K2 launch per
    call whether it is given bits or words; plain versions count none."""
    img = torch.zeros((64, 64), device=dev)
    n0 = cuda_fast.fast_nms_blur_pyramid.launches
    cuda_fast.fast_nms_blur(img, 7.0, 20.0)
    cuda_fast.fast_nms_blur_plain(img, 7.0, 20.0)
    assert cuda_fast.fast_nms_blur_pyramid.launches == n0 + 1
    cuda_fast.fast_nms_blur_pyramid([img, img[:40, :50].contiguous()], 7.0, 20.0)
    assert cuda_fast.fast_nms_blur_pyramid.launches == n0 + 2
    N, L = 5, 7
    args = (torch.zeros((N, 256), dtype=torch.uint8, device=dev),
            torch.zeros((N, 2), device=dev),
            torch.zeros(N, dtype=torch.int32, device=dev),
            torch.ones(N, dtype=torch.bool, device=dev),
            torch.zeros((L, 256), dtype=torch.uint8, device=dev),
            torch.zeros((L, 2), device=dev), torch.ones(L, device=dev),
            torch.zeros(L, dtype=torch.int32, device=dev),
            torch.ones(L, dtype=torch.bool, device=dev))
    n0 = cuda_matching.gated_nn.launches
    cuda_matching.gated_nn(*args)
    cuda_matching.gated_nn_plain(*args)
    assert cuda_matching.gated_nn.launches == n0 + 1
    words = list(args)
    words[0] = cuda_matching.pack_desc(args[0])
    words[4] = cuda_matching.pack_desc(args[4])
    cuda_matching.gated_nn(*words)
    assert cuda_matching.gated_nn.launches == n0 + 2


def _k3_equal(args):
    """Both K3 entry points, on bits and on packed words, against the plain
    versions: (best, second, idx) and back identical."""
    ref = cuda_hamming.hamming_nn_match_plain(*args)
    words = (cuda_matching.pack_desc(args[0]), args[1],
             cuda_matching.pack_desc(args[2]), args[3])
    for x in (args, words):
        rows = cuda_hamming.hamming_nn(*x)
        both = cuda_hamming.hamming_nn_match(*x)
        assert len(rows) == 3 and len(both) == 4
        for a, b in zip((*rows, *both), (*ref[:3], *ref)):
            assert a.shape == b.shape and a.dtype == b.dtype
            assert torch.equal(a, b)
    return ref


@pytest.mark.parametrize("Q,T", [(Q, T) for Q in (1, 1000)
                                 for T in (1, 255, 1000, 1001, 4000)]
                         + [(4000, 1000)])
def test_k3_kernel_matches_plain(dev, Q, T):
    """Rows and columns identical for any Q and T (below, at and above the
    cluster's 1024 targets), on bits and on packed words, with invalid
    queries and targets, an all-invalid batch row, ties among 6
    prototypes, and the loop window layout (shared queries against W = 11
    target sets) and the sides swapped (batched queries, shared targets);
    match_by_descriptor equal to its dense form, one launch per call."""
    g = torch.Generator(device=dev).manual_seed(Q + T)
    W = 11
    proto = (torch.rand((6, 256), generator=g, device=dev) < 0.5).to(torch.uint8)
    q = proto[torch.randint(0, 6, (Q,), generator=g, device=dev)]
    t = proto[torch.randint(0, 6, (W, T), generator=g, device=dev)]
    flip = torch.rand((W, T, 256), generator=g, device=dev) < 0.02
    t = torch.where(flip, 1 - t, t).contiguous()
    qv = torch.rand(Q, generator=g, device=dev) < 0.9
    tv = torch.rand((W, T), generator=g, device=dev) < 0.75
    tv[3] = False
    for args in ((q, qv, t[0], tv[0]), (q, qv, t, tv), (t, tv, q, qv)):
        _k3_equal(args)
    n0 = cuda_hamming.hamming_nn.launches
    for args in ((q, qv, t[0], tv[0]), (q, qv, t, tv)):
        a = track_match.match_by_descriptor(*args)
        b = track_match.match_by_descriptor_plain(*args)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert cuda_hamming.hamming_nn.launches == n0 + 2


def test_k3_columns_all_gated_and_ties(dev):
    """An all-invalid query set: every column's back is 0 and every row
    BIG; with 2 prototypes nearly every column ties, and back keeps the
    lowest query index."""
    g = torch.Generator(device=dev).manual_seed(11)
    proto = (torch.rand((2, 256), generator=g, device=dev) < 0.5).to(torch.uint8)
    q = proto[torch.randint(0, 2, (1000,), generator=g, device=dev)]
    t = proto[torch.randint(0, 2, (1000,), generator=g, device=dev)]
    qv = torch.rand(1000, generator=g, device=dev) < 0.8
    tv = torch.ones(1000, dtype=torch.bool, device=dev)
    best, second, idx, back = _k3_equal((q, qv, t, tv))
    first = [int(torch.nonzero(qv & (q == p).all(-1))[0]) for p in proto]
    assert set(back.tolist()) <= set(first)
    best, second, idx, back = _k3_equal((q, torch.zeros_like(qv), t, tv))
    assert not bool(back.any()) and not bool(idx.any())
    assert bool((best == cuda_matching.BIG).all())


def test_k3_wrapper_checks(dev):
    q = torch.zeros((4, 256), dtype=torch.uint8, device=dev)
    v = torch.ones(4, dtype=torch.bool, device=dev)
    for fn in (cuda_hamming.hamming_nn, cuda_hamming.hamming_nn_match):
        with pytest.raises(ValueError, match="dtype|is torch"):
            fn(q.float(), v, q, v)
        with pytest.raises(ValueError, match="contiguous"):
            fn(q, v, torch.zeros((256, 4), dtype=torch.uint8, device=dev).T, v)
        with pytest.raises(ValueError, match="on cpu"):
            fn(q, v, q.cpu(), v)
        with pytest.raises(ValueError, match="aligned"):
            fn(q, v, torch.zeros(4 * 256 + 1, dtype=torch.uint8,
                                 device=dev)[1:].view(4, 256), v)
