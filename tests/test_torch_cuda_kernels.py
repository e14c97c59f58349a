"""The hand-written CUDA kernels (K1 fast_nms_blur, K2 gated_nn, K3
hamming_nn) against their plain PyTorch versions on the card.  CUDA kernels have no CPU mode:
these tests skip where no card is present.  On a GPU machine run

    python -m pytest -q -m gpu tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from orb_slam3_study_kr_tpu_torch.ops import cuda_fast, cuda_hamming, cuda_matching
from orb_slam3_study_kr_tpu_torch.ops import track_match

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


@pytest.mark.parametrize("L", [1, 255, 4096, 5000])
def test_k2_kernel_matches_plain(dev, L):
    """(best, second, idx) identical, any L, with ties and gated rows."""
    g = torch.Generator(device=dev).manual_seed(L)
    N = 1000
    proto = (torch.rand((6, 256), generator=g, device=dev) < 0.5).to(torch.uint8)
    q = proto[torch.randint(0, 6, (N,), generator=g, device=dev)]
    t = proto[torch.randint(0, 6, (L,), generator=g, device=dev)]
    flip = torch.rand((L, 256), generator=g, device=dev) < 0.02
    t = torch.where(flip, 1 - t, t)
    args = (q, torch.rand((N, 2), generator=g, device=dev) * 100,
            torch.randint(0, 8, (N,), generator=g, device=dev, dtype=torch.int32),
            torch.rand(N, generator=g, device=dev) < 0.9,
            t, torch.rand((L, 2), generator=g, device=dev) * 100,
            torch.rand(L, generator=g, device=dev) * 30,
            torch.randint(0, 8, (L,), generator=g, device=dev, dtype=torch.int32),
            torch.rand(L, generator=g, device=dev) < 0.8)
    ker = cuda_matching.gated_nn(*args, level_slack=1)
    ref = cuda_matching.gated_nn_plain(*args, level_slack=1)
    for a, b in zip(ker, ref):
        assert torch.equal(a, b)
    # Batched (the fuse step's layout): three neighbour rows.
    B = 3
    bargs = [a.expand(B, *a.shape) if i != 4 else a for i, a in enumerate(args)]
    kb = cuda_matching.gated_nn(*bargs, level_slack=7)
    rb = cuda_matching.gated_nn_plain(*bargs, level_slack=7)
    for a, b in zip(kb, rb):
        assert torch.equal(a, b)


def test_wrappers_count_launches(dev):
    img = torch.zeros((64, 64), device=dev)
    n0 = cuda_fast.fast_nms_blur.launches
    cuda_fast.fast_nms_blur(img, 7.0, 20.0)
    cuda_fast.fast_nms_blur_plain(img, 7.0, 20.0)
    assert cuda_fast.fast_nms_blur.launches == n0 + 1
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


@pytest.mark.parametrize("T", [1, 255, 1000, 1001])
def test_k3_kernel_matches_plain(dev, T):
    """(best, second, idx) identical for any T, with invalid queries and
    targets, an all-invalid batch row, ties among 6 prototypes, and the
    loop window layout (shared queries, batched targets, and the column
    pass with the sides swapped); match_by_descriptor equal to its dense
    form."""
    g = torch.Generator(device=dev).manual_seed(T)
    Q, W = 1000, 11
    proto = (torch.rand((6, 256), generator=g, device=dev) < 0.5).to(torch.uint8)
    q = proto[torch.randint(0, 6, (Q,), generator=g, device=dev)]
    t = proto[torch.randint(0, 6, (W, T), generator=g, device=dev)]
    flip = torch.rand((W, T, 256), generator=g, device=dev) < 0.02
    t = torch.where(flip, 1 - t, t).contiguous()
    qv = torch.rand(Q, generator=g, device=dev) < 0.9
    tv = torch.rand((W, T), generator=g, device=dev) < 0.75
    tv[3] = False
    for args in ((q, qv, t[0], tv[0]), (q, qv, t, tv), (t, tv, q, qv)):
        ker = cuda_hamming.hamming_nn(*args)
        ref = cuda_hamming.hamming_nn_plain(*args)
        for a, b in zip(ker, ref):
            assert torch.equal(a, b)
    n0 = cuda_hamming.hamming_nn.launches
    for args in ((q, qv, t[0], tv[0]), (q, qv, t, tv)):
        a = track_match.match_by_descriptor(*args)
        b = track_match.match_by_descriptor_plain(*args)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert cuda_hamming.hamming_nn.launches == n0 + 4


def test_k3_wrapper_checks(dev):
    q = torch.zeros((4, 256), dtype=torch.uint8, device=dev)
    v = torch.ones(4, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="dtype|is torch"):
        cuda_hamming.hamming_nn(q.float(), v, q, v)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_hamming.hamming_nn(q, v, torch.zeros((256, 4), dtype=torch.uint8,
                                                  device=dev).T, v)
    with pytest.raises(ValueError, match="on cpu"):
        cuda_hamming.hamming_nn(q, v, q.cpu(), v)
