"""The plain references against hand-made cases."""

import numpy as np
import pytest
import torch

from portbench.reference import gated_nn, lm_schur, orb_dense, poses


def test_resize_weights_are_normalised():
    w = orb_dense.resize_weights(480, 400)
    np.testing.assert_allclose(w.sum(axis=0), 1.0, atol=1e-12)
    assert (w >= 0).all()


def test_pyramid_of_a_constant_image_is_constant():
    img = torch.full((48, 64), 77.0)
    sizes = orb_dense.level_sizes(48, 64, 4, 1.2)
    for lvl, (h, w) in zip(orb_dense.pyramid(img, sizes), sizes):
        assert lvl.shape == (h, w)
        torch.testing.assert_close(lvl, torch.full((h, w), 77.0,
                                                   dtype=torch.float64))


def test_fast_finds_a_lone_bright_pixel_and_nms_keeps_it():
    img = torch.zeros((32, 32))
    img[16, 16] = 100.0
    s = orb_dense.fast_score(img, 7.0)
    assert s[16, 16] == 100.0
    assert s.sum() == 100.0
    nms = orb_dense.nms3x3(s)
    assert nms[16, 16] == 100.0 and nms.sum() == 100.0
    maps = orb_dense.k1(img, 7.0, 20.0)
    assert maps[1, 16, 16] == 100.0


def test_blur_keeps_a_constant_and_the_mass():
    img = torch.full((20, 30), 5.0)
    torch.testing.assert_close(orb_dense.blur7(img), img)
    imp = torch.zeros((40, 40), dtype=torch.float64)
    imp[20, 20] = 1.0
    assert float(orb_dense.blur7(imp).sum()) == pytest.approx(1.0)


def test_compare_k1_counts_differences():
    g = torch.Generator().manual_seed(0)
    lv = [torch.rand((40, 48), generator=g) * 255]
    maps = [orb_dense.k1(lv[0], 7.0, 20.0)]
    assert orb_dense.compare_k1(lv, maps, 7.0, 20.0) == (0, 0.0)
    maps[0][0, 20, 20] += 1.0
    maps[0][3, 5, 5] += 0.25
    bad, err = orb_dense.compare_k1(lv, maps, 7.0, 20.0)
    assert bad == 1 and err == pytest.approx(0.25)


def _words(bits):
    b = torch.as_tensor(bits, dtype=torch.uint8).reshape(-1, 8, 32)
    sh = torch.arange(32, dtype=torch.int32)
    return torch.bitwise_left_shift(b.to(torch.int32), sh).sum(
        -1, dtype=torch.int32)


def test_gated_nn_hand_case():
    q = np.zeros((2, 256), np.uint8)
    t = np.zeros((3, 256), np.uint8)
    t[0, :10] = 1      # distance 10 to query 0
    t[1, :4] = 1       # distance 4, gated out by level
    t[2, :6] = 1       # distance 6
    q_uv = torch.tensor([[10.0, 10.0], [100.0, 100.0]])
    t_uv = torch.tensor([[11.0, 10.0], [10.0, 10.0], [12.0, 9.0]])
    args = (torch.as_tensor(q), q_uv, torch.tensor([0, 0]),
            torch.tensor([True, True]), torch.as_tensor(t), t_uv,
            torch.tensor([4.0, 4.0, 4.0]), torch.tensor([0, 3, 1]),
            torch.tensor([True, True, True]))
    best, second, idx = gated_nn.gated_nn(*args)
    assert idx[0] == 2 and best[0] == 6 and second[0] == 10
    # Query 1 is out of every radius: BIG, idx 0.
    assert best[1] == gated_nn.BIG and second[1] == gated_nn.BIG
    assert idx[1] == 0
    # Packed words give the same answer as bits.
    wargs = (_words(q),) + args[1:4] + (_words(t),) + args[5:]
    for a, b in zip(gated_nn.gated_nn(*wargs), (best, second, idx)):
        assert torch.equal(a, b)
    assert gated_nn.compare(args, (best, second, idx), 1) == 0
    assert gated_nn.passing_pairs(*args[1:4], *args[5:]) == 2


def test_gated_nn_first_index_wins_a_tie():
    q = torch.zeros((1, 256), dtype=torch.uint8)
    t = torch.zeros((3, 256), dtype=torch.uint8)
    i32 = dict(dtype=torch.int32)
    out = gated_nn.gated_nn(q, torch.zeros((1, 2)), torch.zeros(1, **i32),
                            torch.ones(1, dtype=torch.bool), t,
                            torch.zeros((3, 2)), torch.ones(3),
                            torch.zeros(3, **i32),
                            torch.ones(3, dtype=torch.bool))
    assert out[2][0] == 0 and out[0][0] == 0 and out[1][0] == 0


def _path(n):
    R = np.stack([np.eye(3)] * n)
    t = -np.stack([[0.02 * i, 0.0, 0.0] for i in range(n)])
    return R, t


def test_step_errors_zero_for_the_truth_and_one_for_a_frozen_state():
    R, t = _path(6)
    exact = [(R[i], t[i]) for i in range(6)]
    assert max(poses.step_errors(exact, R, t, 1.0)) == pytest.approx(0.0)
    frozen = [exact[0]] * 6
    assert poses.step_errors(frozen, R, t, 1.0) == pytest.approx([1.0] * 5)
    # A lag of one frame repeats the steps of constant motion: the check
    # reads the motion of each frame, not its position.
    lag = [exact[0]] + exact[:-1]
    assert poses.step_errors(lag, R, t, 1.0)[1:] == pytest.approx([0.0] * 4)
    # A monocular map at half scale, with its scale fitted.
    half = [None] + [(R[i], 0.5 * t[i]) for i in range(1, 6)]
    s = poses.fit_scale(half, R, t)
    assert s == pytest.approx(2.0)
    assert max(poses.step_errors(half, R, t, s)[1:]) == pytest.approx(0.0)
    assert poses.step_errors(half, R, t, s)[0] is None
    # Over k frames: the frame k before each one is compared.
    assert poses.step_errors(frozen, R, t, 1.0, k=3) == pytest.approx(
        [1.0] * 3)


def _ba_problem(noise):
    g = np.random.default_rng(3)
    K, M = 6, 120
    R = np.stack([np.eye(3)] * K)
    t = -np.stack([[0.1 * k, 0.0, 0.0] for k in range(K)])
    X = np.stack([g.uniform(-2, 2, M), g.uniform(-1.5, 1.5, M),
                  g.uniform(4, 8, M)], -1)
    op = np.repeat(np.arange(K), M)
    ol = np.tile(np.arange(M), K)
    p = X[ol] + t[op]
    fx, fy, cx, cy = 400.0, 400.0, 320.0, 240.0
    uv = np.stack([fx * p[:, 0] / p[:, 2] + cx, fy * p[:, 1] / p[:, 2] + cy],
                  -1)
    ur = np.where(p[:, 2] < 6, uv[:, 0] - 40.0 / p[:, 2], -1.0)
    t0 = t + noise * g.normal(size=t.shape)
    t0[:2] = t[:2]
    X0 = X + noise * g.normal(size=X.shape)
    fixed = np.zeros(K)
    fixed[:2] = 1
    T = torch.as_tensor
    return (T(R), T(t0), T(fixed), T(X0), T(op), T(ol), T(uv),
            T(np.zeros(op.size, np.int64)), T(ur), (fx, fy, cx, cy), 40.0), \
        (t, X)


def test_lm_schur_recovers_an_exact_problem():
    args, (t, X) = _ba_problem(0.02)
    R1, t1, X1, chi2 = lm_schur.solve(*args, n_iters=10)
    np.testing.assert_allclose(t1, t, atol=1e-6)
    np.testing.assert_allclose(X1, X, atol=1e-5)
    assert chi2.max() < 1e-8


def test_lm_schur_keeps_fixed_keyframes():
    args, (t, _) = _ba_problem(0.02)
    _, t1, _, _ = lm_schur.solve(*args, n_iters=3)
    np.testing.assert_array_equal(t1[:2], t[:2])


def test_culling_rule():
    chi2 = np.array([1.0, 6.5, 8.0, 1.0, 9.0, 0.5])
    ur = np.array([-1.0, -1.0, 3.0, -1.0, 2.0, 1.0])
    lm = np.array([0, 0, 1, 1, 2, 2])
    bad, gone = lm_schur.culled(chi2, ur, lm, 3)
    assert bad.tolist() == [False, True, True, False, True, False]
    assert gone.tolist() == [True, True, True]
    bad, gone = lm_schur.culled(np.ones(6), ur, lm, 3)
    assert not bad.any() and not gone.any()


def test_exp_se3_small_and_large_angles():
    xi = torch.tensor([[0.0, 0.0, 0.0, 1.0, 2.0, 3.0],
                       [0.0, 0.0, np.pi / 2, 0.0, 0.0, 0.0]],
                      dtype=torch.float64)
    R, t = lm_schur.exp_se3(xi)
    torch.testing.assert_close(R[0], torch.eye(3, dtype=torch.float64))
    torch.testing.assert_close(t[0], xi[0, 3:])
    torch.testing.assert_close(R[1], torch.tensor(
        [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
        dtype=torch.float64), atol=1e-12, rtol=0)
