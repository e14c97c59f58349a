"""Parity of the torch port's ORB extraction and its K1 plain version with
the JAX reference package (CPU: the plain PyTorch path; K1's CUDA kernel is
held against this plain version on the card by chip_smoke.py and
tests/test_torch_cuda_kernels.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_study_kr_tpu.io import synthetic
from orb_slam3_study_kr_tpu.ops import orb as jorb
from orb_slam3_study_kr_tpu.ops.pallas_fast import fast_nms_blur_pallas
from orb_slam3_study_kr_tpu_torch.ops import cuda_fast
from orb_slam3_study_kr_tpu_torch.ops import orb as torb

torch.set_num_threads(2)

H, W = 128, 160

# The reference's per-level functions are not jitted on their own; eager
# dispatch of them takes seconds on the CPU.
_j_extract_level = jax.jit(jorb.extract_level, static_argnums=(1, 2),
                           static_argnames=("use_pallas",))
_j_build_pyramid = jax.jit(jorb.build_pyramid, static_argnums=(1,))
K_SMALL = np.array([[120.0, 0, 80.0], [0, 120.0, 64.0], [0, 0, 1]])


def _frame(seed=1, x=0.0):
    rng = np.random.default_rng(seed)
    world = synthetic.make_textured_world(rng, K=K_SMALL, width=W, height=H,
                                          depth=6.0)
    t = np.array([-x, 0.0, 0.0])
    return synthetic.render_textured(world, np.eye(3), t, rng=rng)


def _cfgs(n=300):
    return (jorb.OrbConfig(n_features=n, height=H, width=W),
            torb.OrbConfig(n_features=n, height=H, width=W))


def test_pattern_and_level_tables_match():
    np.testing.assert_array_equal(torb.PATTERN, jorb.PATTERN)
    jc, tc = _cfgs()
    assert tc.level_sizes == jc.level_sizes
    assert tc.level_quotas == jc.level_quotas
    assert tc.total_slots == jc.total_slots


@pytest.mark.parametrize("kind", ["uint8", "float"])
def test_k1_plain_matches_jnp_stage_and_pallas(kind):
    """K1's plain version against the jnp dense stage and the Pallas kernel
    in interpret mode.  Score/NMS maps: bit-exact on [8:-8] (the reference's
    own pass bar; the port wraps at the border like the jnp path, so it is
    exact everywhere against it).  Blur: within 1e-4 of both everywhere
    (7 products summed in order; XLA may contract into FMA)."""
    rng = np.random.default_rng(2)
    img = rng.integers(0, 255, (150, 256)).astype(np.float32)
    if kind == "float":
        img = img + rng.random(img.shape).astype(np.float32)
    s_raw, s20, s7, blur = [x.numpy() for x in cuda_fast.fast_nms_blur(
        torch.as_tensor(img), 7.0, 20.0)]
    j_raw = np.asarray(jorb.fast_score_map(jnp.asarray(img), 7.0))
    j20 = np.asarray(jorb._nms3x3(jnp.asarray(np.where(j_raw > 20.0, j_raw, 0.0))))
    j7 = np.asarray(jorb._nms3x3(jnp.asarray(j_raw)))
    jblur = np.asarray(jorb.gaussian_blur7(jnp.asarray(img)))
    np.testing.assert_array_equal(s_raw, j_raw)
    np.testing.assert_array_equal(s20, j20)
    np.testing.assert_array_equal(s7, j7)
    assert np.abs(blur - jblur).max() < 1e-4
    p_raw, p20, p7, pblur = [np.asarray(x) for x in fast_nms_blur_pallas(
        jnp.asarray(img), 7.0, 20.0, interpret=True)]
    c = np.s_[8:-8, 8:-8]
    np.testing.assert_array_equal(s_raw[c], p_raw[c])
    np.testing.assert_array_equal(s20[c], p20[c])
    np.testing.assert_array_equal(s7[c], p7[c])
    assert np.abs(blur - pblur).max() < 1e-4


def test_k1_pyramid_plain_matches_per_level_and_pallas():
    """fast_nms_blur_pyramid's plain route (the CPU) over the 8 level sizes
    of a 752x480 pyramid: identical to fast_nms_blur_plain level by level;
    against the Pallas kernel in interpret mode, each level lane-padded to
    a multiple of 128 as the reference's extract_level pads it, the score
    and NMS maps are bit-exact and the blur within 1e-4 on the interior
    [8:-8] (the padding and the kernel's row clamp reach 4 px in)."""
    cfg = torb.OrbConfig()
    rng = np.random.default_rng(6)
    img = rng.integers(0, 255, (cfg.height, cfg.width)).astype(np.float32)
    levels = torb.build_pyramid(torch.as_tensor(img), cfg)
    assert [tuple(x.shape) for x in levels] == list(cfg.level_sizes)
    maps = cuda_fast.fast_nms_blur_pyramid(levels, 7.0, 20.0)
    assert len(maps) == cfg.n_levels
    for lvl, (img_l, m) in enumerate(zip(levels, maps)):
        for a, b in zip(m, cuda_fast.fast_nms_blur_plain(img_l, 7.0, 20.0)):
            assert torch.equal(a, b), lvl
        H, W = img_l.shape
        padded = jnp.pad(jnp.asarray(img_l.numpy()), ((0, 0), (0, -(-W // 128) * 128 - W)))
        p = [np.asarray(x)[:, :W] for x in fast_nms_blur_pallas(
            padded, 7.0, 20.0, interpret=True)]
        c = np.s_[8:-8, 8:-8]
        for name, a, b in zip(("s_raw", "s20", "s7"), m[:3], p[:3]):
            np.testing.assert_array_equal(a.numpy()[c], b[c],
                                          err_msg=f"level {lvl} {name}")
        assert np.abs(m[3].numpy()[c] - p[3][c]).max() < 1e-4, lvl


def test_build_pyramid_matches_jax_resize():
    """Antialiased linear resize with the reference's weight matrices.
    Tolerance 2e-4 gray levels (of 0..255): weights agree to 2 ulp; the
    two matmuls sum in a different order than XLA's einsum."""
    img = _frame()
    jc, tc = _cfgs()
    jp = _j_build_pyramid(jnp.asarray(img), jc)
    tp = torb.build_pyramid(torch.as_tensor(img), tc)
    for l in range(jc.n_levels):
        assert tuple(tp[l].shape) == jp[l].shape
        assert np.abs(tp[l].numpy() - np.asarray(jp[l])).max() < 2e-4, l


@pytest.mark.parametrize("level", [0, 3])
def test_extract_level_exact_on_injected_image(level):
    """extract_level on the SAME level image injected into both packages:
    keypoints, responses and sub-pixel offsets are exact."""
    jc, tc = _cfgs()
    img_l = torb.build_pyramid(torch.as_tensor(_frame()), tc)[level].numpy()
    q = jc.level_quotas[level]
    jout = _j_extract_level(jnp.asarray(img_l), q, jc, use_pallas=False)
    tout = torb.extract_level(torch.as_tensor(img_l), q, tc)
    for name, a, b in zip(("xs", "ys", "resp", "valid", "fx", "fy", "blur"),
                          tout, jout):
        a, b = a.numpy(), np.asarray(b)
        if name == "blur":
            assert np.abs(a - b).max() < 1e-4
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_top_k_ties_lowest_index_first():
    """lax.top_k order among equal values (torch.topk's is unspecified)."""
    x = np.array([3, 5, 5, 1, 5, 2, 5, 5, 0], np.float32)
    vals, idx = torb._top_k(torch.as_tensor(x), 4)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(idx.numpy(), [1, 2, 4, 6])
    # Whole-cell selection on an integer score map full of ties.
    rng = np.random.default_rng(4)
    s = rng.integers(0, 4, (70, 105)).astype(np.float32) * 10
    s20 = np.where(s > 20, s, 0).astype(np.float32)
    a = torb.select_keypoints(torch.as_tensor(s20), torch.as_tensor(s), 40, 35, 8)
    b = jorb.select_keypoints(jnp.asarray(s20), jnp.asarray(s), 40, 35, 8)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u.numpy(), np.asarray(v))


@pytest.fixture(scope="module")
def extracted():
    img = _frame()
    jc, tc = _cfgs()
    jf, jpy = jorb.extract_orb(jnp.asarray(img), jc, with_pyramid=True,
                               use_pallas=False)
    tf, tpy = torb.extract_orb(torch.as_tensor(img), tc, with_pyramid=True)
    return jf, jpy, tf, tpy


def test_extract_orb_keypoint_sets_identical(extracted):
    """Full extract_orb on a 160x128 rendered frame: per-level keypoint sets
    identical (same valid slots, same pixel + sub-pixel positions to 1e-4
    px; the pyramid differs from the reference by ulps)."""
    jf, _, tf, _ = extracted
    np.testing.assert_array_equal(tf.level.numpy(), np.asarray(jf.level))
    np.testing.assert_array_equal(tf.valid.numpy(), np.asarray(jf.valid))
    v = np.asarray(jf.valid)
    assert v.sum() > 100
    np.testing.assert_allclose(tf.uv.numpy()[v], np.asarray(jf.uv)[v], atol=1e-4)
    np.testing.assert_allclose(tf.response.numpy()[v],
                               np.asarray(jf.response)[v], atol=1e-3)


def test_extract_orb_angle_desc_patch(extracted):
    """Orientation within 1e-3 rad; descriptor bits agree on >= 99.9% (a
    bit flips only when its two bilinear samples tie to within the ulp
    differences); patches within 1 gray level (truncation to uint8)."""
    jf, jpy, tf, tpy = extracted
    v = np.asarray(jf.valid)
    ang = np.angle(np.exp(1j * (tf.angle.numpy()[v] - np.asarray(jf.angle)[v])))
    assert np.abs(ang).max() < 1e-3
    agree = (tf.desc.numpy()[v] == np.asarray(jf.desc)[v]).mean()
    assert agree >= 0.999, agree
    dp = np.abs(tf.patch.numpy()[v].astype(int) - np.asarray(jf.patch)[v].astype(int))
    assert dp.max() <= 1
    assert np.abs(tpy.numpy() - np.asarray(jpy)).max() < 2e-4
