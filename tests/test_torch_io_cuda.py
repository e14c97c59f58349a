"""SlamSystem.upload_image on the card (no JAX in this file: the card's
machine has none).

    python -m pytest -q -m gpu tests/test_torch_io_cuda.py

The upload is a pinned, non-blocking copy on the caller's current stream;
the tracker extracts on that stream, so an extraction from the uploaded
tensor must equal the extraction from the host array exactly.
"""

import numpy as np
import pytest
import torch

from orb_slam3_study_kr_tpu_torch.io import synthetic
from orb_slam3_study_kr_tpu_torch.ops import orb
from orb_slam3_study_kr_tpu_torch.pipeline import SlamSystem, SystemConfig


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_upload_image_on_the_card(dev):
    rng = np.random.default_rng(1)
    world = synthetic.make_textured_world(rng, depth=6.0)
    R, t = synthetic.lateral_trajectory(2, x_span=0.1)
    img = np.clip(synthetic.render_textured(world, R[0], t[0], rng=rng),
                  0, 255).astype(np.uint8)
    slam = SlamSystem(SystemConfig(device=str(dev)))
    up = slam.upload_image(img)
    assert up.is_cuda and up.dtype == torch.uint8
    assert slam.upload_image(up) is up
    f = slam.upload_image(img.astype(np.float64))
    assert f.is_cuda and f.dtype == torch.float32
    cfg = slam.cfg.tracker.orb_config
    a = orb.extract_orb(up, cfg)
    b = orb.extract_orb(torch.as_tensor(img, device=dev), cfg)
    torch.cuda.synchronize()
    for name in ("uv", "level", "angle", "desc", "valid"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    np.testing.assert_array_equal(up.cpu().numpy(), img)
