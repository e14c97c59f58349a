"""The ambiguous-observation weights (``ambig_obs_weight=0.5``, one fused
frame) and the reference-keyframe flow anchor (``refkf_anchor=True``, the
motion model's fused round and the local-map rounds) on the port against
the JAX reference, from the reference's carried state; the scenario and
the bars of test_torch_tracker_knobs.py, which holds the other two knobs.
"""

import pytest
import torch

from test_torch_tracker_knobs import (K_FRAME, _frames, check_carried_frame,
                                      check_session, reference_run)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def frames():
    return _frames(K_FRAME + 1)


@pytest.fixture(scope="module", params=["ambig", "refkf_anchor"])
def reference(request, frames):
    return reference_run(request.param, frames)


def test_knob_frame_from_carried_state(reference, frames):
    """Frame K from the reference's state: pose within 1e-4 (map units,
    rotation entries), inliers within 1 %, >= 99 % of bindings equal."""
    check_carried_frame(*reference, frames)


@pytest.mark.slow
@pytest.mark.parametrize("knob", ["ambig", "refkf_anchor"])
def test_knob_session_matches_reference(knob):
    """The 18-frame session with the knob through both packages, the
    reference's RANSAC draws injected (see check_session)."""
    check_session(knob)
