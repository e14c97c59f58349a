"""An asynchronous mono-inertial session through both packages.

``SystemConfig(sensor="mono-inertial", async_mapping=True)`` on the
inertial tests' path (seed 11), cut as ``test_torch_inertial_pipeline``
cuts it (``TrackerConfig(fps=3)``, IMU init times (0.9, 1.5, 2.1) s, a
0.3 s keyframe spacing) but to 16 frames, so that keyframes follow the
init.  The worker's timing decides which
map state a frame sees, so neither run is deterministic: each package is
held to the same walls, not to the other's numbers: the IMU initialized
(stage >= 1), the worker processed keyframes without an error and ran the
local inertial BA, the final state OK or RECENTLY_LOST (ROADMAP O1), and
the scaled ATE over more than half the frames under the synchronous
mono-inertial wall (0.35).
"""

import numpy as np
import pytest
import torch

from orb_slam3_study_kr_tpu.evaluation.ate import ate_rmse
from orb_slam3_study_kr_tpu.pipeline import SlamSystem as JSlamSystem
from orb_slam3_study_kr_tpu.pipeline import SystemConfig as JSystemConfig
from orb_slam3_study_kr_tpu.pipeline.tracking import TrackerConfig as JTrackerConfig
from orb_slam3_study_kr_tpu_torch.pipeline import SlamSystem, SystemConfig
from orb_slam3_study_kr_tpu_torch.pipeline.tracking import TrackerConfig
from test_torch_inertial_cuda import inertial_scenario

torch.set_num_threads(2)

N, TIMES, SPACING, FPS = 16, (0.9, 1.5, 2.1), 0.3, 3
ATE_WALL = 0.35          # test_mono_inertial_pipeline's scaled-ATE wall


@pytest.fixture(scope="module")
def scenario():
    return inertial_scenario(11, N, "mono-inertial")


def _session(pkg, frames, traj):
    kw = dict(sensor="mono-inertial", imu_init_times=TIMES,
              enable_loop_closing=False, async_mapping=True)
    if pkg == "jax":
        slam = JSlamSystem(JSystemConfig(tracker=JTrackerConfig(fps=FPS), **kw))
    else:
        slam = SlamSystem(SystemConfig(tracker=TrackerConfig(fps=FPS),
                                       device="cpu", **kw))
    slam.tracker.imu_init_spacing = SPACING
    ran = []                     # the worker's local inertial BA calls
    ba = slam.local_mapper.inertial_ba
    slam.local_mapper.inertial_ba = lambda kf: ran.append(ba(kf)) or ran[-1]
    try:
        for i in range(N):
            slam.track_monocular(frames[i][0], traj["timestamps"][i],
                                 imu=traj["imu"][i])
        slam.flush()
        rows = slam.trajectory()
        centres = -np.einsum("nij,nj->ni", traj["R_cw"].transpose(0, 2, 1),
                             traj["t_cw"])
        rmse, nm, _ = ate_rmse(rows[:, 0], rows[:, 1:4],
                               np.asarray(traj["timestamps"][:N]),
                               centres[:N], with_scale=True)
        return dict(state=slam.state.name, stage=slam.tracker.imu_stage,
                    worker=dict(slam.async_map.stats),
                    errors=slam.async_map.pop_errors(),
                    stages=sorted(slam.stats()["stages"]),
                    inertial_ba=sum(map(bool, ran)), ate=float(rmse),
                    nm=int(nm))
    finally:
        slam.shutdown()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_async_mono_inertial_session(scenario, pkg):
    r = _session(pkg, *scenario)
    print(pkg, r)
    assert r["stage"] >= 1, r
    assert r["worker"]["n_processed"] > 0, r
    assert r["worker"]["n_errors"] == 0 and not r["errors"], r
    assert "mapping/keyframe_bg" in r["stages"], r
    assert r["inertial_ba"] >= 1, r
    assert r["state"] in ("OK", "RECENTLY_LOST"), r
    assert r["nm"] > N // 2 and r["ate"] < ATE_WALL, r
