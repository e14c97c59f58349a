"""The port's landmark-sharded BA (parallel/dist_ba.py) against the JAX
reference's, on 8 shards.

One module-scoped fixture builds five problems from numpy seeds (the
reference's dense and PCG problems of tests/test_parallel.py, a
dense-chunked one with more than 2048 landmarks per shard, a stereo one
with obs_ur / bf, and the KB8 wide-FOV one of
test_distributed_ba_fisheye_wide_fov), writes them to an .npz, and runs the
reference on an 8-device virtual CPU mesh in ONE subprocess
(``run_in_cpu_mesh``), which writes its partitions and solutions back.  The
port solves each problem on 8 CPU shards in this process.
"""

import functools

import numpy as np
import pytest
import torch

from conftest import run_in_cpu_mesh
from orb_slam3_study_kr_tpu_torch.cameras import kb8, pinhole
from orb_slam3_study_kr_tpu_torch.lie.se3 import exp_se3, se3_compose
from orb_slam3_study_kr_tpu_torch.parallel import (distributed_bundle_adjust,
                                                   make_ba_mesh)
from orb_slam3_study_kr_tpu_torch.parallel.dist_ba import (collectives_per_iter,
                                                           shard_ba_problem)
from orb_slam3_study_kr_tpu_torch.solvers.robust import CHI2_MONO, CHI2_STEREO

torch.set_num_threads(2)

N_SHARDS = 8
N_ITERS = 12
PIN = (458.0, 457.0, 376.0, 240.0, 0, 0, 0, 0, 0)
KB8 = (190.0, 190.0, 256.0, 256.0, 0.0034, 0.0008, -0.0007, 0.0002, 0)
BF = 458.0 * 0.11
# (camera, assembly, wide_fov, stereo) of each problem.
PROBLEMS = {"dense": ("pinhole", "dense", False, False),
            "pcg": ("pinhole", "pcg", False, False),
            "chunked": ("pinhole", "dense_chunked", False, False),
            "stereo": ("pinhole", "dense", False, True),
            "fisheye": ("kb8", "pcg", True, False)}


def _cam(name):
    return torch.tensor(PIN if name == "pinhole" else KB8, dtype=torch.float32)


def _fns(name):
    mod = pinhole if name == "pinhole" else kb8
    c = _cam(name)
    return functools.partial(mod.project, c), functools.partial(mod.project_jac, c)


def _exp(xi):
    R, t = exp_se3(torch.as_tensor(np.asarray(xi, np.float32)))
    return R.numpy(), t.numpy()


def _poses(n, step):
    Rs, ts = zip(*(_exp(np.asarray(step, np.float32) * k) for k in range(n)))
    return np.stack(Rs), np.stack(ts)


def _visible_obs(R_gt, t_gt, X_gt, rng, sigma=0.5, stereo=False):
    project = _fns("pinhole")[0]
    op, ol, ouv, our = [], [], [], []
    for k in range(R_gt.shape[0]):
        p = X_gt @ R_gt[k].T + t_gt[k]
        uv = project(torch.as_tensor(p)).numpy()
        vis = ((p[:, 2] > 0.5) & (uv[:, 0] > 0) & (uv[:, 0] < 752)
               & (uv[:, 1] > 0) & (uv[:, 1] < 480))
        for j in np.nonzero(vis)[0]:
            op.append(k)
            ol.append(j)
            ouv.append(uv[j] + rng.normal(0, sigma, 2))
            if stereo:
                # Every third observation is mono-only (ur = -1).
                our.append(-1.0 if j % 3 == 0 else
                           uv[j, 0] - BF / p[j, 2] + rng.normal(0, sigma))
    n = len(op)
    return dict(op=np.array(op, np.int32), ol=np.array(ol, np.int32),
                ouv=np.array(ouv, np.float32), olev=np.zeros(n, np.int32),
                om=np.ones(n, np.float32),
                our=np.array(our, np.float32) if stereo else None)


def _pinhole_problem(seed, n_poses, n_points, step, stereo=False):
    """tests/test_parallel.py's problem: points in front of a lateral
    path, every visible observation with 0.5 px noise, poses perturbed by
    0.01 (the first fixed), landmarks by 0.05."""
    rng = np.random.default_rng(seed)
    X_gt = np.stack([rng.uniform(-5, 5, n_points), rng.uniform(-4, 4, n_points),
                     rng.uniform(6, 14, n_points)], -1).astype(np.float32)
    R_gt, t_gt = _poses(n_poses, step)
    obs = _visible_obs(R_gt, t_gt, X_gt, rng, stereo=stereo)
    pert = rng.normal(0, 0.01, (n_poses, 6)).astype(np.float32)
    pert[0] = 0
    dR, dt = exp_se3(torch.as_tensor(pert))
    R0, t0 = se3_compose(dR, dt, torch.as_tensor(R_gt), torch.as_tensor(t_gt))
    X0 = X_gt + rng.normal(0, 0.05, X_gt.shape).astype(np.float32)
    fixed = np.zeros(n_poses, np.float32)
    fixed[0] = 1.0
    return dict(R0=R0.numpy(), t0=t0.numpy(), fixed=fixed, X0=X0, X_gt=X_gt,
                R_gt=R_gt, t_gt=t_gt, **obs)


def _fisheye_problem():
    """test_distributed_ba_fisheye_wide_fov's problem: 64 frontal points
    and 64 points 95-110 degrees off-axis (z < 0), poses frozen, the
    wide-angle landmarks perturbed by 0.08."""
    rng = np.random.default_rng(3)
    theta = np.concatenate([rng.uniform(0.2, 1.0, 64),
                            rng.uniform(np.radians(95), np.radians(110), 64)])
    phi = rng.uniform(0, 2 * np.pi, 128)
    rad = rng.uniform(4, 8, 128)
    X_gt = np.stack([rad * np.sin(theta) * np.cos(phi),
                     rad * np.sin(theta) * np.sin(phi),
                     rad * np.cos(theta)], -1).astype(np.float32)
    wide = np.arange(128) >= 64
    R_gt, t_gt = _poses(4, [0.01, -0.01, 0.005, 0.6, 0.3, 0.1])
    project = _fns("kb8")[0]
    op, ol, ouv = [], [], []
    for k in range(4):
        uv = project(torch.as_tensor(X_gt @ R_gt[k].T + t_gt[k])).numpy()
        for j in range(128):
            op.append(k)
            ol.append(j)
            ouv.append(uv[j] + rng.normal(0, 0.1, 2))
    n = len(op)
    X0 = X_gt.copy()
    X0[wide] += rng.normal(0, 0.08, (64, 3)).astype(np.float32)
    return dict(R0=R_gt, t0=t_gt, fixed=np.ones(4, np.float32), X0=X0,
                X_gt=X_gt, R_gt=R_gt, t_gt=t_gt, wide=wide,
                op=np.array(op, np.int32), ol=np.array(ol, np.int32),
                ouv=np.array(ouv, np.float32), olev=np.zeros(n, np.int32),
                om=np.ones(n, np.float32), our=None)


def _problems():
    base = _pinhole_problem(0, 6, 400, [0.02, -0.01, 0.005, 0.4, 0.02, 0.0])
    return {
        "dense": base, "pcg": base,
        # 8 x 2100 landmarks: two chunks per shard (2048 + 52).
        "chunked": _pinhole_problem(1, 4, 8 * 2100,
                                    [0.01, -0.005, 0.002, 0.3, 0.01, 0.0]),
        "stereo": _pinhole_problem(2, 5, 400,
                                   [0.02, -0.01, 0.005, 0.3, 0.02, 0.0],
                                   stereo=True),
        "fisheye": _fisheye_problem(),
    }


REFERENCE_PROGRAM = r"""
import functools, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from orb_slam3_study_kr_tpu.cameras import kb8, pinhole
from orb_slam3_study_kr_tpu.parallel import distributed_bundle_adjust, make_ba_mesh
from orb_slam3_study_kr_tpu.parallel.dist_ba import shard_ba_problem

assert len(jax.devices()) == 8
src, dst = sys.argv[1], sys.argv[2]
d = np.load(src)
mesh = make_ba_mesh()
shd = NamedSharding(mesh, P("data"))
rep = NamedSharding(mesh, P())
put = lambda a, s: jax.device_put(jnp.asarray(a), s)
out = {}
for name in d["names"]:
    g = lambda k: d[f"{name}/{k}"]
    camn, assembly, wide_fov, stereo = (str(g("camera")), str(g("assembly")),
                                       bool(g("wide_fov")), bool(g("stereo")))
    mod = pinhole if camn == "pinhole" else kb8
    cam = jnp.asarray(g("cam"), jnp.float32)
    our = g("our") if stereo else None
    parts = shard_ba_problem(mesh, 8, g("X0"), np.ones(g("X0").shape[0], np.float32),
                             g("op"), g("ol"), g("ouv"), g("olev"), g("om"),
                             obs_ur=our)
    keys = ["X", "lmm", "op", "ol", "ouv", "olev", "om"] + (["our"] if stereo else [])
    keys += ["dev_of_lm", "local_of_lm", "Mb", "obs_slot"]
    for k, v in zip(keys, parts):
        out[f"{name}/shard/{k}"] = np.asarray(v)
    kw = dict(obs_ur=put(parts[7], shd), bf=jnp.float32(g("bf"))) if stereo else {}
    # The dense-chunked problem is also solved with the one-chunk dense
    # assembly: the same system, without the chunk scatter.
    for tag, asm in (("out", assembly), ("dense_out", "dense")):
        if tag == "dense_out" and assembly != "dense_chunked":
            continue
        R, t, X, chi2 = distributed_bundle_adjust(
            mesh, functools.partial(mod.project, cam),
            functools.partial(mod.project_jac, cam),
            put(g("R0"), rep), put(g("t0"), rep), put(g("fixed"), rep),
            *(put(parts[i], shd) for i in range(7)),
            n_iters=int(g("n_iters")), assembly=asm, wide_fov=wide_fov, **kw)
        for k, v in zip(("R", "t", "X", "chi2"), (R, t, X, chi2)):
            out[f"{name}/{tag}/{k}"] = np.asarray(v)
np.savez(dst, **out)
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    probs = _problems()
    tmp = tmp_path_factory.mktemp("dist_ba")
    src, dst = str(tmp / "problems.npz"), str(tmp / "reference.npz")
    flat = {"names": np.array(list(PROBLEMS))}
    for name, (camn, assembly, wide_fov, stereo) in PROBLEMS.items():
        p = probs[name]
        for k in ("R0", "t0", "fixed", "X0", "op", "ol", "ouv", "olev", "om"):
            flat[f"{name}/{k}"] = p[k]
        if stereo:
            flat[f"{name}/our"] = p["our"]
        flat.update({f"{name}/camera": camn, f"{name}/assembly": assembly,
                     f"{name}/wide_fov": wide_fov, f"{name}/stereo": stereo,
                     f"{name}/cam": np.asarray(_cam(camn)), f"{name}/bf": BF,
                     f"{name}/n_iters": N_ITERS})
    np.savez(src, **flat)
    code = ("import sys; sys.argv[1:] = " + repr([src, dst]) + "\n"
            + REFERENCE_PROGRAM)
    res = run_in_cpu_mesh(code, n_devices=N_SHARDS)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "REFERENCE_OK" in res.stdout
    ref = dict(np.load(dst))
    return probs, ref


def _shard(p, n):
    return shard_ba_problem(n, p["X0"], np.ones(p["X0"].shape[0], np.float32),
                            p["op"], p["ol"], p["ouv"], p["olev"], p["om"],
                            obs_ur=p["our"])


def _solve(name, p, n_shards):
    camn, assembly, wide_fov, stereo = PROBLEMS[name]
    parts = _shard(p, n_shards)
    mesh = make_ba_mesh([torch.device("cpu")] * n_shards)
    sharded = [torch.as_tensor(a) for a in parts[:-4]]
    kw = dict(obs_ur=sharded.pop(), bf=BF) if stereo else {}
    R, t, X, chi2 = distributed_bundle_adjust(
        mesh, *_fns(camn), torch.as_tensor(p["R0"]), torch.as_tensor(p["t0"]),
        torch.as_tensor(p["fixed"]), *sharded, n_iters=N_ITERS,
        assembly=assembly, wide_fov=wide_fov, **kw)
    dev_of_lm, local_of_lm, Mb, obs_slot = parts[-4:]
    R, t, X, chi2 = (a.cpu().numpy() for a in (R, t, X, chi2))
    return dict(R=R, t=t, X=X, chi2=chi2, X_lm=X[dev_of_lm * Mb + local_of_lm],
                obs_slot=obs_slot, mesh=mesh)


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_shard_ba_problem_matches_reference(reference, name):
    """The port's copy of the host partitioner gives the reference's
    arrays, array for array."""
    probs, ref = reference
    keys = (["X", "lmm", "op", "ol", "ouv", "olev", "om"]
            + (["our"] if PROBLEMS[name][3] else [])
            + ["dev_of_lm", "local_of_lm", "Mb", "obs_slot"])
    parts = _shard(probs[name], N_SHARDS)
    assert len(parts) == len(keys)
    for k, v in zip(keys, parts):
        np.testing.assert_array_equal(np.asarray(v), ref[f"{name}/shard/{k}"],
                                      err_msg=k)


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_distributed_ba_matches_reference(reference, name):
    """8 CPU shards against the reference's 8 devices: poses within 1e-3
    (ROADMAP's bar for BA poses), median landmark difference within 1e-3,
    and the same observations over the chi2 gate, except those within
    1e-3 relative of it.  Then, on the reference tests' own problems,
    their walls against the ground truth.

    The dense-chunked problem is held to the reference's one-chunk dense
    solve of the same system: the reference's chunk scatter
    (``.at[op, ol - c0].add(E, mode="drop")``) wraps the negative local
    indices of earlier chunks' observations into the chunk instead of
    dropping them, so its dense-chunked solve of a shard with more than
    2048 landmarks is another system (ROADMAP section 3), which
    this test shows."""
    probs, ref = reference
    p = probs[name]
    out = _solve(name, p, N_SHARDS)
    tag = "dense_out" if name == "chunked" else "out"
    g = lambda k: ref[f"{name}/{tag}/{k}"]   # noqa: E731
    if name == "chunked":
        assert np.abs(ref[f"{name}/out/R"] - g("R")).max() > 1e-2
    np.testing.assert_allclose(out["R"], g("R"), atol=1e-3)
    np.testing.assert_allclose(out["t"], g("t"), atol=1e-3)
    assert out["X"].shape == g("X").shape
    dX = np.linalg.norm(out["X"] - g("X"), axis=1)
    assert np.median(dX) < 1e-3, np.median(dX)
    live = out["obs_slot"] >= 0
    gate = CHI2_MONO
    if PROBLEMS[name][3]:
        gate = np.where(p["our"][out["obs_slot"][live]] >= 0, CHI2_STEREO,
                        CHI2_MONO)
    cp, cr = out["chi2"][live], g("chi2")[live]
    near = np.abs(cr - gate) <= 1e-3 * gate
    assert ((cp > gate) == (cr > gate))[~near].all()
    # The reference tests' walls on the port's solve.
    X_lm = out["X_lm"]
    if name == "fisheye":
        w = p["wide"]
        assert np.median(np.linalg.norm(X_lm[w] - p["X_gt"][w], axis=1)) < 0.02
        chi2 = np.zeros(p["op"].shape[0], np.float32)
        chi2[out["obs_slot"][live]] = cp
        assert np.median(chi2[w[p["ol"]]]) < CHI2_MONO
    elif name in ("dense", "pcg"):
        assert np.median(np.linalg.norm(X_lm - p["X_gt"], axis=1)) < 0.05


def test_eight_shards_match_one_shard(reference):
    """The same function at 8 shards and at 1: poses within 1e-4.  Each
    LM iteration makes collectives_per_iter reductions (one more for the
    initial cost)."""
    probs, _ = reference
    for name in ("dense", "pcg"):
        one = _solve(name, probs[name], 1)
        eight = _solve(name, probs[name], N_SHARDS)
        np.testing.assert_allclose(eight["R"], one["R"], atol=1e-4)
        np.testing.assert_allclose(eight["t"], one["t"], atol=1e-4)
        assert eight["mesh"].n_psum == 1 + N_ITERS * collectives_per_iter(
            PROBLEMS[name][1])


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def test_pipeline_gba_through_mesh():
    """The pipeline's global_bundle_adjustment routed through an 8-shard
    CPU mesh (tests/test_parallel.py::test_pipeline_gba_through_mesh's map
    and walls: keyframe translations within 1e-3 of the truth, median
    landmark error within 1e-3), and the same map solved on one device
    within 1e-4."""
    from orb_slam3_study_kr_tpu_torch.pipeline.global_ba import (
        global_bundle_adjustment)
    from orb_slam3_study_kr_tpu_torch.pipeline.tracking import TrackerConfig
    from orb_slam3_study_kr_tpu_torch.slam_map.map_state import NO_LM, MapState

    cfg = TrackerConfig(device="cpu")

    def build():
        rng = np.random.default_rng(7)
        n_kf, n_lm, max_kp = 8, 400, 512
        X_gt = rng.uniform([-3, -2, 5], [3, 2, 10], (n_lm, 3)).astype(np.float32)
        m = MapState(max_kf=16, max_kp=max_kp, max_lm=4096)
        lm_ids = m.add_landmarks(
            X_gt + rng.normal(0, 0.05, X_gt.shape).astype(np.float32),
            rng.integers(0, 2, (n_lm, 256)).astype(np.uint8), first_kf=0)
        t_gt = []
        for k in range(n_kf):
            R = _rot_y(0.03 * k)
            t = np.array([0.25 * k, 0.02 * k, 0], np.float32)
            t_gt.append(t)
            Rn, tn = R, t
            if k >= 2:
                Rn = (_rot_y(rng.normal(0, 0.01)) @ R).astype(np.float32)
                tn = (t + rng.normal(0, 0.03, 3)).astype(np.float32)
            pc = X_gt @ R.T + t
            uv = np.stack([cfg.fx * pc[:, 0] / pc[:, 2] + cfg.cx,
                           cfg.fy * pc[:, 1] / pc[:, 2] + cfg.cy], -1)
            uv_full = np.zeros((max_kp, 2), np.float32)
            uv_full[:n_lm] = uv
            valid = np.zeros(max_kp, bool)
            valid[:n_lm] = True
            kp_lm = np.full(max_kp, NO_LM, np.int32)
            kp_lm[:n_lm] = lm_ids
            m.add_keyframe(Rn, tn, uv_full, np.zeros(max_kp, np.int32),
                           np.zeros(max_kp, np.float32), valid,
                           rng.integers(0, 2, (max_kp, 256)).astype(np.uint8),
                           frame_id=k, timestamp=0.1 * k, kp_lm=kp_lm)
        return m, lm_ids, X_gt, np.stack(t_gt)

    m, lm_ids, X_gt, t_gt = build()
    mesh = make_ba_mesh([torch.device("cpu")] * N_SHARDS)
    assert global_bundle_adjustment(cfg, m, n_iters=12, mesh=mesh)
    assert mesh.n_psum == 1 + 12 * collectives_per_iter("dense_chunked")
    t_err = np.linalg.norm(m.kf_t[:8] - t_gt, axis=1).max()
    assert t_err < 1e-3, t_err
    lm_err = np.linalg.norm(m.lm_pos[lm_ids] - X_gt, axis=1)
    assert np.median(lm_err) < 1e-3, np.median(lm_err)
    m1, *_ = build()
    assert global_bundle_adjustment(cfg, m1, n_iters=12)
    np.testing.assert_allclose(m.kf_t[:8], m1.kf_t[:8], atol=1e-4)
    np.testing.assert_allclose(m.kf_R[:8], m1.kf_R[:8], atol=1e-4)


def test_system_ba_devices_builds_a_mesh_for_every_loop_closer():
    """SystemConfig(ba_devices=2, device="cpu"): a mesh of 2 CPU shards
    that every LoopCloser the session builds carries (the first map's, a
    spawned map's, the one convert installs); ba_devices=0 and 1 build
    none."""
    from orb_slam3_study_kr_tpu_torch.bow import KeyframeDatabase
    from orb_slam3_study_kr_tpu_torch.pipeline import SlamSystem, SystemConfig

    for n in (0, 1):
        assert SlamSystem(SystemConfig(ba_devices=n, device="cpu")).ba_mesh is None
    slam = SlamSystem(SystemConfig(ba_devices=2, device="cpu"))
    mesh = slam.ba_mesh
    assert mesh.size == 2 and mesh.devices == (torch.device("cpu"),) * 2
    assert mesh.group is None
    lc = slam._loop_closer(slam.atlas.active_map, None)
    assert lc.ba_mesh is mesh
    slam.db = KeyframeDatabase(None)
    slam._new_active_map()
    assert slam.loop_closer.ba_mesh is mesh


def test_make_ba_mesh_cpu_shards_and_gather():
    """A mesh's psum adds its shards' partials in shard order; local_rows
    and gather without a group are the whole array."""
    mesh = make_ba_mesh(["cpu", "cpu", "cpu"])
    parts = [torch.full((2,), float(i)) for i in range(3)]
    assert torch.equal(mesh.psum(parts), torch.full((2,), 3.0))
    assert mesh.n_psum == 1 and mesh.size == 3 and mesh.rank == 0
    a = np.arange(12).reshape(6, 2)
    np.testing.assert_array_equal(mesh.local_rows(a), a)
    np.testing.assert_array_equal(mesh.gather(torch.as_tensor(a)), a)
