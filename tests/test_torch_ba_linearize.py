"""K5's plain twin (``ops/cuda_reproj.py``) and its route on the CPU.

The twin computes the kernel's linearize and cost passes one rounded step
at a time, in the kernel's order; here it is held to the solvers' own
einsum linearization (``solvers/local_ba.bundle_adjust``'s ``compute``,
``solvers/inertial_ba``'s ``vis_terms``) for both pose parametrisations,
and the route to the solvers' inputs: K5 only for one-shard PCG solves on
the card with a zero-distortion pinhole camera.  ``_card`` forced on
runs the route here, through the twin.

    python -m pytest -q tests/test_torch_ba_linearize.py
"""

import functools

import numpy as np
import pytest
import torch

from orb_slam3_study_kr_tpu_torch.cameras import kb8, pinhole
from orb_slam3_study_kr_tpu_torch.cameras.camera import (Camera, CameraKind,
                                                         make_kb8,
                                                         make_pinhole)
from orb_slam3_study_kr_tpu_torch.ops import cuda_reproj
from orb_slam3_study_kr_tpu_torch.parallel.dist_ba import (
    distributed_bundle_adjust, make_ba_mesh, shard_ba_problem)
from orb_slam3_study_kr_tpu_torch.solvers import bundle_adjust, local_ba
from orb_slam3_study_kr_tpu_torch.solvers.linalg_nan import inv_nan
from orb_slam3_study_kr_tpu_torch.utils import DEFAULT_TIMERS
from test_torch_ba_linearize_cuda import (BF, k5_problem, k5_state, vi_chain,
                                          vi_solve)

CPU = torch.device("cpu")


@pytest.fixture
def forced(monkeypatch):
    """The K5 route on the CPU: the solvers take it through the twin."""
    monkeypatch.setattr(cuda_reproj, "_card", lambda dev: True)


@pytest.fixture
def passes(monkeypatch):
    """Counts of the solvers' K5 passes, by kind."""
    n = {"linearize": 0, "cost": 0}
    for name in n:
        orig = getattr(cuda_reproj, name)

        def counted(*a, _name=name, _orig=orig, **kw):
            n[_name] += 1
            return _orig(*a, **kw)
        monkeypatch.setattr(cuda_reproj, name, counted)
    return n


def _camera(problem):
    return Camera(problem[0].float(), CameraKind.PINHOLE)


def _solve(problem, camera=None, n_iters=3, dtype=torch.float32, **kw):
    params, arrays, ur = problem
    p = params.to(dtype)
    args = [torch.as_tensor(a).to(dtype) if a.dtype.kind == "f"
            else torch.as_tensor(a) for a in arrays]
    return bundle_adjust(functools.partial(pinhole.project, p),
                         functools.partial(pinhole.project_jac, p), *args,
                         assembly=kw.pop("assembly", "pcg"), n_iters=n_iters,
                         obs_ur=torch.as_tensor(ur).to(dtype), bf=BF,
                         camera=camera, **kw)


def _schur_terms_inputs(monkeypatch, run):
    """The arguments of every ``local_ba._schur_terms`` call ``run`` makes:
    (Hpp, bp, Hll_inv, bl, E) of each LM step's linearization."""
    got = []
    orig = local_ba._schur_terms

    def record(Hpp, bp, shards, plans, psum_fn):
        Hi, bl, E = shards[0][:3]
        got.append((Hpp, bp, Hi, bl, E))
        return orig(Hpp, bp, shards, plans, psum_fn)
    monkeypatch.setattr(local_ba, "_schur_terms", record)
    run()
    return got


@pytest.mark.parametrize("body", [False, True], ids=["T_cw", "body"])
def test_twin_matches_the_einsum_linearization(monkeypatch, body):
    """The twin's Hpp, bp, Hll, bl and E (observation order and planes) at
    the solvers' starting point against the blocks the solver's einsum
    pass hands to its Schur terms in its first LM step, in float64: Hpp
    (damped as the visual solver damps it), bp, Hll_inv (damped, inverted,
    masked), bl and E.  Both are the same closed forms in another order,
    within 1e-12 of each block's scale.  Without the stereo rows the
    blocks move by far more."""
    problem = k5_problem(pad=100)
    dt = torch.float64
    lam = torch.tensor(1e-4, dtype=dt)
    if body:
        run = functools.partial(vi_solve64, problem)
    else:
        run = functools.partial(_solve, problem, None, 1, dt)
    Hpp, bp, Hll_inv, bl, E = _schur_terms_inputs(monkeypatch, run)[0]
    s, R, t, X = k5_state(problem, CPU, dt, body)
    twin = cuda_reproj.linearize(s, R, t, X)
    eye3, eye6 = torch.eye(3, dtype=dt), torch.eye(6, dtype=dt)
    H6 = twin[0] if body else twin[0] + lam * (eye6 + local_ba._diag(
        twin[0], 6))
    H3 = twin[2] + lam * (eye3 + local_ba._diag(twin[2], 3))
    mine = (H6, twin[1], inv_nan(H3) * s.lm_mask[:, None, None], twin[3],
            twin[4])
    for name, a, b in zip(("Hpp", "bp", "Hll_inv", "bl", "E"), mine,
                          (Hpp, bp, Hll_inv, bl, E)):
        scale = float(b.abs().max())
        assert scale > 0, name
        assert float((a - b).abs().max()) <= 1e-12 * scale, name
    L = int(s.index.lm_off[-1])
    assert torch.equal(twin[5][:, :L].t(),
                       twin[4].reshape(-1, 18)[s.index.lm_perm[:L]])
    mono = k5_state(k5_problem(pad=100, stereo=False), CPU, dt, body)
    Hpp_m = cuda_reproj.linearize(*mono)[0]
    assert float((Hpp_m - twin[0]).abs().max()) > 1e-3 * float(
        twin[0].abs().max())


def vi_solve64(problem):
    """One LM step of inertial_bundle_adjust(assembly="pcg") in float64 on
    the CPU (vi_solve's problem)."""
    params, _, ur = problem
    p = params.double()
    args = [a.double() if torch.is_tensor(a) and a.is_floating_point()
            else a for a in vi_chain(problem, CPU)]
    args[16] = args[16].map(lambda x: x.double())
    K = problem[1][0].shape[0]
    from orb_slam3_study_kr_tpu_torch.solvers.inertial_ba import (
        inertial_bundle_adjust)
    return inertial_bundle_adjust(
        functools.partial(pinhole.project, p),
        functools.partial(pinhole.project_jac, p), *args, n_iters=1,
        fixed_vb=torch.zeros(K, dtype=torch.float64), assembly="pcg",
        obs_ur=torch.as_tensor(ur).double(), bf=BF)


@pytest.mark.parametrize("huber", [True, False], ids=["huber", "l2"])
def test_twin_cost_and_chi2_match_the_solver(huber):
    """The twin's cost and chi2 against bundle_adjust's own at its
    starting point (no LM step): chi2 within float32 rounding of each
    observation's, the cost within 1e-5 of itself, padding included."""
    problem = k5_problem(pad=100)
    _, _, _, chi2, cost = _solve(problem, n_iters=0, use_huber=huber)
    s, R, t, X = k5_state(problem, CPU, huber=huber)
    c, x2 = cuda_reproj.cost(s, R, t, X, chi2=True)
    np.testing.assert_allclose(x2.numpy(), chi2.numpy(), rtol=2e-5,
                               atol=1e-4)
    assert abs(float(c) - float(cost)) <= 1e-5 * float(cost)


def test_twin_sums_follow_the_kernel_order():
    """The twin's pose and landmark sums are those of the kernel's threads
    and shuffle trees: on integer values (exact in any order) they equal
    index_add_, and each run's first observation is summed alone into its
    lane (a run of one lands unchanged)."""
    vals = torch.arange(1.0, 41.0).reshape(20, 2)
    off = torch.tensor([0, 1, 1, 12, 20])
    lanes = cuda_reproj._strided_sums(vals, off, 8)
    assert torch.equal(lanes[0, 0], vals[0]) and not lanes[1].any()
    assert torch.equal(lanes[2, 0], vals[1] + vals[9])
    seg = torch.repeat_interleave(torch.arange(4), torch.diff(off))
    ref = torch.zeros(4, 2).index_add_(0, seg, vals)
    assert torch.equal(cuda_reproj._halves(lanes, 1), ref)
    block = cuda_reproj._block_sum(
        cuda_reproj._strided_sums(vals, off, cuda_reproj.THREADS))
    assert torch.equal(block, ref)


def test_route():
    """K5 engages exactly for the PCG assembly on the card with a pinhole
    of zero distortion and the pinhole cheirality."""
    cuda = torch.device("cuda", 0)
    ideal = make_pinhole(458.0, 457.0, 367.0, 248.0, device="cpu")
    radtan = make_pinhole(458.0, 457.0, 367.0, 248.0, k1=-0.28,
                          device="cpu")
    fisheye = make_kb8(190.0, 190.0, 254.0, 256.0, 0.01, -0.01, 0.02,
                       -0.005, device="cpu")
    assert cuda_reproj.takes(ideal, cuda, "pcg")
    assert not cuda_reproj.takes(ideal, CPU, "pcg")
    assert not cuda_reproj.takes(ideal, cuda, "dense")
    assert not cuda_reproj.takes(ideal, cuda, "pcg", wide_fov=True)
    assert not cuda_reproj.takes(radtan, cuda, "pcg")
    assert not cuda_reproj.takes(fisheye, cuda, "pcg")
    assert not cuda_reproj.takes(None, cuda, "pcg")


def test_cpu_solves_are_unchanged_by_the_camera():
    """On the CPU the camera changes nothing: bundle_adjust gives the same
    bits with and without it."""
    problem = k5_problem(pad=100)
    a = _solve(problem)
    b = _solve(problem, _camera(problem))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_forced_route_solves_like_the_einsum_path(forced, passes):
    """bundle_adjust(assembly="pcg") through K5's route (the twin on the
    CPU) against the einsum path: one linearize pass an LM step and a cost
    pass at the start, after each step and at the end; R, t, X and the
    cost within the float32 rounding that reordering the sums leaves
    (about ten times what a reorder moved K4's solve, 3 LM steps)."""
    problem = k5_problem(pad=100)
    plain = _solve(problem)
    assert passes == {"linearize": 0, "cost": 0}
    k5 = _solve(problem, _camera(problem))
    assert passes == {"linearize": 3, "cost": 3 + 2}
    np.testing.assert_allclose(k5[0].numpy(), plain[0].numpy(), atol=3e-4)
    np.testing.assert_allclose(k5[1].numpy(), plain[1].numpy(), atol=3e-3)
    np.testing.assert_allclose(k5[2].numpy(), plain[2].numpy(), atol=1e-2)
    live = problem[1][-1] > 0
    np.testing.assert_allclose(k5[3].numpy()[live], plain[3].numpy()[live],
                               rtol=1e-3, atol=1e-3)
    assert abs(float(k5[4]) - float(plain[4])) <= 5e-6 * float(plain[4])


def test_forced_route_inertial_solves_like_the_einsum_path(forced, passes):
    """inertial_bundle_adjust(assembly="pcg") through K5's route (the body
    parametrisation, the twin on the CPU) against the einsum path, 3 LM
    steps; the passes as in the visual solve."""
    problem = k5_problem(pad=100)
    plain = vi_solve(problem, CPU, None)
    assert passes == {"linearize": 0, "cost": 0}
    k5 = vi_solve(problem, CPU, _camera(problem))
    assert passes == {"linearize": 3, "cost": 3 + 2}
    for i, atol in ((0, 3e-4), (1, 3e-3), (2, 3e-3), (3, 1e-3), (4, 1e-2)):
        np.testing.assert_allclose(k5[i].numpy(), plain[i].numpy(),
                                   atol=atol)
    assert abs(float(k5[6]) - float(plain[6])) <= 1e-5 * float(plain[6])


@pytest.mark.parametrize("case", ["dense", "kb8", "sharded"])
def test_other_solves_stay_on_the_einsum_path(forced, passes, case):
    """With the route forced on, the dense assembly, a KB8 camera and the
    landmark-sharded solve never reach K5."""
    problem = k5_problem(K=12, M=600, track=4)
    if case == "dense":
        _solve(problem, _camera(problem), n_iters=1, assembly="dense")
    elif case == "kb8":
        cam = make_kb8(190.0, 190.0, 254.0, 256.0, 0.01, -0.01, 0.02,
                       -0.005, device="cpu")
        p = cam.params
        params, arrays, ur = problem
        bundle_adjust(functools.partial(kb8.project, p),
                      functools.partial(kb8.project_jac, p),
                      *[torch.as_tensor(a) for a in arrays], n_iters=1,
                      assembly="pcg", obs_ur=torch.as_tensor(ur), bf=BF,
                      wide_fov=True, camera=cam)
    else:
        params, arrays, ur = problem
        R, t, fixed, X, lm_mask, op, ol, uv, level, mask = arrays
        parts = shard_ba_problem(2, X, lm_mask, op, ol, uv, level, mask,
                                 obs_ur=ur)
        mesh = make_ba_mesh(["cpu", "cpu"])
        sharded = [torch.as_tensor(mesh.local_rows(a)) for a in parts[:-4]]
        ur_sh = sharded.pop()
        distributed_bundle_adjust(
            mesh, functools.partial(pinhole.project, params),
            functools.partial(pinhole.project_jac, params),
            torch.as_tensor(R), torch.as_tensor(t), torch.as_tensor(fixed),
            *sharded, n_iters=1, assembly="pcg", obs_ur=ur_sh, bf=BF)
    assert passes == {"linearize": 0, "cost": 0}


@pytest.mark.parametrize("solver", ["visual", "inertial"])
def test_passes_are_counted_in_their_spans(forced, solver):
    """Under a profiler each K5 pass is counted in the span that holds it:
    a linearize pass in each LM step's linearize span, a cost at the
    start, in each update span and at the end."""
    problem = k5_problem(K=12, M=600, track=4)
    n0 = len(DEFAULT_TIMERS.spans)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        if solver == "visual":
            _solve(problem, _camera(problem), n_iters=2)
        else:
            vi_solve(problem, CPU, _camera(problem), n_iters=2)
    got = {}
    for sp in list(DEFAULT_TIMERS.spans)[n0:]:
        for k, v in sp.counts.items():
            if k.startswith("k5/"):
                got[k, sp.name] = got.get((k, sp.name), 0) + v
    p = "ba" if solver == "visual" else "viba"
    ends = ({("k5/cost", "ba/setup"): 1, ("k5/cost", "ba/final"): 1}
            if solver == "visual" else {("k5/cost", "viba/solve"): 2})
    assert got == {("k5/linearize", f"{p}/linearize"): 2,
                   ("k5/cost", f"{p}/update"): 2, **ends}
