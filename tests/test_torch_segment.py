"""The fixed-order segment sum (``ops/segment.py``) against ``index_add_``
and the reference's ``jnp.zeros(...).at[idx].add(vals)``.

On the card every scatter-add of the BA, pose-graph, inertial-BA,
sharded-BA and BoW paths goes through ``SegmentPlan.sum``; on the CPU the
sites keep ``index_add_`` / ``index_put_``.  These tests call the plan on
CPU tensors directly, and run the solvers with the card's route forced
on CPU tensors.  Tolerance of a float32 sum: within 1e-6 of the segment's
sum of absolute values (a relative bound that holds under cancellation);
sums of integer-valued floats are exact in every order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_inertial_cuda as tinertial_cuda
import test_torch_parallel as tparallel
import test_torch_solvers as tsolvers
from orb_slam3_study_kr_tpu_torch.bow import vocabulary
from orb_slam3_study_kr_tpu_torch.ops import segment
from orb_slam3_study_kr_tpu_torch.ops.segment import (SegmentPlan, put_add_,
                                                      put_plan, segment_sum)
from orb_slam3_study_kr_tpu_torch.parallel import dist_ba
from orb_slam3_study_kr_tpu_torch.solvers import pose_graph as tpg

torch.set_num_threads(2)

REL = 1e-6
# (K, M, O) of a BA's observation graph, with empty segments.
K, M, O = 8, 256, 4096


def _graph(seed, k=K, m=M, o=O):
    """Observation indices over k poses and m landmarks, every 8th
    landmark and the last pose unobserved (empty segments)."""
    rng = np.random.default_rng(seed)
    op = rng.integers(0, k - 1, o)
    ol = rng.integers(0, m // 8, o) * 8 + rng.integers(1, 8, o)
    return op, np.minimum(ol, m - 1)


def _close(got, idx, vals, n):
    """got within REL of the exact (float64) segment sums, scaled by each
    segment's sum of absolute values."""
    v = np.asarray(vals, np.float64)
    exact = np.zeros((n, *v.shape[1:]))
    scale = np.zeros_like(exact)
    np.add.at(exact, idx, v)
    np.add.at(scale, idx, np.abs(v))
    err = np.abs(np.asarray(got, np.float64) - exact)
    assert (err <= REL * scale).all(), float((err - REL * scale).max())


@pytest.mark.parametrize("which,inner", [
    ("pose", (6, 6)), ("pose", (6,)), ("landmark", (3, 3)),
    ("landmark", (3,)), ("cell", (6, 3)), ("bow", ())])
def test_fixed_order_matches_index_add_and_reference(which, inner):
    """The blocks of one LM iteration, the dense cross block's cells and a
    BoW vector: the plan's sum, index_add_ and .at[].add agree within REL;
    empty segments are exact zeros."""
    op, ol = _graph(0)
    n, idx = {"pose": (K, op), "landmark": (M, ol), "cell": (K * M, op * M + ol),
              "bow": (4096, ol * 16 + op)}[which]
    vals = np.random.default_rng(1).normal(0, 1, (O, *inner)).astype(np.float32)
    ti, tv = torch.as_tensor(idx), torch.as_tensor(vals)
    fixed = SegmentPlan(n, ti).sum(tv)
    added = torch.zeros((n, *inner)).index_add_(0, ti, tv)
    ref = np.asarray(jnp.zeros((n, *inner), jnp.float32).at[idx].add(vals))
    assert fixed.shape == (n, *inner) and fixed.dtype == torch.float32
    for got in (fixed.numpy(), added.numpy(), ref):
        _close(got, idx, vals, n)
    empty = np.bincount(idx, minlength=n) == 0
    assert empty.any() and (fixed.numpy()[empty] == 0).all()


@pytest.mark.parametrize("n,o", [(8, 4096), (256, 4096), (1, 1), (5, 0),
                                 (100, 3), (0, 0)])
def test_integer_valued_sums_are_exact(n, o):
    """Integer-valued float32 (sums below 2^24): every order gives the same
    bits, so the plan equals index_add_ and .at[].add exactly; shapes at
    the edges (no entries, one entry, no segments)."""
    rng = np.random.default_rng(n + o)
    idx = rng.integers(0, max(n, 1), o)
    vals = rng.integers(-100, 100, (o, 6, 3)).astype(np.float32)
    ti, tv = torch.as_tensor(idx), torch.as_tensor(vals)
    fixed = SegmentPlan(n, ti).sum(tv)
    assert torch.equal(fixed, torch.zeros((n, 6, 3)).index_add_(0, ti, tv))
    if n:
        np.testing.assert_array_equal(
            fixed.numpy(), np.asarray(jnp.zeros((n, 6, 3)).at[idx].add(vals)))


def test_plan_reused_across_calls_gives_the_same_bits():
    """A plan built once per solve and reused (the LM iterations) against
    one built afresh for every call, and segment_sum with the route forced:
    identical bits."""
    op, _ = _graph(2)
    ti = torch.as_tensor(op)
    plan = SegmentPlan(K, ti)
    rng = np.random.default_rng(3)
    for _ in range(3):
        tv = torch.as_tensor(rng.normal(0, 1, (O, 6, 6)).astype(np.float32))
        a = plan.sum(tv)
        b = SegmentPlan(K, ti).sum(tv)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(segment, "_fixed_order", lambda t: True)
            c = segment_sum(K, ti, tv, plan)
            assert segment.segment_plan(K, ti) is not None
        assert torch.equal(a.view(torch.int32), c.view(torch.int32))
    with pytest.raises(ValueError):
        plan.sum(tv[:-1])


def test_put_add_flattens_the_index_pairs():
    """put_add_ (index_put_ with accumulate) with broadcast (row, col)
    pairs into a dense matrix and (pose, landmark) pairs into the cross
    block: the forced fixed route against the CPU's index_put_."""
    rng = np.random.default_rng(4)
    cols = torch.as_tensor(rng.integers(0, 90, (20, 24)))
    vals = torch.as_tensor(rng.normal(0, 1, (20, 24, 24)).astype(np.float32))
    pairs = torch.broadcast_tensors(cols[:, :, None], cols[:, None, :])
    pairs = tuple(p.reshape(-1) for p in pairs)
    H0 = torch.as_tensor(rng.normal(0, 1, (90, 90)).astype(np.float32))
    op, ol = (torch.as_tensor(a) for a in _graph(5, 4, 64, 300))
    E = torch.as_tensor(rng.normal(0, 1, (300, 6, 3)).astype(np.float32))
    cpu = (put_add_(H0.clone(), pairs, vals.reshape(-1)),
           put_add_(torch.zeros(4, 64, 6, 3), (op, ol), E))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(segment, "_fixed_order", lambda t: True)
        fixed = (put_add_(H0.clone(), pairs, vals.reshape(-1),
                          put_plan((90, 90), pairs)),
                 put_add_(torch.zeros(4, 64, 6, 3), (op, ol), E))
    for a, b in zip(fixed, cpu):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)


def test_chunk_mask_of_the_dense_chunked_assembly():
    """The sharded BA's cross block, 2048 landmarks at a time (ROADMAP §3
    item 14): an observation outside the chunk adds a zero block at a
    clamped cell.  Per chunk the plan's sum equals index_add_'s within REL
    and the reference's scatter of the chunk's own observations
    (.at[op, ol - c0].add over the observations inside), exactly on
    integer values."""
    k, mb = 4, 2100
    op, ol = _graph(6, k, mb, 6000)
    ti_op, ti_ol = torch.as_tensor(op), torch.as_tensor(ol)
    rng = np.random.default_rng(7)
    for E in (rng.normal(0, 1, (6000, 6, 3)).astype(np.float32),
              rng.integers(-50, 50, (6000, 6, 3)).astype(np.float32)):
        tE = torch.as_tensor(E)
        chunks = dist_ba._chunks(k, ti_op, ti_ol, mb, dist_ba.CHUNK)
        assert [c for _, c, *_ in chunks] == [2048, 52]
        for c0, c, cell, inside, _ in chunks:
            masked = tE * inside[:, None, None].to(tE.dtype)
            fixed = SegmentPlan(k * c, cell).sum(masked).reshape(k, c, 6, 3)
            added = torch.zeros(k * c, 6, 3).index_add_(0, cell, masked)
            ins = inside.numpy()
            ref = np.asarray(jnp.zeros((k, c, 6, 3)).at[
                op[ins], ol[ins] - c0].add(E[ins]))
            _close(fixed.reshape(k * c, 6, 3).numpy(), cell.numpy(),
                   masked.numpy(), k * c)
            _close(added.numpy(), cell.numpy(), masked.numpy(), k * c)
            if (E == np.round(E)).all():
                np.testing.assert_array_equal(fixed.numpy(), ref)
            else:
                np.testing.assert_allclose(fixed.numpy(), ref, rtol=0,
                                           atol=1e-4)


def _forced(monkeypatch):
    monkeypatch.setattr(segment, "_fixed_order", lambda t: True)


@pytest.mark.parametrize("seed", [0, 1])
def test_bundle_adjust_fixed_route_matches_reference(monkeypatch, seed):
    """test_torch_solvers' dense BA parity case with the card's route on
    CPU tensors, its bounds unchanged."""
    _forced(monkeypatch)
    tsolvers.test_bundle_adjust_matches_reference(seed)


def _both_routes(monkeypatch, fn):
    """fn() with the CPU's route, then with the card's on CPU tensors."""
    cpu = fn()
    _forced(monkeypatch)
    return cpu, fn()


def _ring_graph(k, drift):
    """A ring of k Sim3 vertices (truth on a circle, estimates drifted in
    rotation, translation and scale), sequential edges measured from the
    estimates, one loop edge from the truth, a zero-weight padding edge
    and a repeated edge."""
    rng = np.random.default_rng(0)
    a = 2 * np.pi * np.arange(k) / k
    R = np.stack([tparallel._rot_y(x) for x in a])
    t = np.stack([np.sin(a), np.zeros(k), 4 - np.cos(a)], 1).astype(np.float32)
    s = np.ones(k, np.float32)
    noise = np.cumsum(rng.normal(0, 0.01, (k, 3)), 0).astype(np.float32)
    R0 = np.stack([r @ tparallel._rot_y(float(n)) for r, n in
                   zip(R, noise[:, 1])]).astype(np.float32)
    t0, s0 = t + noise, (1 + drift * np.arange(k)).astype(np.float32)
    ei = list(range(1, k)) + [k - 1, 0, 3]
    ej = list(range(0, k - 1)) + [0, 0, 1]
    T = tsolvers._T
    Rm, tm, sm = tpg.relative_sim3(*(T(x) for x in (
        R0[ei], t0[ei], s0[ei], R0[ej], t0[ej], s0[ej])))
    loop = tpg.relative_sim3(*(T(x) for x in (R[k - 1], t[k - 1], s[k - 1],
                                               R[0], t[0], s[0])))
    for m, l in zip((Rm, tm, sm), loop):
        m[k - 1] = l
    w = torch.ones(len(ei))
    w[-2] = 0.0
    fixed = torch.zeros(k)
    fixed[0] = 1.0
    return (T(R0), T(t0), T(s0), torch.as_tensor(ei), torch.as_tensor(ej),
            Rm, tm, sm, w, fixed)


@pytest.mark.parametrize("dof", [7, 4])
def test_pose_graph_fixed_route_matches_index_add(monkeypatch, dof):
    """A drifted ring's essential graph (loop edge, padding edge, repeated
    edge), 3 iterations, with the card's route against the CPU's:
    (R, t, s) within 1e-4, test_torch_loop_solvers' bound against the
    reference."""
    args = _ring_graph(12 if dof == 7 else 10, 0.02 if dof == 7 else 0.0)
    cpu, card = _both_routes(monkeypatch, lambda: tpg.optimize_pose_graph(
        *args, n_iters=3, dof=dof))
    for a, b in zip(card, cpu):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4)


@pytest.mark.parametrize("mode", ["shared_bias", "fixed_anchor_window"])
def test_inertial_ba_fixed_route_matches_index_add(monkeypatch, mode):
    """FullInertialBA's init mode (priors, shared bias) and LocalInertialBA's
    window (random-walk edges, a free anchor velocity and bias, the stereo
    row on half the observations), test_torch_inertial_cuda's problems,
    with the card's route against the CPU's, within its BA_TOL."""
    c = tinertial_cuda._ba_problem(3 if mode == "shared_bias" else 5,
                                   bias_est=tinertial_cuda.B_TRUE)
    k = c["K"]
    if mode == "shared_bias":
        fixed = np.zeros(k, np.float32)
        fixed[0] = 1.0
        start = tinertial_cuda._perturb(c)
        bias0 = np.zeros((k, 6), np.float32)
        kw = dict(n_iters=6, shared_bias=True, bias_src=k - 1,
                  prior_gyro=1e2, prior_acc=1e10)
    else:
        fixed = np.ones(k, np.float32)
        fixed[-5:] = 0.0
        fixed_vb = fixed.copy()
        fixed_vb[k - 6] = 0.0
        start = tinertial_cuda._perturb(c, keep_first=k - 5, lm=0.01)
        bias0 = np.tile(tinertial_cuda.B_TRUE, (k, 1))
        ur = (c["obs_uv"][:, 0] - 458.0 * 0.11 / 6.0).astype(np.float32)
        ur[::2] = -1.0
        kw = dict(n_iters=6, shared_bias=False, fixed_vb=fixed_vb, obs_ur=ur,
                  bf=458.0 * 0.11)
    cpu, card = _both_routes(monkeypatch, lambda: tinertial_cuda._ba(
        "cpu", c, start, bias0, fixed, **kw))
    tol = tinertial_cuda.BA_TOL
    for name, a, b in zip(("R", "p", "v", "bias", "X"), card, cpu):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=tol[name],
                                   err_msg=name)
    np.testing.assert_allclose(card[5].numpy(), cpu[5].numpy(),
                               rtol=tol["chi2"], atol=tol["chi2"])
    assert abs(float(card[6]) / float(cpu[6]) - 1) < tol["cost"]


@pytest.mark.parametrize("name", ["pcg", "chunked"])
def test_sharded_ba_fixed_route_matches_index_add(monkeypatch, name):
    """The sharded BA (pcg; dense_chunked, two chunks per shard) on 2 CPU
    shards with the card's route against the CPU's: poses within 1e-4,
    test_eight_shards_match_one_shard's bound for a change of summation
    order."""
    p = tparallel._problems()[name]
    cpu = tparallel._solve(name, p, 2)
    _forced(monkeypatch)
    fixed = tparallel._solve(name, p, 2)
    np.testing.assert_allclose(fixed["R"], cpu["R"], atol=1e-4)
    np.testing.assert_allclose(fixed["t"], cpu["t"], atol=1e-4)


def test_bow_vector_fixed_route(monkeypatch):
    """The tf-idf vector of 1000 descriptors' words: the card's route
    within REL of index_add_ before the L1 normalization and of the
    reference's .at[].add."""
    rng = np.random.default_rng(8)
    words = rng.integers(0, 500, 1000)
    w = rng.random(1000).astype(np.float32)
    tw, ww = torch.as_tensor(words), torch.as_tensor(w)
    cpu = vocabulary._dense(500, tw, ww)
    _forced(monkeypatch)
    fixed = vocabulary._dense(500, tw, ww)
    ref = jnp.zeros(500, jnp.float32).at[words].add(w)
    ref = np.asarray(ref / jnp.maximum(jnp.sum(jnp.abs(ref)), 1e-9))
    for got in (fixed.numpy(), ref):
        np.testing.assert_allclose(got, cpu.numpy(), rtol=0, atol=REL)
