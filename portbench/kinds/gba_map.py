"""Driver of the global-BA cell (traffic ``kind: "gba_map"``).

Set-up builds the seed's map on the card (``gbamap.py``), loads it into
the port's ``MapState`` and snapshots it, then warms up with one solve.
Each operation of the window restores the drifted map from the snapshot
and calls ``pipeline/global_ba.global_bundle_adjustment`` with the loop
closer's arguments (``LoopCloser._run_gba``: its ``gba_iters``, no mesh
on one card, the map's lock).  The window ends at the first solve
boundary after ``--seconds``; ``gba_s`` is its length over its solves.

Every solve starts from the same map, so every solve owes the same
answer: each is compared, once the window has closed, with the plain
reference (``reference/lm_schur.py``) run once in float64 on the same
snapshot.  A solve fails when it returns False or when the comparison
rejects what it wrote back.
"""

import os
import sys
import time

import numpy as np

from portbench import gbamap, harness
from portbench.reference import lm_schur
from portbench.trace import profiled, summarize

OUTPUTS = ("kf_R", "kf_t", "lm_pos", "lm_valid", "kf_kp_lm")


def _outputs(m):
    return {k: getattr(m, k).copy() for k in OUTPUTS}


def _same(a, b):
    return all(np.array_equal(a[k], b[k]) for k in OUTPUTS)


def run(ctx):
    import torch
    from orb_slam3_study_kr_tpu_torch.io.settings import Settings
    from orb_slam3_study_kr_tpu_torch.pipeline import global_ba
    from orb_slam3_study_kr_tpu_torch.slam_map.map_state import MapState
    args, traffic, device = ctx["args"], ctx["traffic"], ctx["device"]
    st = Settings(os.path.join(harness.ROOT, ctx["config"]["file"]))
    tc = st.tracker_config(device=device)
    if tc.bf <= 0:
        raise harness.CellError("the global-BA cell needs a stereo "
                                "configuration (Camera.bf)")
    max_kp = tc.orb_config.total_slots
    intr = (tc.fx, tc.fy, tc.cx, tc.cy, tc.width, tc.height)
    t_build = time.perf_counter()
    data = gbamap.build(traffic, intr, tc.bf, max_kp, args.seed, device)
    t_load = time.perf_counter()
    m = gbamap.to_map_state(MapState, data, max_kp)
    snap = gbamap.snapshot(m)
    t_warm = time.perf_counter()
    n_iters = traffic["gba"]["n_iters"]

    def solve():
        gbamap.restore(m, snap)
        return global_ba.global_bundle_adjustment(tc, m, n_iters=n_iters,
                                                  mesh=None, use_lock=True)

    for _ in range(traffic["gba"]["warmup_solves"]):
        solve()
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - ctx["t_start"]
    print(f"setup: {setup_s:.3f} s; map K={data['K']} M={data['M']} "
          f"O={data['O']} built in {t_load - t_build:.3f} s, loaded in "
          f"{t_warm - t_load:.3f} s; warm-up "
          f"{time.perf_counter() - t_warm:.3f} s", file=sys.stderr)

    results = []      # distinct outputs, with the solves that gave them
    returned_false = 0
    spans, walls = [], []
    trace_n = traffic["trace_solves"] if args.trace else 0
    summary = None
    orig_ba = global_ba.bundle_adjust

    def timed_ba(*a, **kw):
        t = time.perf_counter()
        out = orig_ba(*a, **kw)
        if device == "cuda":
            torch.cuda.synchronize()
        spans.append(time.perf_counter() - t)
        return out

    def record(ok):
        nonlocal returned_false
        returned_false += int(not ok)
        out = _outputs(m)
        for r in results:
            if _same(r[0], out):
                r[1] += 1
                return
        results.append([out, 1])

    n = 0
    t0 = time.perf_counter()
    t_end = t0 + args.seconds
    if trace_n:
        global_ba.bundle_adjust = timed_ba
        try:
            with profiled(True, device) as prof:
                for _ in range(trace_n):
                    tw = time.perf_counter()
                    ok = solve()
                    walls.append(time.perf_counter() - tw)
                    record(ok)
                    n += 1
        finally:
            global_ba.bundle_adjust = orig_ba
        summary = summarize(prof)
    while n == 0 or time.perf_counter() < t_end:
        record(solve())
        n += 1
    window_s = time.perf_counter() - t0
    info = harness.device_info(1) if device == "cuda" else {}
    del m

    print(f"window: {n} solves in {window_s:.3f} s, {len(results)} distinct "
          f"answers ({[r[1] for r in results]} solves), returned False "
          f"{returned_false}", file=sys.stderr)
    checks, rejected = _check(ctx, data, tc, results)
    failed = min(n, rejected + returned_false)
    limits_ok = all(v[0] <= v[1] for v in checks.values())
    result = dict(correct=bool(limits_ok and failed == 0), attempted=n,
                  failed=failed)
    if args.trace:
        ctx.update(trace=summary, gba=dict(spans=spans, walls=walls,
                                           n_iters=n_iters,
                                           trace_solves=trace_n))
        result["metrics"] = harness.read_per_layer(ctx["bench"],
                                                   args.workload, ctx)
        if summary is not None:
            info.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
            result["breakdown"] = dict(device_ops=summary["device_ops"],
                                       idle_gaps=summary["idle_gaps"])
    else:
        result["metrics"] = {"gba_s": {"value": window_s / n, "unit": "s"},
                             "setup_s": {"value": setup_s, "unit": "s"}}
    result["device"] = info
    return result, checks


def problem(data, device):
    """The snapshot as the reference's tensors: every keyframe and
    landmark, the observations in the keyframes' slot order."""
    import torch
    k, s = np.nonzero(data["kf_kp_lm"] >= 0)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    fixed = np.zeros(data["K"])
    fixed[np.argsort(data["kf_timestamp"], kind="stable")[:2]] = 1.0
    return dict(
        R=t(data["kf_R"]), t=t(data["kf_t"]), fixed=t(fixed),
        X=t(data["lm_pos"]), op=t(k), ol=t(data["kf_kp_lm"][k, s]),
        uv=t(data["kf_kp_uv"][k, s]), level=t(data["kf_kp_level"][k, s]),
        ur=t(data["kf_kp_ur"][k, s])), (k, s)


def _check(ctx, data, tc, results):
    """{number: (value, limit)} of the worst solve, and the solves the
    comparison rejects."""
    import torch
    limits, device = ctx["limits"], ctx["device"]
    n_iters = ctx["traffic"]["gba"]["n_iters"]
    p, (k, s) = problem(data, device)
    intr = (tc.fx, tc.fy, tc.cx, tc.cy)
    args = (p["R"], p["t"], p["fixed"], p["X"], p["op"], p["ol"], p["uv"],
            p["level"], p["ur"], intr, tc.bf)
    R, t, X, chi2 = lm_schur.solve(*args, n_iters=n_iters)
    ur = data["kf_kp_ur"][k, s]
    ol = data["kf_kp_lm"][k, s]
    bad, gone = lm_schur.culled(chi2, ur, ol, data["M"])
    if ctx["args"].control:
        # The control: the reference in the program's place, computed in
        # bfloat16.  (TF32, the step below the configuration's float32,
        # changes nothing here: cuBLAS runs these batched 3x3 and 6x6
        # products on its float32 SIMT kernels whatever the switch says.)
        Rc, tc_, Xc, chi2c = lm_schur.solve(*args, n_iters=n_iters,
                                            dtype=torch.bfloat16)
        badc, gonec = lm_schur.culled(chi2c, ur, ol, data["M"])
        answers = [dict(kf_R=Rc, kf_t=tc_, lm_pos=Xc, lm_valid=~gonec,
                        unbound=badc)]
    else:
        answers = []
        for out, _ in results:
            answers.append(dict(out, unbound=out["kf_kp_lm"][k, s] < 0))
    free = p["fixed"].cpu().numpy() == 0
    c_ref = lm_schur.centres(R, t)
    uv_ref = _project(R, t, X, k, ol, intr)
    lim = (limits["pose_gap_m"], limits["reproj_gap_px"],
           limits["cull_mismatch"])
    worst = [0.0, 0.0, 0.0]
    rejected = 0
    for a, (_, count) in zip(answers, results if not ctx["args"].control
                             else [(None, 1)]):
        Ra = a["kf_R"].astype(np.float64)
        ta = a["kf_t"].astype(np.float64)
        Xa = a["lm_pos"].astype(np.float64)
        pose = float(np.max(np.linalg.norm(lm_schur.centres(Ra, ta) - c_ref,
                                           axis=1)[free]))
        live = a["lm_valid"] & ~gone
        seen = live[ol]
        gap = np.linalg.norm(_project(Ra, ta, Xa, k, ol, intr) - uv_ref,
                             axis=1)
        reproj = float(np.max(gap[seen])) if seen.any() else 1e9
        cull = float(np.sum(a["unbound"] != bad)
                     + np.sum(a["lm_valid"] != ~gone))
        vals = (pose, reproj, cull)
        print(f"answer of {count} solves: pose gap {pose!r} m, reprojection "
              f"gap {reproj!r} px, cull mismatch {cull!r}", file=sys.stderr)
        worst = [max(w, v) for w, v in zip(worst, vals)]
        if any(v > li for v, li in zip(vals, lim)):
            rejected += count
    checks = dict(pose_gap_m=(worst[0], lim[0]),
                  reproj_gap_px=(worst[1], lim[1]),
                  cull_mismatch=(worst[2], lim[2]))
    return checks, rejected



def _project(R, t, X, k, ol, intr):
    """Pixels (O, 2) of every observation's landmark in its keyframe."""
    fx, fy, cx, cy = intr
    p = np.einsum("oij,oj->oi", R[k], X[ol]) + t[k]
    z = np.maximum(p[:, 2], 1e-6)
    return np.stack([fx * p[:, 0] / z + cx, fy * p[:, 1] / z + cy], -1)
