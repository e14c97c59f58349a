"""The full-inertial-BA cell (traffic ``kind: "vigba_map"``).

It imports the port's inertial global BA by name before it builds
anything, so a port without it fails within seconds.  Set-up builds the
seed's stereo-inertial map on the card (``vimap.py``), loads it into the
port's ``MapState`` (IMU-initialised, with velocities and biases) and
snapshots it, then warms up with one solve.  Each operation of the window
restores the drifted map from the snapshot and calls
``pipeline/global_ba.global_inertial_bundle_adjustment`` with the loop
closer's arguments (``LoopCloser._run_gba`` on an IMU-initialised inertial
map: ``gba_inertial_iters`` = 7, the map's lock, the IMU log's intervals).
The window ends at the first solve boundary after ``--seconds``; ``gba_s``
is its length over its solves.

Every solve starts from the same map, so every solve owes the same
answer: each is compared, once the window has closed, with the plain
reference (``reference/vi_lm_schur.py``) run once in float64 on the same
snapshot.  A solve fails when it returns False or when the comparison
rejects what it wrote back.
"""

import os
import sys
import time

import numpy as np

from portbench import harness, vimap
from portbench.kinds.gba_map import _project
from portbench.reference import lm_schur, vi_lm_schur
from portbench.trace import profiled, summarize

OUTPUTS = ("kf_R", "kf_t", "kf_v", "kf_bias", "lm_pos", "lm_valid",
           "kf_kp_lm")
NUMBERS = ("pose_gap_m", "reproj_gap_px", "cull_mismatch", "vel_gap_mps",
           "bias_gap")


def _outputs(m):
    return {k: getattr(m, k).copy() for k in OUTPUTS}


def _holds(m, out):
    """Whether the map holds the answer ``out``, read in place."""
    return all(np.array_equal(getattr(m, k), out[k]) for k in OUTPUTS)


def run(ctx):
    from orb_slam3_study_kr_tpu_torch.pipeline.global_ba import (  # noqa: F401
        global_inertial_bundle_adjustment)
    import torch
    from orb_slam3_study_kr_tpu_torch.io.settings import Settings
    from orb_slam3_study_kr_tpu_torch.pipeline import global_ba
    from orb_slam3_study_kr_tpu_torch.slam_map.map_state import MapState
    args, traffic, device = ctx["args"], ctx["traffic"], ctx["device"]
    st = Settings(os.path.join(harness.ROOT, ctx["config"]["file"]))
    tc = st.tracker_config(device=device)
    imu = st.imu_params()
    if tc.bf <= 0 or imu is None:
        raise harness.CellError("the inertial global-BA cell needs a "
                                "stereo-inertial configuration (Camera.bf "
                                "and the IMU block)")
    max_kp = tc.orb_config.total_slots
    intr = (tc.fx, tc.fy, tc.cx, tc.cy, tc.width, tc.height)
    t_build = time.perf_counter()
    data = vimap.build(traffic, intr, tc.bf, max_kp, args.seed, device, imu)
    t_load = time.perf_counter()
    m = vimap.to_map_state(MapState, data, max_kp)
    snap = vimap.snapshot(m)
    log = vimap.ImuLog(data["imu_stamps"], data["imu_rows"])
    source = global_ba.ImuIntervals(st.imu_calib(device=device),
                                    log.rows_between)
    t_warm = time.perf_counter()
    n_iters = traffic["gba"]["n_iters"]

    def solve():
        vimap.restore(m, snap)
        return global_ba.global_inertial_bundle_adjustment(
            tc, m, source, n_iters=n_iters, use_lock=True)

    for _ in range(traffic["gba"]["warmup_solves"]):
        solve()
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - ctx["t_start"]
    print(f"setup: {setup_s:.3f} s; map K={data['K']} M={data['M']} "
          f"O={data['O']} E={data['K'] - 1} built in "
          f"{t_load - t_build:.3f} s, loaded in {t_warm - t_load:.3f} s; "
          f"warm-up {time.perf_counter() - t_warm:.3f} s", file=sys.stderr)

    results = []      # distinct outputs, with the solves that gave them
    returned_false = 0
    spans, walls = [], []
    trace_n = traffic["trace_solves"] if args.trace else 0
    summary = None
    orig_ba = global_ba.inertial_bundle_adjust

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
        for r in results:
            if _holds(m, r[0]):
                r[1] += 1
                return
        results.append([_outputs(m), 1])

    n = 0
    t0 = time.perf_counter()
    t_end = t0 + args.seconds
    if trace_n:
        global_ba.inertial_bundle_adjust = timed_ba
        try:
            with profiled(True, device) as prof:
                for _ in range(trace_n):
                    tw = time.perf_counter()
                    ok = solve()
                    walls.append(time.perf_counter() - tw)
                    record(ok)
                    n += 1
        finally:
            global_ba.inertial_bundle_adjust = orig_ba
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
        ctx.update(trace=summary, gba=dict(
            spans=spans, walls=walls, n_iters=n_iters, trace_solves=trace_n,
            K=data["K"], M=data["M"], O=data["O"]))
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
    """The snapshot as the reference's tensors: every keyframe's body state
    (the oldest's pose fixed), every landmark, the observations in the
    keyframes' slot order, the chain's IMU rows."""
    import torch
    K = data["K"]
    k, s = np.nonzero(data["kf_kp_lm"] >= 0)
    t = lambda a: torch.as_tensor(np.asarray(a), device=device)  # noqa: E731
    R_cb = data["R_bc"].T
    t_cb = -R_cb @ data["t_bc"]
    Rwb, pwb = vi_lm_schur.camera_to_body(
        data["kf_R"].astype(np.float64), data["kf_t"].astype(np.float64),
        data["R_bc"], data["t_bc"])
    fixed = np.zeros(K)
    fixed[np.argsort(data["kf_timestamp"], kind="stable")[0]] = 1.0
    f = data["freq"]
    sig = (data["noise_gyro"] * f ** 0.5, data["noise_acc"] * f ** 0.5,
           data["walk_gyro"] / f ** 0.5, data["walk_acc"] / f ** 0.5)
    p = dict(Rwb=t(Rwb), pwb=t(pwb), v=t(data["kf_v"]), b=t(data["kf_bias"]),
             fixed=t(fixed), fixed_vb=t(np.zeros(K)), X=t(data["lm_pos"]),
             op=t(k), ol=t(data["kf_kp_lm"][k, s]),
             uv=t(data["kf_kp_uv"][k, s]), level=t(data["kf_kp_level"][k, s]),
             ur=t(data["kf_kp_ur"][k, s]), R_cb=t(R_cb), t_cb=t(t_cb),
             ei=t(np.arange(K - 1)), ej=t(np.arange(1, K)),
             rows=t(data["imu_rows"]))
    return p, sig, (k, s), fixed


def _check(ctx, data, tc, results):
    """{number: (value, limit)} of the worst solve, and the solves the
    comparison rejects."""
    import torch
    limits, device = ctx["limits"], ctx["device"]
    n_iters = ctx["traffic"]["gba"]["n_iters"]
    p, sig, (k, s), fixed = problem(data, device)
    intr = (tc.fx, tc.fy, tc.cx, tc.cy)
    R_cb = data["R_bc"].T
    t_cb = -R_cb @ data["t_bc"]

    def ref(dtype):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return vi_lm_schur.solve(
            p["Rwb"], p["pwb"], p["v"], p["b"], p["fixed"], p["fixed_vb"],
            p["X"], p["op"], p["ol"], p["uv"], p["level"], p["ur"], p["R_cb"],
            p["t_cb"], intr, tc.bf, p["ei"], p["ej"], p["rows"], sig,
            n_iters=n_iters, dtype=dtype)

    Rb, pb, vr, br, Xr, chi2 = ref(torch.float64)
    R, t = vi_lm_schur.body_to_camera(Rb, pb, R_cb, t_cb)
    ur = data["kf_kp_ur"][k, s]
    ol = data["kf_kp_lm"][k, s]
    bad, gone = lm_schur.culled(chi2, ur, ol, data["M"])
    if ctx["args"].control:
        # The control: the reference in the program's place, computed in
        # bfloat16 (its inverses in float32).
        Rc, pc, vc, bc, Xc, chi2c = ref(torch.bfloat16)
        Rcc, tcc = vi_lm_schur.body_to_camera(Rc, pc, R_cb, t_cb)
        badc, gonec = lm_schur.culled(chi2c, ur, ol, data["M"])
        answers = [(dict(kf_R=Rcc, kf_t=tcc, kf_v=vc, kf_bias=bc, lm_pos=Xc,
                         lm_valid=~gonec, unbound=badc), 1)]
    else:
        answers = [(dict(out, unbound=out["kf_kp_lm"][k, s] < 0), count)
                   for out, count in results]
    free = fixed == 0
    c_ref = lm_schur.centres(R, t)
    uv_ref = _project(R, t, Xr, k, ol, intr)
    walk = np.array([data["walk_gyro"]] * 3 + [data["walk_acc"]] * 3)
    lim = tuple(limits[n] for n in NUMBERS)
    worst = [0.0] * len(NUMBERS)
    rejected = 0
    for a, count in answers:
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
        vel = float(np.max(np.linalg.norm(
            a["kf_v"].astype(np.float64) - vr, axis=1)))
        bias = float(np.max(np.abs(a["kf_bias"].astype(np.float64) - br)
                            / walk))
        vals = (pose, reproj, cull, vel, bias)
        print(f"answer of {count} solves: pose gap {pose!r} m, reprojection "
              f"gap {reproj!r} px, cull mismatch {cull!r}, velocity gap "
              f"{vel!r} m/s, bias gap {bias!r}", file=sys.stderr)
        worst = [max(w, v) for w, v in zip(worst, vals)]
        if any(v > li for v, li in zip(vals, lim)):
            rejected += count
    checks = {n: (w, li) for n, w, li in zip(NUMBERS, worst, lim)}
    return checks, rejected
