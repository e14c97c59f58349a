"""Driver of the tracking cells (traffic ``kind: "session"``).

Set-up builds the session from the configuration's settings file through
the port's EuRoC driver (``examples/run_euroc.build_system``, which reads
it with ``io/settings.py``), renders the seed's frames on the card, and
warms up: the two-view (mono) or stereo initialization, the vocabulary's
training and the first keyframes' mapping.  The window then feeds frames
in a closed loop with one client (the next frame goes in when the last
returns, as a real-time front end takes them) until ``--seconds`` have
passed, and ends at that frame's boundary.

An operation is a window frame.  It fails when the tracker reports it
lost, or when its motion from the frame before it is off the seeded
path's by more than the cell's limit (``reference/poses.py``).  K1's and
K2's outputs on frames sampled from the seed are checked against their
plain references after the window (``reference/orb_dense.py``,
``reference/gated_nn.py``).
"""

import argparse
import math
import os
import sys
import time

import numpy as np

from portbench import harness, peaks
from portbench.reference import gated_nn as ref_k2
from portbench.reference import orb_dense, poses
from portbench.render import render_session
from portbench.taps import KernelTap
from portbench.trace import profiled, summarize


def build(ctx):
    """The SlamSystem of the cell's configuration on ctx["device"]."""
    from orb_slam3_study_kr_tpu_torch.examples.run_euroc import build_system
    from orb_slam3_study_kr_tpu_torch.io.settings import Settings
    path = os.path.join(harness.ROOT, ctx["config"]["file"])
    st = Settings(path)
    sensor = st.get("Port.sensor", required=True)
    slam = build_system(argparse.Namespace(
        device=ctx["device"], settings=path, sensor=sensor, vocabulary=None))
    slam.cfg.vocab_k = int(st.get("Vocabulary.k", required=True))
    slam.cfg.vocab_L = int(st.get("Vocabulary.L", required=True))
    return slam, sensor


def _pose(frame):
    if frame.R_cw is None or not frame.pose_ok:
        return None
    return (np.asarray(frame.R_cw, np.float64).reshape(3, 3),
            np.asarray(frame.t_cw, np.float64).reshape(3))


def _stage_counts(timers):
    return {k: len(v) for k, v in timers.samples.items()}


def _stage_sums(timers, counts):
    """{stage: (calls, seconds)} since ``counts``."""
    out = {}
    for k, v in timers.samples.items():
        new = v[counts.get(k, 0):]
        if new:
            out[k] = (len(new), float(sum(new)))
    return out


def _count_syncs(caught):
    return sum(1 for w in caught if "synchroniz" in str(w.message))


def run(ctx):
    slam, sensor = build(ctx)
    tap = KernelTap().install()
    try:
        return _run(ctx, slam, sensor.startswith("stereo"), tap)
    finally:
        tap.uninstall()


def _run(ctx, slam, stereo, tap):
    import torch
    args, traffic, device = ctx["args"], ctx["traffic"], ctx["device"]
    tc = slam.cfg.tracker
    fps = traffic["fps"]
    warm = traffic["warmup"]
    n_frames = warm["max_frames"] + int(math.ceil(args.seconds * fps)) + 1
    K = [[tc.fx, 0.0, tc.cx], [0.0, tc.fy, tc.cy], [0.0, 0.0, 1.0]]
    t_render = time.perf_counter()
    seq = render_session(traffic, K, tc.width, tc.height, n_frames, args.seed,
                         device, batch=traffic.get("render_batch", 32),
                         baseline=slam.cfg.baseline if stereo else None)
    ts = seq["timestamps"]
    if device == "cuda":
        torch.cuda.synchronize()
    t_warm = time.perf_counter()

    def track(i):
        if stereo:
            return slam.track_stereo(seq["left"][i], seq["right"][i],
                                     float(ts[i]))
        return slam.track_monocular(seq["left"][i], float(ts[i]))

    from orb_slam3_study_kr_tpu_torch.pipeline.tracking import TrackState
    est = []
    i = 0
    vocab_at = None
    while True:
        if i >= warm["max_frames"]:
            raise RuntimeError(f"warm-up: no steady tracking after {i} frames "
                               f"(state {slam.state}, vocabulary "
                               f"{slam.voc is not None})")
        f = track(i)
        est.append(_pose(f))
        i += 1
        if vocab_at is None and slam.voc is not None:
            vocab_at = i
        if (i >= warm["min_frames"] and vocab_at is not None
                and i - vocab_at >= warm["after_vocabulary"]
                and slam.state == TrackState.OK and est[-1] is not None):
            break
    w0 = i
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - ctx["t_start"]
    print(f"setup: {setup_s:.3f} s; render {n_frames} frames "
          f"{t_warm - t_render:.3f} s; warm-up {w0} frames "
          f"{time.perf_counter() - t_warm:.3f} s (vocabulary at frame "
          f"{vocab_at}, {slam.stats()['n_kf']} keyframes)", file=sys.stderr)

    # Sampled frames of the window (positions drawn from the seed).
    rng = np.random.default_rng([int(args.seed) % (2 ** 63), 15])
    sample = set(int(x) for x in rng.choice(
        traffic["sample"]["among_first"], traffic["sample"]["frames"],
        replace=False))
    timers = slam.tracker.timers
    counts0 = _stage_counts(timers)
    events = _Events(slam.tracker.stats)
    n_timings0 = len(slam.timings)
    trace_n = traffic["trace_frames"] if args.trace else 0
    lost, captured = [], []
    syncs = summary = None

    def step():
        j = len(lost)
        with tap.capturing(j in sample):
            k1_n, k2_n = len(tap.k1), len(tap.k2)
            f = track(w0 + j)
            if j in sample:
                captured.append((w0 + j, k1_n, len(tap.k1), k2_n,
                                 len(tap.k2)))
        est.append(_pose(f))
        lost.append(slam.state != TrackState.OK or est[-1] is None)
        events.append(slam.state.name, slam.tracker.stats)

    t0 = time.perf_counter()
    if trace_n:
        # The first frames of the window, under the profiler and the sync
        # counter.
        import warnings
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            tap.trace = True
            if device == "cuda":
                torch.cuda.set_sync_debug_mode("warn")
            try:
                with profiled(True, device) as prof:
                    for _ in range(trace_n):
                        step()
            finally:
                if device == "cuda":
                    torch.cuda.set_sync_debug_mode("default")
                tap.trace = False
        summary = summarize(prof)
        if device == "cuda":
            syncs = _count_syncs(caught) / trace_n
    t_end = t0 + args.seconds
    while w0 + len(lost) < n_frames and time.perf_counter() < t_end:
        step()
    window_s = time.perf_counter() - t0
    n_win = len(lost)
    stages = _stage_sums(timers, counts0)
    frame_s = list(slam.timings[n_timings0:])
    info = harness.device_info(1) if device == "cuda" else {}

    checks, errs = _check(ctx, tc, est, seq, w0, n_win, tap, captured)
    failed = outcome(lost, errs, ctx["limits"]["step_err"])
    for j, (gone, e) in enumerate(zip(lost, errs)):
        print(f"frame {w0 + j}: {'lost' if gone else 'tracked'}, step_err "
              f"{e!r}, {1e3 * frame_s[j]:.1f} ms, {events.lines[j]}",
              file=sys.stderr)
    print(f"window: {n_win} frames in {window_s:.3f} s, failed {failed}",
          file=sys.stderr)
    limits_ok = all(v[0] <= v[1] for v in checks.values())
    result = dict(correct=bool(limits_ok and failed == 0), attempted=n_win,
                  failed=failed)
    if args.trace:
        ctx.update(window=dict(frames=n_win, seconds=window_s,
                               frame_s=frame_s, stages=stages, syncs=syncs,
                               trace_frames=trace_n),
                   trace=summary, tap=tap, tracker=tc)
        result["metrics"] = harness.read_per_layer(ctx["bench"],
                                                   args.workload, ctx)
        if summary is not None:
            info.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
            result["breakdown"] = dict(device_ops=summary["device_ops"],
                                       idle_gaps=summary["idle_gaps"])
    else:
        result["metrics"] = {
            "frames_per_s": {"value": n_win / window_s, "unit": "frames/s"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    result["device"] = info
    return result, checks


class _Events:
    """Per window frame, the state the tracker left and the counters that
    moved (for the run's diagnostics on stderr)."""

    def __init__(self, stats):
        self.prev = dict(stats)
        self.lines = []

    def append(self, state, stats):
        now = {k: v for k, v in stats.items() if isinstance(v, (int, float))}
        moved = {k: v - self.prev.get(k, 0) for k, v in now.items()
                 if v != self.prev.get(k, 0) and k != "n_frames"}
        self.prev = now
        self.lines.append(f"{state} {moved}")


def outcome(lost, errs, limit):
    """Failed frames of a window: those the tracker reports lost and those
    whose step error is over the limit, each counted once.  Frames before
    the window (the warm-up, which no tracker can pose before its
    initialization) are not operations."""
    return sum(1 for gone, e in zip(lost, errs)
               if gone or (e is not None and e > limit))


def _check(ctx, tc, est, seq, w0, n_win, tap, captured):
    """{number: (value, limit)} of the window, and the step error of each
    window frame (None where it or the frame before it has no pose)."""
    import torch
    traffic, limits = ctx["traffic"], ctx["limits"]
    control = bool(ctx["args"].control)
    R_true, t_true = seq["R_cw"], seq["t_cw"]
    left, right = seq["left"], seq["right"]
    n = w0 + n_win
    answers = list(est[:n])
    if control:
        # The control breaks the configuration's guarantee of a pose per
        # frame from its own image: the tracker's state never advances, and
        # every window frame reports the last warm-up frame's pose.
        for i in range(w0, n):
            answers[i] = est[w0 - 1]
    k = traffic["check"]["step_frames"]
    scale = 1.0 if tc.bf > 0 else poses.fit_scale(est[:w0], R_true, t_true)
    errs = poses.step_errors(answers[w0 - k:n], R_true[w0 - k:n],
                             t_true[w0 - k:n], scale, k)
    good = [e for e in errs if e is not None]
    # A window without one posed step has nothing to compare: it fails.
    checks = {"step_err": (max(good) if good else 1e9, limits["step_err"])}

    # K1 and K2 on the sampled frames, computed in the configuration's
    # float32, or bfloat16 for the control.
    dt = torch.bfloat16 if control else torch.float32
    sizes = orb_dense.level_sizes(tc.height, tc.width, tc.orb_n_levels,
                                  tc.orb_scale_factor)
    pyr_err, k1_bad, blur_err, k2_bad = 0.0, 0, 0.0, 0
    for i, a, b, c, d in captured:
        imgs = [left[i]] + ([right[i]] if right is not None else [])
        for (levels, th_min, th_ini, maps), img in zip(tap.k1[a:b], imgs):
            pyr_err = max(pyr_err, orb_dense.compare_pyramid(
                img, levels, sizes,
                torch.bfloat16 if control else torch.float64))
            bad, err = orb_dense.compare_k1(levels, maps, th_min, th_ini, dt)
            k1_bad += bad
            blur_err = max(blur_err, err)
        for inputs, outputs, slack in tap.k2[c:d]:
            k2_bad += ref_k2.compare(inputs, outputs, slack, dt)
    checks.update(
        pyramid_err=(pyr_err, limits["pyramid_err"]),
        k1_map_mismatch=(float(k1_bad), limits["k1_map_mismatch"]),
        k1_blur_err=(blur_err, limits["k1_blur_err"]),
        k2_mismatch=(float(k2_bad), limits["k2_mismatch"]))
    # The sampled frames must have reached K1 and K2.
    checks["unsampled"] = (float(not captured or not tap.k2), 0.0)
    return checks, errs


def k1_roofline(ctx):
    """Share of K1's bound in its device time over the traced frames."""
    from portbench.trace import kernel_seconds
    s, tap = ctx.get("trace"), ctx.get("tap")
    if s is None or not tap.k1_traced:
        return None
    n, t = kernel_seconds(s, "fast_nms_blur")
    if n != len(tap.k1_traced) or t <= 0:
        return None
    return 100.0 * sum(peaks.k1_bound_s(sh) for sh in tap.k1_traced) / t


def k2_roofline(ctx):
    """Share of K2's bound (each launch's own shapes and passing pairs) in
    its device time over the traced frames."""
    from portbench.trace import kernel_seconds
    s, tap = ctx.get("trace"), ctx.get("tap")
    if s is None or not tap.k2_traced:
        return None
    n, t = kernel_seconds(s, "gated_nn")
    if n != len(tap.k2_traced) or t <= 0:
        return None
    bound = 0.0
    for gates, slack in tap.k2_traced:
        q_uv, q_level, q_valid, t_uv, t_radius, t_level, t_valid = gates
        B = q_uv.shape[0] if q_uv.dim() == 3 else 1
        passing = ref_k2.passing_pairs(q_uv, q_level, q_valid, t_uv, t_radius,
                                       t_level, t_valid, slack)
        bound += peaks.k2_bound_s(B, q_uv.shape[-2], t_uv.shape[-2], passing)
    return 100.0 * bound / t
