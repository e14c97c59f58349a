"""Per-stage wall-clock instrumentation.

Keeps the reference's REGISTER_TIMES stage taxonomy (Tracking.h:179-193,
LocalMapping.h:114-131, LoopClosing.h:87-115) so numbers stay comparable:
tracking stages (extract / pose-pred / local-map-track / new-KF), mapping
stages (triangulate / fuse / cull / local-BA), loop stages (detect / sim3 /
pose-graph).  `report()` prints mean/median/max per stage like the
reference's PrintTimeStats; use `torch.profiler` traces for device-side
detail.  `device_ms_per_launch` times one kernel launch on the card alone.
"""

import time
from collections import defaultdict
from contextlib import contextmanager

import numpy as np


class StageTimers:
    def __init__(self):
        self.samples = defaultdict(list)

    @contextmanager
    def stage(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[name].append(time.perf_counter() - t0)

    def add(self, name, seconds):
        self.samples[name].append(seconds)

    def summary(self):
        out = {}
        for name, xs in self.samples.items():
            a = np.asarray(xs) * 1e3
            out[name] = dict(
                n=len(xs), mean_ms=float(a.mean()),
                median_ms=float(np.median(a)), max_ms=float(a.max()),
            )
        return out

    def report(self):
        lines = ["stage                     n    mean      median    max"]
        for name, s in sorted(self.summary().items()):
            lines.append(
                f"{name:24s} {s['n']:4d} {s['mean_ms']:9.2f} "
                f"{s['median_ms']:9.2f} {s['max_ms']:9.2f}  (ms)"
            )
        return "\n".join(lines)


def device_ms_per_launch(launch, n=100, warmup=10):
    """A kernel's own time per launch: CUDA events around n back-to-back
    calls of ``launch`` (a bare launcher on inputs prepared once).  A
    device-side sleep holds the stream while the host queues them, so the
    window starts once all n are queued and measures the device alone; if
    the host was not done before the sleep ended, the sleep doubles and the
    measurement repeats."""
    import torch
    for _ in range(warmup):
        launch()
    torch.cuda.synchronize()
    cycles = 20_000_000
    for _ in range(6):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(n):
            launch()
        b.record()
        queued_in_time = not a.query()
        b.synchronize()
        if queued_in_time:
            return a.elapsed_time(b) / n
        cycles *= 2
    raise RuntimeError("the host could not queue the timed launches ahead of "
                       "the device")
