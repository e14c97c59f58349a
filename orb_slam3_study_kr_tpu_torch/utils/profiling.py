"""Per-stage wall-clock instrumentation, and spans on the device trace's
clock while a profiler runs.

Keeps the reference's REGISTER_TIMES stage taxonomy (Tracking.h:179-193,
LocalMapping.h:114-131, LoopClosing.h:87-115) so numbers stay comparable:
tracking stages (extract / pose-pred / local-map-track / new-KF), mapping
stages (triangulate / fuse / cull / local-BA), loop stages (detect / sim3 /
pose-graph).  `report()` prints mean/median/max per stage like the
reference's PrintTimeStats.

A stage keeps one host sample in ``samples`` (unless the instance was
made with ``keep_samples=False``).  While a ``torch.profiler`` is active a
stage is also a span: a range named after the stage in the profiler's
trace, a record in the instance's span log (``spans``, the newest
``SPAN_LOG_MAX``: id, parent, request, host start and end), a pair of
CUDA events when the card is in use, and the counts that ``count``
attaches to it.  Device times are read only in ``resolve``, so the traced
path gains no sync.  ``DEFAULT_TIMERS`` is the instance of free functions
such as the global BA and ``bundle_adjust``; it keeps no samples, so
untraced it records nothing.  `device_ms_per_launch` times one kernel
launch on the card alone.
"""

import itertools
import threading
import time
from collections import defaultdict, deque
from contextlib import contextmanager

import numpy as np
import torch

SPAN_LOG_MAX = 1 << 16         # spans an instance's log keeps, newest last
_ids = itertools.count(1)
_local = threading.local()      # .open: this thread's stack of open spans


def _profiling():
    return torch.autograd.profiler._is_profiler_enabled


def _open_spans():
    stack = getattr(_local, "open", None)
    if stack is None:
        stack = _local.open = []
    return stack


class Span:
    """One traced stage.  ``parent`` is the id of the span open around it
    on its thread (None at the top); ``request`` the id of the request
    span it runs under (its own for a request or a top-level span).
    ``t0``/``t1`` are host ``perf_counter`` seconds (``t1`` None while
    open); ``device_ms`` is the time between its CUDA events, None off
    the card or until ``StageTimers.resolve``."""

    __slots__ = ("name", "id", "parent", "request", "owner", "t0", "t1",
                 "counts", "events", "range", "device_ms")

    def __init__(self, name, sid, parent, request, owner):
        self.name, self.id, self.parent = name, sid, parent
        self.request, self.owner = request, owner
        self.t0 = self.t1 = self.events = self.range = self.device_ms = None
        self.counts = {}

    @property
    def host_ms(self):
        return 1e3 * (self.t1 - self.t0)


class StageTimers:
    def __init__(self, keep_samples=True):
        self.keep_samples = keep_samples
        self.samples = defaultdict(list)
        # The span log: filled only while profiling, the oldest dropped.
        self.spans = deque(maxlen=SPAN_LOG_MAX)

    @contextmanager
    def stage(self, name, request=False):
        """Time the block into ``samples[name]``; while a profiler is
        active, also trace it as a span (``request``: the span starts a
        request, which its descendants share)."""
        span = self._open(name, request) if _profiling() else None
        if span is None and not self.keep_samples:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            if self.keep_samples:
                self.samples[name].append(t1 - t0)
            if span is not None:
                self._close(span, t0, t1)

    def _open(self, name, request):
        stack = _open_spans()
        up = stack[-1] if stack else None
        sid = next(_ids)
        span = Span(name, sid, None if up is None else up.id,
                    sid if request or up is None else up.request, self)
        # A function-scope range: it names the span on the host's timeline
        # (and the device's idle gaps beneath it) without the device-side
        # annotation that a user-scope `record_function` adds, which a
        # trace reader would count as device time.
        span.range = torch._C._profiler._RecordFunctionFast(name)
        span.range.__enter__()
        if torch.cuda.is_initialized():
            span.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            span.events[0].record()
        stack.append(span)
        self.spans.append(span)
        return span

    def _close(self, span, t0, t1):
        if span.events is not None:
            span.events[1].record()
        span.range.__exit__(None, None, None)
        span.range = None
        span.t0, span.t1 = t0, t1
        _open_spans().remove(span)

    def _innermost(self):
        if _profiling():
            for span in reversed(_open_spans()):
                if span.owner is self:
                    return span
        return None

    def count(self, name, n=1):
        """Add n to the count ``name`` of this instance's innermost open
        span (only while a profiler is active)."""
        span = self._innermost()
        if span is not None:
            span.counts[name] = span.counts.get(name, 0) + n

    def resolve(self):
        """The closed spans of the log, with their device times read (this
        waits for the card to reach their events)."""
        closed = [s for s in list(self.spans) if s.t1 is not None]
        for span in closed:
            if span.events is not None:
                span.events[1].synchronize()
                span.device_ms = span.events[0].elapsed_time(span.events[1])
                span.events = None
        return closed

    def totals(self, request):
        """Sums over the closed spans of every request whose request span
        is named ``request``: dict(requests=number of such requests,
        host_ms={span name: ms}, device_ms={span name: ms, for names whose
        every span has a device time}, counts={count name: total})."""
        spans = self.resolve()
        roots = {s.id for s in spans
                 if s.name == request and s.id == s.request}
        host = defaultdict(float)
        dev = defaultdict(float)
        counts = defaultdict(float)
        no_device = set()
        for s in spans:
            if s.request not in roots:
                continue
            host[s.name] += s.host_ms
            if s.device_ms is None:
                no_device.add(s.name)
            else:
                dev[s.name] += s.device_ms
            for k, v in s.counts.items():
                counts[k] += v
        return dict(requests=len(roots), host_ms=dict(host),
                    device_ms={k: v for k, v in dev.items()
                               if k not in no_device},
                    counts=dict(counts))

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


DEFAULT_TIMERS = StageTimers(keep_samples=False)


def device_ms_per_launch(launch, n=100, warmup=10):
    """A kernel's own time per launch: CUDA events around n back-to-back
    calls of ``launch`` (a bare launcher on inputs prepared once).  A
    device-side sleep holds the stream while the host queues them, so the
    window starts once all n are queued and measures the device alone; if
    the host was not done before the sleep ended, the sleep doubles and the
    measurement repeats."""
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
