"""The device trace of a traced window, reduced to what the per-layer
readers and the result line need: device busy time, the window's length,
kernel time and launch counts by name, the device operations that took
most time and the longest idle gaps by what the host was doing.

The trace is ``torch.profiler`` (CUPTI) over CPU and CUDA activity; its
raw events are read once, without building the profiler's event tree.
"""

import contextlib
from collections import defaultdict


@contextlib.contextmanager
def profiled(on, device):
    """Yields the profiler (or None when ``on`` is false or off the card);
    read it with ``summarize`` after the block."""
    if not on or device != "cuda":
        yield None
        return
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    torch.cuda.synchronize()


def _times(ev):
    try:
        s = ev.start_ns()
        return s * 1e-9, (s + ev.duration_ns()) * 1e-9
    except AttributeError:
        s = ev.start_us()
        return s * 1e-6, (s + ev.duration_us()) * 1e-6


def _is_device(ev):
    import torch
    return ev.device_type() == torch.autograd.DeviceType.CUDA


def _union(iv):
    """Total length of the union of (start, end) intervals, and the gaps
    between them as (start, end)."""
    iv = sorted(iv)
    total, gaps = 0.0, []
    cs, ce = iv[0]
    for s, e in iv[1:]:
        if s > ce:
            total += ce - cs
            gaps.append((ce, s))
            cs, ce = s, e
        else:
            ce = max(ce, e)
    total += ce - cs
    return total, gaps


def _gap_owners(cpu, gaps):
    """Seconds of device idle by the innermost host operation open at each
    gap's middle ("host: no profiled op" where none is)."""
    ev = sorted(cpu, key=lambda x: (x[0], -x[1]))
    mids = sorted(((s + e) / 2, e - s) for s, e in gaps)
    owners = defaultdict(float)
    stack, j = [], 0
    for m, length in mids:
        while j < len(ev) and ev[j][0] <= m:
            while stack and stack[-1][1] < ev[j][0]:
                stack.pop()
            stack.append(ev[j])
            j += 1
        while stack and stack[-1][1] < m:
            stack.pop()
        owners[stack[-1][2] if stack else "host: no profiled op"] += length
    return owners


def summarize(prof):
    """dict(busy_s, window_s, launches, kernels {name: [n, seconds]},
    device_ops, idle_gaps), or None when the trace holds no device time."""
    if prof is None:
        return None
    dev, cpu = [], []
    kernels = defaultdict(lambda: [0, 0.0])
    for ev in prof.profiler.kineto_results.events():
        s, e = _times(ev)
        if _is_device(ev):
            dev.append((s, e))
            name = ev.name()
            k = kernels[name]
            k[0] += 1
            k[1] += e - s
        else:
            cpu.append((s, e, ev.name()))
    if not dev:
        return None
    busy, gaps = _union(dev)
    starts = [x[0] for x in dev] + [x[0] for x in cpu]
    ends = [x[1] for x in dev] + [x[1] for x in cpu]
    window = max(ends) - min(starts)
    launches = sum(n for name, (n, _) in kernels.items()
                   if not name.startswith(("Memcpy", "Memset")))
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    owners = _gap_owners(cpu, gaps)
    idle = sorted(owners.items(), key=lambda kv: -kv[1])[:10]
    return dict(busy_s=busy, window_s=window, launches=launches,
                kernels={k: list(v) for k, v in kernels.items()},
                device_ops=[[name[:80], float(v[1])] for name, v in top],
                idle_gaps=[[name[:80], float(t)] for name, t in idle])


def kernel_seconds(summary, key):
    """(launches, device seconds) of the kernels whose name holds ``key``."""
    n, t = 0, 0.0
    for name, (c, s) in summary["kernels"].items():
        if key in name:
            n += c
            t += s
    return n, t

