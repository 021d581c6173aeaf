"""Reading the profiler's trace of the measured window: when the device
was busy, with what, and what the host was doing while it was idle."""

from __future__ import annotations

from collections import defaultdict
from typing import NamedTuple

WINDOW = "gpubench.window"   # the benchmark's span around the window
MIN_GAP_NS = 10_000          # idle gaps shorter than this are not named


class Trace(NamedTuple):
    window_s: float
    busy_s: float
    kernels: dict            # device op name -> seconds
    idle_gaps: dict          # innermost host op over a gap -> seconds


def _times(e):
    if hasattr(e, "start_ns"):
        return e.start_ns(), e.start_ns() + e.duration_ns()
    return e.start_us() * 1000, (e.start_us() + e.duration_us()) * 1000


def read(prof) -> Trace:
    """The window's device busy time (the union of every device op's
    interval, kernels, copies and sets), the device time of each op
    name, and the idle gaps of at least ``MIN_GAP_NS`` named by the
    innermost host op that spans their middle."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    dev, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        t0, t1 = _times(e)
        if e.device_type() == cuda:
            if e.is_user_annotation() or e.name().startswith("gpubench."):
                continue            # a host span's shadow on the device
            dev.append((t0, t1, e.name()))
        else:
            if e.name() == WINDOW:
                window = (t0, t1)
            host.append((t0, t1, e.name()))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    return summarize(dev, host, window)


def summarize(dev, host, window) -> Trace:
    """``dev``, ``host``: (start ns, end ns, name) of the device ops and
    the host ops; ``window``: (start ns, end ns) of the window."""
    w0, w1 = window
    kernels = defaultdict(float)
    spans = []
    for t0, t1, name in dev:
        t0, t1 = max(t0, w0), min(t1, w1)
        if t1 > t0:
            kernels[name] += (t1 - t0) / 1e9
            spans.append((t0, t1))
    spans.sort()
    merged = []
    for t0, t1 in spans:
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    busy = sum(t1 - t0 for t0, t1 in merged)
    host = sorted((h for h in host if h[2] != WINDOW),
                  key=lambda h: (h[0], -h[1]))   # parents first
    gaps = defaultdict(float)
    edges = [w0] + [t for m in merged for t in m] + [w1]
    stack, i = [], 0            # the host ops open at the sweep's time
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 - g0 < MIN_GAP_NS:
            continue
        mid = (g0 + g1) / 2
        while i < len(host) and host[i][0] <= mid:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        gaps[stack[-1][2] if stack else "no host op"] += (g1 - g0) / 1e9
    return Trace((w1 - w0) / 1e9, busy / 1e9, dict(kernels), dict(gaps))


def top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
