"""The traced slice of a run: torch.profiler over a callable, reduced to
what the per-layer readers and the result's `breakdown` need.

Busy time is the union of the device's activity intervals (kernels,
copies, sets), so work on overlapping streams counts once. An idle gap is
a stretch of the traced window with nothing running on the device; each
is named by the innermost host event under its middle, and the gaps are
summed by that name."""

import time

import numpy as np
import torch

WINDOW = 'port_bench.traced_window'
LABELLED_GAPS = 2000        # the longest gaps named one by one


class Trace:
    def __init__(self, window, device, host):
        """window (start, end) in the trace's microseconds; device and
        host lists of (name, start, end)."""
        self.window = window
        self.device = device
        self.host = host
        self.window_s = (window[1] - window[0]) * 1e-6
        self.intervals = _union([(s, e) for _, s, e in device], window)
        self.busy_s = sum(e - s for s, e in self.intervals) * 1e-6

    def kernel_s(self, *parts):
        """Seconds of the device events whose names contain any part."""
        return sum(e - s for n, s, e in self.device
                   if any(p in n for p in parts)) * 1e-6

    def count(self, part):
        return sum(part in n for n, _, _ in self.device)

    def top_ops(self, n=10):
        total = {}
        for name, s, e in self.device:
            total[name] = total.get(name, 0.0) + (e - s) * 1e-6
        return sorted(([k, v] for k, v in total.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n=10):
        gaps, at = [], self.window[0]
        for s, e in self.intervals:
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if self.window[1] > at:
            gaps.append((at, self.window[1]))
        gaps.sort(key=lambda g: g[0] - g[1])
        host = [h for h in self.host if h[0] != WINDOW]
        starts = np.array([s for _, s, _ in host], np.float64)
        ends = np.array([e for _, _, e in host], np.float64)
        names = [name for name, _, _ in host]
        total = {}
        for i, (a, b) in enumerate(gaps):
            label = 'other (shorter gaps)'
            if i < LABELLED_GAPS and len(host):
                label = _host_label(0.5 * (a + b), starts, ends, names)
            total[label] = total.get(label, 0.0) + (b - a) * 1e-6
        return sorted(([k, v] for k, v in total.items()),
                      key=lambda kv: -kv[1])[:n]

    def breakdown(self):
        return dict(device_ops=self.top_ops(), idle_gaps=self.idle_gaps())


def _host_label(t, starts, ends, names):
    """The innermost host event running at t; where none is, the one that
    ended last before t ('after <name>')."""
    under = np.nonzero((starts <= t) & (ends >= t))[0]
    if len(under):
        return names[under[np.argmin(ends[under] - starts[under])]]
    before = np.nonzero(ends < t)[0]
    if not len(before):
        return '(no host event)'
    return 'after ' + names[before[np.argmax(ends[before])]]


def _union(intervals, window):
    lo, hi = window
    out = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile(fn, device):
    """fn() under torch.profiler (CPU and CUDA activity), ending in a
    synchronize of `device`. Returns (fn's result, Trace, host seconds)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with torch.profiler.record_function(WINDOW):
            out = fn()
            if device.type == 'cuda':
                torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    dev, host, window = [], [], None
    for e in prof.events():
        rng = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append(rng)
        else:
            host.append(rng)
            if e.name == WINDOW:
                window = (rng[1], rng[2])
    if window is None:
        raise RuntimeError('the profiler recorded no window marker')
    # the device-side copies of the host's named ranges are no device work
    names = {h[0] for h in host}
    dev = [d for d in dev if d[0] not in names]
    return out, Trace(window, dev, host), wall
