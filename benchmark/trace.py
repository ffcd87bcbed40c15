"""A profiled stretch of a cell's work: ``torch.profiler`` over the CPU
and the device, exported as a Chrome trace into a temporary directory
(under ``TMPDIR``), read back into plain lists and deleted.

``Trace`` holds the device's operations (kernels, copies and fills), the
host's CUDA API calls and its profiled ops, the number of steps (train
steps or eval batches) the stretch ran and its length on the host's
clock. The per-layer metric readers take what they need from it.
"""
import bisect
import json
import os
import tempfile
import time

import torch

__all__ = ['profile', 'Trace', 'union_us']

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_API_CATS = ('cuda_runtime', 'cuda_driver')


def union_us(intervals):
    """Total length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


class Trace:
    def __init__(self, events, steps, wall_s):
        self.steps, self.wall_s = steps, wall_s
        self.device = [(e['name'], float(e['ts']), float(e['dur']))
                       for e in events
                       if e.get('ph') == 'X' and e.get('cat') in DEVICE_CATS]
        self.api = [(e['name'], float(e['ts']), float(e.get('dur', 0.0)))
                    for e in events
                    if e.get('ph') == 'X' and e.get('cat') in HOST_API_CATS]
        self.host = [(e['name'], float(e['ts']), float(e.get('dur', 0.0)))
                     for e in events
                     if e.get('ph') == 'X' and e.get('cat') in
                     ('cpu_op', 'python_function', 'user_annotation')]

    def busy_s(self):
        """Seconds in which some operation ran on the device."""
        return union_us([(ts, ts + d) for _, ts, d in self.device]) / 1e6

    def device_us(self, pattern):
        """Summed device microseconds of the operations whose lower-case
        name ``pattern`` (a compiled regex) matches."""
        return sum(d for name, _, d in self.device
                   if pattern.search(name.lower()))

    def device_names(self, pattern):
        return [name for name, _, _ in self.device
                if pattern.search(name.lower())]

    def api_calls(self, names):
        """Host CUDA API calls whose name starts with one of ``names``."""
        return sum(1 for name, _, _ in self.api if name.startswith(names))

    def breakdown(self, top=10):
        """The device operations that took the most time, and the longest
        idle gaps of the device by the innermost host event running at
        each gap's middle (seconds, summed by name)."""
        ops = {}
        for name, _, d in self.device:
            ops[name] = ops.get(name, 0.0) + d / 1e6
        spans = sorted((ts, ts + d) for _, ts, d in self.device)
        gaps, end = [], None
        for s, e in spans:
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        host = sorted(self.host + self.api, key=lambda h: h[1])
        starts = [h[1] for h in host]
        idle = {}
        for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:200]:
            mid = 0.5 * (s + e)
            name = 'host idle'
            # the latest-starting host event that still runs at mid
            i = bisect.bisect_right(starts, mid) - 1
            for h in host[max(0, i - 5000):i + 1][::-1]:
                if h[1] + h[2] >= mid:
                    name = h[0]
                    break
            idle[name] = idle.get(name, 0.0) + (e - s) / 1e6
        order = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
        return {'device_ops': [[k, v] for k, v in order],
                'idle_gaps': [[k, v] for k, v in sorted(
                    idle.items(), key=lambda kv: -kv[1])[:top]]}


def profile(fn, steps, device):
    """Run ``fn()`` (``steps`` train steps or eval batches) under the
    profiler; returns its ``Trace``."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    cuda = torch.device(device).type == 'cuda'
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize(device)
    with tempfile.TemporaryDirectory(prefix='bench_trace_') as tmp:
        path = os.path.join(tmp, 'trace.json')
        with torch_profile(activities=activities) as prof:
            t0 = time.perf_counter()
            fn()
            if cuda:
                torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)['traceEvents']
    return Trace(events, steps, wall)
