"""Reduction of a torch.profiler trace of the measured window: the device's
busy time, its idle gaps labelled by the harness span the host was in, and
device time by kernel.  The method is that of
``scripts/profile_torch_main_path.py``: the profiler's events on the CUDA
device (kernels, copies, memsets) carry the device's own time.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

WINDOW = "portbench.window"
K1_KERNEL = "spmv_gather_kernel"
TOP = 10


def _merge(intervals: list) -> list:
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_events(events, spans: tuple) -> dict:
    """Reduce profiler events (each with ``name``, ``device_type`` and
    ``time_range`` in microseconds) to the window's busy and idle time.
    ``spans`` are the names of the harness's host spans (record_function)
    that label the idle gaps: a gap takes the shortest span around its
    middle, or "other"."""
    from torch.autograd import DeviceType

    win = [e for e in events if e.name == WINDOW and e.device_type != DeviceType.CUDA]
    if not win:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    labels = set(spans) | {WINDOW}
    dev, host = [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.name in labels and e.device_type == DeviceType.CUDA:
            continue  # the profiler mirrors host spans onto the device's timeline
        if e.device_type == DeviceType.CUDA:
            if t > w0 and s < w1:
                dev.append((max(s, w0), min(t, w1), e.name))
        elif e.name in spans:
            host.append((s, t, e.name))
    busy = _merge([(s, t) for s, t, _ in dev])
    busy_us = sum(t - s for s, t in busy)
    gaps, prev = [], w0
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if w1 > prev:
        gaps.append((prev, w1))
    mids = [(s + t) / 2 for s, t in gaps]
    label = ["other"] * len(gaps)
    for s, t, name in sorted(host, key=lambda h: h[0] - h[1]):  # longest first
        for g in range(bisect.bisect_left(mids, s), bisect.bisect_right(mids, t)):
            label[g] = name
    idle = defaultdict(float)
    for (s, t), name in zip(gaps, label):
        idle[name] += (t - s) * 1e-6
    ops = defaultdict(float)
    k1_s, k1_n = 0.0, 0
    for s, t, name in dev:
        ops[name[:120]] += (t - s) * 1e-6
        if K1_KERNEL in name:
            k1_s += (t - s) * 1e-6
            k1_n += 1
    return {
        "busy_s": busy_us * 1e-6,
        "window_s": (w1 - w0) * 1e-6,
        "device_ops": sorted(([k, v] for k, v in ops.items()), key=lambda r: -r[1])[:TOP],
        "idle_gaps": sorted(([k, v] for k, v in idle.items()), key=lambda r: -r[1])[:TOP],
        "k1_s": k1_s,
        "k1_launches": k1_n,
    }
