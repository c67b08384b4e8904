"""Reduction of the traced window's profiler events to what the per-layer
readers take: the union of device intervals (busy time; overlapping kernels
on two streams count once), device time by kernel name, the attention
kernels' device time, and the longest idle gaps labelled by the benchmark
span the host was in when the gap began.

The profiler stamps events in Unix nanoseconds; the host's `perf_counter` is
tied to that clock once, at the window's start.
"""

from __future__ import annotations

import re

from torch.autograd import DeviceType

_OWN = re.compile(r"lmdx::.*?(\w+_kernel)")


def _events(prof):
    """(name, is_device, start_ns, end_ns) of every event."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
        dur = e.duration_ns() if hasattr(e, "duration_ns") else e.duration_us() * 1000
        out.append((e.name(), e.device_type() == DeviceType.CUDA, start, start + dur))
    return out


def kernel_name(name: str) -> str:
    """The port's kernels by their own name, others cut to 120 characters."""
    own = _OWN.search(name)
    return own.group(1) if own else name[:120]


def union(intervals):
    """Merged, sorted, non-overlapping (start, end) intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def reduce(prof, t_start: float, t_end: float, spans, epoch_ns: int) -> dict:
    """The traced window [t_start, t_end] (host perf_counter seconds);
    `epoch_ns` is the Unix time in ns minus perf_counter in ns, the
    profiler's clock."""
    events = _events(prof)
    offset = epoch_ns
    w0 = int(t_start * 1e9) + offset
    w1 = int(t_end * 1e9) + offset
    dev = [(n, max(s, w0), min(e, w1)) for n, d, s, e in events if d and e > w0 and s < w1]
    merged = union([(s, e) for _, s, e in dev if e > s])
    busy_ns = sum(e - s for s, e in merged)
    by_kernel: dict[str, float] = {}
    for n, s, e in dev:
        k = kernel_name(n)
        by_kernel[k] = by_kernel.get(k, 0.0) + (e - s) / 1e9
    attn_fwd = sum(e - s for n, s, e in dev if "lmdx::" in n and "bwd" not in n) / 1e9
    attn_bwd = sum(e - s for n, s, e in dev if "lmdx::" in n and "bwd" in n) / 1e9

    host = sorted(((name, int(a * 1e9) + offset, int(b * 1e9) + offset) for name, a, b in spans),
                  key=lambda x: x[1])
    gaps = []
    prev = w0
    for s, e in merged + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)

    def label(at):
        inside = [(b - a, name) for name, a, b in host if a <= at < b]
        return min(inside)[1] if inside else "host"

    gaps.sort(key=lambda g: g[0] - g[1])
    top_gaps = [[label(a), (b - a) / 1e9] for a, b in gaps[:10]]
    return {
        "busy_s": busy_ns / 1e9,
        "window_s": (w1 - w0) / 1e9,
        "by_kernel": by_kernel,
        "attn_fwd_s": attn_fwd,
        "attn_bwd_s": attn_bwd,
        "breakdown": {
            "device_ops": sorted(([k, v] for k, v in by_kernel.items()),
                                 key=lambda kv: -kv[1])[:10],
            "idle_gaps": top_gaps,
        },
    }
