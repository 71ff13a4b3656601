"""The traced window: torch.profiler over a few report intervals, and the
reading of its own timeline (device kernels and the host spans that were
open) into busy time, idle gaps and the time of each kernel.

Imported only by a run with --trace 1: the profiler's first use imports
torch._dynamo, which a --trace 0 run never pays for.
"""
from __future__ import annotations

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW_SPAN = "traced_window"
TOP = 10


def profiler():
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def span(name):
    """A host span that the profiler's timeline holds."""
    return record_function(name)


def short_name(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0].strip()


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def _union(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def read(prof, span_names) -> dict:
    """From a finished profile: the window (the WINDOW_SPAN's bounds, s),
    the device operations inside it [(name, start s, seconds)], the union
    of their intervals (busy_s), the idle gaps between them labelled by
    the innermost host span in `span_names` open at the gap's start, and
    the device time by operation name."""
    ops, spans, window = [], [], None
    for e in prof.events():
        start, end = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        # a host span also shows on the device's row as an annotation
        annotation = (getattr(e, "is_user_annotation", False)
                      or e.name == WINDOW_SPAN or e.name in span_names)
        if e.device_type == DeviceType.CUDA:
            if not annotation:
                ops.append((e.name, start, end))
        elif e.name == WINDOW_SPAN:
            window = (start, end)
        elif e.name in span_names:
            spans.append((e.name, start, end))
    if window is None:
        raise RuntimeError("the trace holds no %s span" % WINDOW_SPAN)
    w0, w1 = window
    inside = [(n, max(s, w0), min(e, w1)) for n, s, e in ops
              if e > w0 and s < w1]
    merged = _union([(s, e) for _, s, e in inside])
    busy = sum(e - s for s, e in merged)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = []
    for k in range(0, len(edges), 2):
        g0, g1 = edges[k], edges[k + 1]
        if g1 > g0:
            open_spans = [s for s in spans if s[1] <= g0 < s[2]]
            label = (min(open_spans, key=lambda s: s[2] - s[1])[0]
                     if open_spans else "no span")
            gaps.append((label, g1 - g0))
    by_name = {}
    for n, s, e in inside:
        t, c = by_name.get(short_name(n), (0.0, 0))
        by_name[short_name(n)] = (t + e - s, c + 1)
    return {"window_s": w1 - w0, "busy_s": busy, "ops": inside,
            "gaps": gaps, "by_name": by_name,
            "kernels": sum(c for n, (_, c) in by_name.items()
                           if is_kernel(n))}


def breakdown(reading) -> dict:
    """The `breakdown` of a result line: the device operations that took
    the most time and the longest idle gaps, at most TOP each."""
    ops = sorted(reading["by_name"].items(), key=lambda kv: -kv[1][0])
    gaps = sorted(reading["gaps"], key=lambda g: -g[1])
    return {"device_ops": [[n, t] for n, (t, _) in ops[:TOP]],
            "idle_gaps": [[n, t] for n, t in gaps[:TOP]]}


def gaps_by_span(reading) -> dict:
    out = {}
    for label, t in reading["gaps"]:
        out[label] = out.get(label, 0.0) + t
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def kernel_time(reading, names, count_name) -> tuple[float, int] | None:
    """(device seconds of the operations whose names hold any of `names`,
    launches: the count of those whose name holds `count_name`), or None
    when the window has none."""
    total, launches = 0.0, 0
    for name, (t, c) in reading["by_name"].items():
        if any(k in name for k in names):
            total += t
            if count_name in name:
                launches += c
    return (total, launches) if launches else None
