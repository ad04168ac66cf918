"""Reading the traced window's ``torch.profiler`` timeline.

The device was busy wherever any of its activities ran: kernels, copies
and memsets, the port's and PyTorch's alike, merged as a union of
intervals inside the window's own span. Idle gaps are attributed to the
innermost host event on the harness's thread (a PyTorch op, a CUDA runtime
call, or a harness span around a call into the program) at the gap's
middle.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict
from dataclasses import dataclass, field

WINDOW = "stembench.window"
TOP = 10


@dataclass
class Summary:
    window_s: float
    busy_s: float
    kernels: dict = field(default_factory=dict)   # name -> (count, seconds)
    gaps: dict = field(default_factory=dict)      # host activity -> seconds


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def summarize(events) -> Summary:
    """Kineto events (``prof.profiler.kineto_results.events()``) ->
    the window's busy time, device activity by name and idle gaps."""
    from torch.autograd import DeviceType

    cuda = DeviceType.CUDA
    win = [e for e in events if e.name() == WINDOW]
    if len(win) != 1:
        raise RuntimeError(f"the trace holds {len(win)} '{WINDOW}' spans")
    w0, w1 = win[0].start_ns(), win[0].end_ns()
    thread = win[0].start_thread_id()
    dev, host = [], []
    for e in events:
        if e.device_type() == cuda:
            a, b = e.start_ns(), e.end_ns()
            if b > w0 and a < w1 and not e.is_user_annotation():
                dev.append((max(a, w0), min(b, w1), e.name()))
        elif e.start_thread_id() == thread:
            host.append((e.start_ns(), e.end_ns(), e.name()))
    kernels: dict = defaultdict(lambda: [0, 0.0])
    for a, b, name in dev:
        k = kernels[name]
        k[0] += 1
        k[1] += (b - a) * 1e-9
    busy = _union([(a, b) for a, b, _ in dev])
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    return Summary(window_s=(w1 - w0) * 1e-9,
                   busy_s=sum(b - a for a, b in busy) * 1e-9,
                   kernels={k: tuple(v) for k, v in kernels.items()},
                   gaps=_attribute(gaps, [h for h in host if h[2] != WINDOW]))


def _attribute(gaps, host) -> dict:
    """Idle seconds by the innermost host event at each gap's middle
    (events on one thread nest)."""
    host.sort(key=lambda e: (e[0], -e[1]))
    out: dict = defaultdict(float)
    stack: list[int] = []
    i = 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        m = (a + b) // 2
        while i < len(host) and host[i][0] <= m:
            while stack and host[stack[-1]][1] <= host[i][0]:
                stack.pop()
            stack.append(i)
            i += 1
        while stack and host[stack[-1]][1] <= m:
            stack.pop()
        out[host[stack[-1]][2] if stack else "harness"] += (b - a) * 1e-9
    return dict(out)


def breakdown(s: Summary) -> dict:
    top = lambda d: [[k, v] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"device_ops": top({k: v[1] for k, v in s.kernels.items()}),
            "idle_gaps": top(s.gaps)}


@contextlib.contextmanager
def profiled(device):
    """``torch.profiler`` over the block, host and device activity; yields
    a holder whose ``summary`` is filled at exit."""
    holder = type("Trace", (), {"summary": None})()
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    import sys
    import time

    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            yield holder
        if device.type == "cuda":
            import torch
            torch.cuda.synchronize(device)
        t = time.perf_counter()
    t1 = time.perf_counter()
    events = prof.profiler.kineto_results.events()
    t2 = time.perf_counter()
    holder.summary = summarize(events)
    print(f"trace: {len(events)} events; profiler stop {t1 - t:.3f} s,"
          f" events {t2 - t1:.3f} s, summary {time.perf_counter() - t2:.3f} s",
          file=sys.stderr)


def kernels_matching(s: Summary, pattern: str) -> tuple[int, float]:
    """(launches, seconds) of the device activities whose name matches the
    regular expression ``pattern``."""
    import re

    rx = re.compile(pattern)
    hits = [v for k, v in s.kernels.items() if rx.search(k)]
    return sum(c for c, _ in hits), sum(t for _, t in hits)
