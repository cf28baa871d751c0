"""The profiled sub-window of a ``--trace 1`` run: torch.profiler's
CUPTI trace of a few entry calls, each inside a ``record_function`` span
of the benchmark's own ("frame" or "tick"), reduced to what the
per-layer readers and the result's ``device`` and ``breakdown`` need.

- device busy seconds: the union of device activity (kernels, copies,
  sets) inside the window, which runs from the first span's start to the
  last span's end;
- entry-graph launches: the device activity of each ``cudaGraphLaunch``
  into the entry's stream (the frame step's or the tick's CUDA graph
  replay), counted and timed per launch;
- the block-matching kernels' time and calls;
- the device operations that took most time, and the longest idle gaps,
  each named by its span and the innermost host operation on the spans'
  thread at the gap's middle.
"""

from __future__ import annotations

from collections import defaultdict

import torch

BM_KERNELS = ("bm_cost_kernel", "bm_lr_kernel")
MARK = "entry stream mark"
NAME_CHARS = 120  # device operation names are cut to this length
TOP = 10


def profile_calls(call, n: int, span: str, sync, device):
    """Run `call` n times under the profiler, each in a `span`; returns
    the summary (a dict)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(MARK):  # a kernel on the entry's stream
            torch.ones(1, device=device).add_(1)
        for _ in range(n):
            with record_function(span):
                call()
        sync()
    return summarize(prof.profiler.kineto_results.events(), span)


def _is_device(e) -> bool:
    """Device activity: kernels, copies and sets (not the device-side
    copies of host annotations, such as the spans themselves)."""
    return (str(e.device_type()).endswith("CUDA")
            and not e.is_user_annotation())


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events, span: str) -> dict:
    marks = [e for e in events if e.name() == span
             and not str(e.device_type()).endswith("CUDA")]
    if not marks:
        return None
    spans = sorted((e.start_ns(), e.end_ns(), e.start_thread_id())
                   for e in marks)
    mark = next(((e.start_ns(), e.end_ns(), e.start_thread_id())
                 for e in events if e.name() == MARK
                 and not str(e.device_type()).endswith("CUDA")), None)
    w0, w1 = spans[0][0], spans[-1][1]
    tid = spans[0][2]
    dev = [e for e in events if _is_device(e)]
    host = [e for e in events if not _is_device(e)]
    # device activity inside the window
    inside = [(max(e.start_ns(), w0), min(e.end_ns(), w1)) for e in dev
              if e.end_ns() > w0 and e.start_ns() < w1]
    busy = _union(inside)
    busy_ns = sum(b - a for a, b in busy)
    # the entry's graph launches: a graph's device operations carry its
    # launch's correlation id and run on the stream it was launched into;
    # the entry's stream is that of the mark's kernel, launched on the
    # calling thread's current stream before the calls (the backend's and
    # the recognizer's graphs run on streams of their own)
    mark_ops = {e.correlation_id() for e in host
                if e.start_ns() >= mark[0] and e.end_ns() <= mark[1]
                and e.start_thread_id() == mark[2]
                and e.name() != MARK} if mark else set()
    streams = {e.device_resource_id() for e in dev
               if e.linked_correlation_id() in mark_ops}
    launches = {e.correlation_id() for e in host
                if "GraphLaunch" in e.name()}
    groups = defaultdict(lambda: [0, 0])
    for e in dev:
        key = e.correlation_id()
        if key in launches and e.device_resource_id() in streams:
            g = groups[key]
            g[0] += 1
            g[1] += e.duration_ns()
    # kernel time by name
    by_name = defaultdict(float)
    bm_ns, bm_calls = 0, 0
    for e in dev:
        by_name[e.name()[:NAME_CHARS]] += e.duration_ns() / 1e9
        if any(k in e.name() for k in BM_KERNELS):
            bm_ns += e.duration_ns()
            bm_calls += "bm_cost_kernel" in e.name()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    # idle gaps, named by span and the innermost host op at their middle
    gaps = []
    prev = w0
    for a, b in busy + [[w1, w1]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    own = [e for e in host if e.start_thread_id() == tid]
    named = []
    for a, b in gaps:
        mid = (a + b) // 2
        k = next((i for i, s in enumerate(spans) if s[0] <= mid <= s[1]),
                 None)
        cover = [e for e in own if e.start_ns() <= mid <= e.end_ns()
                 and e.name() != span]
        inner = (min(cover, key=lambda e: e.duration_ns()).name()
                 if cover else "host Python, no torch operation")
        where = f"{span} {k}" if k is not None else "between calls"
        named.append([f"{where}: {inner}", (b - a) / 1e9])
    return {
        "calls": len(spans),
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy_ns / 1e9,
        "graph_launches": [(n, ns / 1e9) for n, ns in groups.values()],
        "bm_s": bm_ns / 1e9,
        "bm_calls": bm_calls,
        "device_ops": [[k, v] for k, v in top],
        "idle_gaps": named,
        "device_events": len(dev),
        "entry_streams": sorted(streams),
    }
