"""Host timing: the per-stage performance monitor with the reference's
named-stage API, and the frame loop's host spans.

``PerformanceMonitor`` is a copy of scavislam_tpu.utils.perfmon, which
imports nothing of JAX. It replaces VisionTools' PerformanceMonitor (used
in the reference's stereo_slam.cpp:169-186: stages registered by name,
bracketed with start/stop around each pipeline step, new_frame()/fps() per
frame, live stacked-histogram plot). Here: host wall-clock timers;
`summary()` replaces the GUI plot; timings export as dicts.

``Spans`` splits the main thread's time in ``StereoFrontend`` and
``StreamPool`` into named spans and counts the host calls there that wait
on the device; each ``timing_log`` entry carries what it folded.
"""

from __future__ import annotations

import contextlib
import functools
import time
import weakref
from collections import Counter, defaultdict
from time import perf_counter

import torch
from torch.profiler import record_function

# the span of an owner whose timing_log is None: one shared no-op context
_OFF = contextlib.nullcontext()


class PerformanceMonitor:
    HISTORY_CAP = 4096  # frames of per-stage history kept for the plot

    def __init__(self):
        self._names: list[str] = []
        self._start: dict[str, float] = {}
        self._acc: dict[str, float] = defaultdict(float)
        self._totals: dict[str, float] = defaultdict(float)
        self._counts: dict[str, int] = defaultdict(int)
        self._frame_t0 = None
        self._frame_times: list[float] = []
        # per-frame {stage: seconds} records, feeding the stacked timing
        # plot (the reference plots these live, stereo_slam.cpp:155-160,636)
        self.history: list[dict] = []

    def add(self, name: str):
        """Register a named stage (stereo_slam.cpp:174-184)."""
        if name not in self._names:
            self._names.append(name)

    def new_frame(self):
        now = time.perf_counter()
        if self._frame_t0 is not None:
            self._frame_times.append(now - self._frame_t0)
            for name, dt in self._acc.items():
                self._totals[name] += dt
                self._counts[name] += 1
            if len(self.history) < self.HISTORY_CAP:
                self.history.append(dict(self._acc))
            self._acc.clear()
        self._frame_t0 = now

    def start(self, name: str):
        self._start[name] = time.perf_counter()

    def stop(self, name: str):
        t0 = self._start.pop(name, None)
        if t0 is not None:
            self._acc[name] += time.perf_counter() - t0

    def fps(self) -> float:
        if not self._frame_times:
            return 0.0
        recent = self._frame_times[-30:]
        return len(recent) / max(sum(recent), 1e-9)

    def frame_count(self) -> int:
        return len(self._frame_times)

    def mean_ms(self, name: str) -> float:
        n = self._counts.get(name, 0)
        return 1000.0 * self._totals[name] / n if n else 0.0

    def summary(self) -> dict:
        return {
            "fps": self.fps(),
            "frames": self.frame_count(),
            "stages_ms": {n: self.mean_ms(n) for n in self._names},
        }


class Spans:
    """Named host spans and synchronizing calls on one owner's thread (a
    ``StereoFrontend``, or a ``StreamPool`` and its streams' frontends,
    which share the pool's).

    The owner's ``timing_log`` is the switch. While it is None,
    ``span(name)`` returns one shared no-op context: no clock is read and
    nothing is allocated. While it is a list, each span records its name,
    start and end on ``time.perf_counter`` and the span enclosing it, and
    under a running ``torch.profiler`` it is also a ``record_function`` of
    the same name, so that it lands in the trace beside the device's
    events. ``fold()`` takes what was recorded since the last fold.

    ``syncs`` counts, by site, the host calls that wait on the device: a
    fetch whose event had not completed, a host read of a device tensor, a
    host-to-device copy from pageable memory. It counts whatever the
    switch, as the kernel wrappers count their launches; on the CPU the
    same sites count, apart from a fetch, which is never pending there.

    It holds its owner by a weak proxy: a reference cycle would leave the
    owner's device tensors, pinned buffers and events to the cyclic
    collector, which can free them anywhere, inside a CUDA graph capture
    too, and an event or pinned-memory free there invalidates the
    capture."""

    def __init__(self, owner):
        self.owner = weakref.proxy(owner)
        self.syncs = Counter()
        self.last_s = 0.0  # the duration of the span that closed last
        self._folded = Counter()
        self._done = []  # [name, start, end, index of the enclosing span]
        self._open = []  # indices into _done of the open spans

    def span(self, name: str):
        if self.owner.timing_log is None:
            return _OFF
        return self._record(name)

    @contextlib.contextmanager
    def _record(self, name):
        rf = (record_function(name) if torch._C._autograd._profiler_enabled()
              else _OFF)
        with rf:
            rec = [name, perf_counter(), 0.0,
                   self._open[-1] if self._open else -1]
            self._open.append(len(self._done))
            self._done.append(rec)
            try:
                yield
            finally:
                rec[2] = perf_counter()
                self._open.pop()
                self.last_s = rec[2] - rec[1]

    def sync(self, site: str, n: int = 1):
        self.syncs[site] += n

    def fold(self) -> dict:
        """What was recorded since the last fold (call it with no span
        open): ``{"spans": {name: (total_s, self_s, count)}, "syncs":
        {site: count}}``, a span's self seconds being its total less its
        named children's."""
        done, self._done = self._done, []
        child = [0.0] * len(done)
        for _, t0, t1, parent in done:
            if parent >= 0:
                child[parent] += t1 - t0
        spans = {}
        for (name, t0, t1, _), c in zip(done, child):
            total, own, n = spans.get(name, (0.0, 0.0, 0))
            spans[name] = (total + t1 - t0, own + t1 - t0 - c, n + 1)
        syncs = self.syncs - self._folded
        self._folded = Counter(self.syncs)
        return {"spans": spans, "syncs": dict(syncs)}


def span_s(folded: dict, name: str) -> float:
    """A folded entry's total seconds in the spans named `name`."""
    return folded["spans"].get(name, (0.0,))[0]


def spanned(name: str):
    """A method of an owner with `spans`, run inside the span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(self, *args, **kwargs):
            with self.spans.span(name):
                return fn(self, *args, **kwargs)
        return call
    return wrap
