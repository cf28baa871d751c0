"""Per-stage performance monitor with the reference's named-stage API (a
copy of scavislam_tpu.utils.perfmon, which imports nothing of JAX).

Replaces VisionTools' PerformanceMonitor (used in the reference's
stereo_slam.cpp:169-186: stages registered by name, bracketed with
start/stop around each pipeline step, new_frame()/fps() per frame, live
stacked-histogram plot). Here: host wall-clock timers; `summary()` replaces
the GUI plot; timings export as dicts.
"""

from __future__ import annotations

import time
from collections import defaultdict


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
