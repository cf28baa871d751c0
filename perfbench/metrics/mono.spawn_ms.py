"""mono.spawn_ms: the host time of a monocular keyframe spawn, the
`mono.spawn` span of MonoFrontend's timing_log (the keyframe's pose and
covisibility, the spawn step, its uploads and its payload read) by its
self time (a window solve adopted first is mono.adopt's), mean per spawn
of the run after set-up: the warm-up, the window and the profiled calls
(a keyframe comes every ~50 frames) (ms)."""

from perfbench.core.spans import ms_per_count


def read(rec):
    return ms_per_count(getattr(rec, "fe_run_timing", None), "mono.spawn", 1)
