"""mono.place_ms: the host time of monocular place recognition, the
`mono.place` span that MonoSystem records in MonoFrontend's timing_log
(the keyframe's description and indexing, the query, and the Sim3 check
and closure where retrieval fires), mean per keyframe indexed in the run
after set-up: the warm-up, the window and the profiled calls (a keyframe
comes every ~50 frames) (ms)."""

from perfbench.core.spans import ms_per_count


def read(rec):
    return ms_per_count(getattr(rec, "fe_run_timing", None), "mono.place")
