"""mono.step_ms: the host time of the monocular frame step's call (the
`mono.step` span of MonoFrontend's timing_log: the eager step's launches,
or a replay's), mean per step of the window (ms)."""

from perfbench.core.spans import ms_per_count


def read(rec):
    return ms_per_count(getattr(rec, "fe_timing", None), "mono.step")
