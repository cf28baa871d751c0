"""mono.window_ms: the host time of the monocular window BA, the
`mono.window_ba` span (the window's assembly, uploads and the solve's
dispatch) by its self time and the `mono.adopt` span (a landed solve's
download and write-back) whole, wherever it ran, in MonoFrontend's
timing_log, per window solve dispatched in the run after set-up: the
warm-up, the window and the profiled calls (a keyframe comes every ~50
frames) (ms)."""

from perfbench.core.spans import folded_spans


def read(rec):
    spans = folded_spans(getattr(rec, "fe_run_timing", None))
    windows = [s["mono.window_ba"] for s in spans if "mono.window_ba" in s]
    if not windows:
        return None
    adopt = sum(s["mono.adopt"][0] for s in spans if "mono.adopt" in s)
    return 1e3 * (sum(w[1] for w in windows) + adopt) / sum(
        w[2] for w in windows)
