"""step.launch_ms: the host's time in the call that launches the entry's
program (the `step.launch` span of StereoFrontend's or StreamPool's
timing_log: the replay's static-input copies, cudaGraphLaunch and the
output clones), mean per call of the window (ms)."""


def read(rec):
    log = getattr(rec, "fe_timing", None) or getattr(rec, "pool_timing",
                                                     None)
    spans = [x[-1]["spans"] for x in log or () if isinstance(x[-1], dict)]
    if not spans:
        return None
    return 1e3 * sum(s.get("step.launch", (0.0,))[0]
                     for s in spans) / len(spans)
