"""frontend.policy_ms: the keyframe policy's host time, the self time of
the `frontend.consume` span in StereoFrontend's or StreamPool's
timing_log (the consume less its fetch wait and keyframe spawns: pose
update, tracked set, switch and drop decisions), summed over the streams
of a pool tick, mean per call of the window (ms)."""


def read(rec):
    log = getattr(rec, "fe_timing", None) or getattr(rec, "pool_timing",
                                                     None)
    spans = [x[-1]["spans"] for x in log or () if isinstance(x[-1], dict)]
    if not spans:
        return None
    return 1e3 * sum(s.get("frontend.consume", (0.0, 0.0))[1]
                     for s in spans) / len(spans)
