"""frontend.host_ms: StereoFrontend.timing_log's dispatch + consume, mean
per frame of the window (ms): the host policy's own time."""


def read(rec):
    log = getattr(rec, "fe_timing", None)
    if not log:
        return None
    return 1e3 * sum(x[1] + x[3] for x in log) / len(log)
