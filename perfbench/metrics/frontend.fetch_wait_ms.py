"""frontend.fetch_wait_ms: StereoFrontend.timing_log's fetch wait, mean
per frame of the window (ms): the host policy waiting on the card."""


def read(rec):
    log = getattr(rec, "fe_timing", None)
    if not log:
        return None
    return 1e3 * sum(x[2] for x in log) / len(log)
