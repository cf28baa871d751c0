"""pool.fetch_wait_ms: StreamPool.timing_log's fetch wait, mean per tick
of the window (ms): the host waiting on the tick's program."""


def read(rec):
    log = getattr(rec, "pool_timing", None)
    if not log:
        return None
    return 1e3 * sum(x[1] for x in log) / len(log)
