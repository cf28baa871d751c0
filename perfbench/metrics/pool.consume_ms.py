"""pool.consume_ms: StreamPool.timing_log's consume (the B streams' host
policy), mean per tick of the window (ms)."""


def read(rec):
    log = getattr(rec, "pool_timing", None)
    if not log:
        return None
    return 1e3 * sum(x[2] for x in log) / len(log)
