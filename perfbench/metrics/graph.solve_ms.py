"""graph.solve_ms: SlamGraph.solve_log over the window, median (ms): each
DWO solve from the CUDA event recorded at its dispatch to its result's
download."""

import statistics


def read(rec):
    ms = getattr(rec, "solve_ms", None)
    if not ms:
        return None
    return statistics.median(ms)
