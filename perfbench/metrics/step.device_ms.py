"""step.device_ms: device time summed over the operations of each CUDA
graph replay of the entry's program (the frame step, or the pool's
tick), mean per replay, from the profiled sub-window's trace (ms)."""


def read(rec):
    t = rec.trace
    if not t or not t["graph_launches"]:
        return None
    g = t["graph_launches"]
    return 1e3 * sum(s for _, s in g) / len(g)
