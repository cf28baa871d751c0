"""step.kernels: device operations per CUDA graph replay of the entry's
program (the frame step, or the pool's tick), from the profiled
sub-window's trace: the device activity of each cudaGraphLaunch made on
the entry calls' thread, averaged over the launches."""


def read(rec):
    t = rec.trace
    if not t or not t["graph_launches"]:
        return None
    g = t["graph_launches"]
    return sum(n for n, _ in g) / len(g)
