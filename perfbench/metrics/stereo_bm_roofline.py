"""stereo_bm_roofline: the block-matching kernels' share of their roofline,
in %: the least time the card could take for the call's shapes (the
algorithm's operations at the fp32 peak, or its bytes at the memory
rate, whichever is longer: perfbench/core/arith.bound_ms) over the
profiled time of bm_cost_kernel + bm_lr_kernel per call."""

from perfbench.core.arith import bound_ms


def read(rec):
    t = rec.trace
    if not t or not t["bm_calls"] or not t["bm_s"]:
        return None
    bound, _ = bound_ms(*rec.bm_shape)
    return 100.0 * (bound / 1e3) / (t["bm_s"] / t["bm_calls"])
