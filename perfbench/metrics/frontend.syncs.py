"""frontend.syncs: the host calls that waited on the device (a pending
fetch, a host read of a device tensor, an upload from pageable memory),
counted by site in StereoFrontend's or StreamPool's timing_log, mean per
call of the window."""


def read(rec):
    log = getattr(rec, "fe_timing", None) or getattr(rec, "pool_timing",
                                                     None)
    syncs = [x[-1]["syncs"] for x in log or () if isinstance(x[-1], dict)]
    if not syncs:
        return None
    return sum(sum(s.values()) for s in syncs) / len(syncs)
