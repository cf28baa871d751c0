"""mono.device_ops: device operations (kernels, copies, sets) per entry
call in the profiled sub-window of a monocular cell, from its trace: the
frame step's launches and whatever else the calls ran on the card."""


def read(rec):
    t = rec.trace
    if not t or not t["calls"] or not t["device_events"]:
        return None
    return t["device_events"] / t["calls"]
