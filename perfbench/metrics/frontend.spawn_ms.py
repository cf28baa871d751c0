"""frontend.spawn_ms: the host time of keyframe spawns, the
`frontend.spawn` span (the spawn source, the pose and spawn uploads, the
spawn step's dispatch) and the `frontend.spawn_finalize` span (the
payload read, the backend packet) in StereoFrontend's or StreamPool's
timing_log, mean over the calls of the window that had either (ms). A
finalize forced out by a new spawn runs inside it, so the spawn counts
by its self time."""


def read(rec):
    log = getattr(rec, "fe_timing", None) or getattr(rec, "pool_timing",
                                                     None)
    per_call = []
    for x in log or ():
        if not isinstance(x[-1], dict):
            continue
        s = x[-1]["spans"]
        spawn, fin = s.get("frontend.spawn"), s.get("frontend.spawn_finalize")
        if spawn or fin:
            per_call.append((spawn[1] if spawn else 0.0)
                            + (fin[0] if fin else 0.0))
    if not per_call:
        return None
    return 1e3 * sum(per_call) / len(per_call)
