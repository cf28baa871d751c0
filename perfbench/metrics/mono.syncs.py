"""mono.syncs: the host calls that waited on the device (a pending fetch,
an upload from pageable memory, a download read), counted by site in
MonoFrontend's timing_log, mean per entry of the window (a call that
stepped a frame): frontend.syncs' count, read from the monocular cell."""

from perfbench.core import manifest


def read(rec):
    return manifest.load_reader("frontend.syncs")(rec)
