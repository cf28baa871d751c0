"""The readers of the program's spans and synchronizing calls on
synthetic timing_log entries: a frame's (StereoFrontend) and a tick's
(StreamPool), and the parent's entries, which carry no spans."""

import pytest

from perfbench.core import manifest
from perfbench.core.harness import Record

NAMES = ("step.launch_ms", "frontend.policy_ms", "frontend.spawn_ms",
         "frontend.syncs")


def _folded(spans, syncs):
    return {"spans": spans, "syncs": syncs}


# (total_s, self_s, count) per span name
PLAIN = _folded({"frontend.dispatch": (0.030, 0.004, 1),
                 "step.launch": (0.020, 0.020, 1),
                 "frontend.consume": (0.040, 0.010, 1)}, {})
SPAWN = _folded({"frontend.dispatch": (0.030, 0.004, 1),
                 "step.launch": (0.024, 0.024, 1),
                 "frontend.consume": (0.060, 0.012, 1),
                 "frontend.spawn": (0.030, 0.010, 1),
                 "frontend.spawn_finalize": (0.026, 0.026, 2)},
                {"keyframe.pose": 3, "spawn.upload": 2,
                 "spawn.fetch": 1})
LANDED = _folded({"frontend.dispatch": (0.030, 0.004, 1),
                  "step.launch": (0.022, 0.022, 1),
                  "frontend.consume": (0.045, 0.014, 1),
                  "frontend.spawn_finalize": (0.006, 0.006, 1)},
                 {"frame.fetch": 1})


def _read(name, rec):
    return manifest.load_reader(name)(rec)


@pytest.mark.parametrize("key", ["fe_timing", "pool_timing"])
def test_span_readers(key):
    entries = [PLAIN, SPAWN, LANDED]
    log = ([(i, 0.03, 0.0, 0.04, f) for i, f in enumerate(entries)]
           if key == "fe_timing"
           else [(0.03, 0.0, 0.04, dict(f, streams=[0.02, 0.02]))
                 for f in entries])
    rec = Record({key: log}, None)
    assert _read("step.launch_ms", rec) == pytest.approx(22.0)
    assert _read("frontend.policy_ms", rec) == pytest.approx(12.0)
    # the spawn by its self time (the forced finalize runs inside it),
    # over the two calls that had a spawn or a finalize
    assert _read("frontend.spawn_ms", rec) == pytest.approx(
        1e3 * ((0.010 + 0.026) + 0.006) / 2)
    assert _read("frontend.syncs", rec) == pytest.approx(7 / 3)


def test_no_spawn_in_the_window_reads_nothing():
    rec = Record({"fe_timing": [(1, 0.03, 0.0, 0.04, PLAIN)]}, None)
    assert _read("frontend.spawn_ms", rec) is None
    assert _read("frontend.syncs", rec) == 0


@pytest.mark.parametrize("name", NAMES)
def test_parent_entries_read_nothing(name):
    # a program without spans: the frame's four fields, the tick's three
    for logs in ({"fe_timing": [(1, 0.004, 0.050, 0.006)]},
                 {"pool_timing": [(0.006, 0.048, 0.040)]}, {}):
        assert _read(name, Record(logs, None)) is None


def test_the_metrics_are_in_the_manifest():
    per_layer = {m["name"]: m for m in manifest.load()["per_layer"]}
    for name in NAMES:
        m = per_layer[name]
        assert m["source"] == "program_span"
        assert m["workloads"] == ["nc_stereo.wander", "fleet8.wander"]
