"""The monocular cell `mono.forward_arc`: its entries load by name, a
rehearsal on the CPU at the tiny camera is correct and the faults of a
single stream are not, the plain reference loads nothing of the port, and
the six readers on synthetic records."""

import subprocess
import sys

import pytest
import torch

from perfbench.core import faults, harness, manifest
from perfbench.core.harness import Record
from perfbench.tests.test_perfbench_faults import failed_a_limit
from perfbench.tests.test_perfbench_rehearsal import SEED, WINDOW_S, tiny

CELL = "mono.forward_arc"
READERS = ("mono.step_ms", "mono.device_ops", "mono.spawn_ms",
           "mono.window_ms", "mono.place_ms", "mono.syncs")


def test_the_manifest_loads_the_cell():
    c = manifest.Cell(CELL)
    assert c.chips == 1
    assert (c.config["system"], c.config["step_check"],
            c.config["ate_align"]) == ("mono_system", "mono_step", "sim3")
    assert c.config_entry["reduced"] == ["images"]
    assert {m["name"] for m in c.end_to_end} == {
        "frames_per_s", "frame_ms_p95", "ate_m", "setup_s"}
    assert [m["name"] for m in c.per_layer] == list(READERS)
    assert all(m["workloads"] == [CELL] for m in c.per_layer)
    assert callable(manifest.load_system("mono_system").Driver)
    # the step comparison's numbers and every run's, each with its limit
    assert set(c.config["limits"]) == {
        "step_pose_gap_median", "step_pose_gap", "psi_gap",
        "frames_without_pose", "stream_ate_m", "match_px_median",
        "match_far_share"}


def test_cpu_rehearsal():
    out = harness.execute(CELL, SEED, WINDOW_S, False, device="cpu",
                          overrides=tiny())
    r = out["result"]
    assert r["correct"], out["lines"]
    assert set(r["metrics"]) == {"frames_per_s", "frame_ms_p95", "ate_m",
                                 "setup_s"}
    assert r["attempted"] > 0 and r["failed"] == 0
    assert {k: v["limit"] for k, v in r["checks"].items()} == (
        manifest.Cell(CELL).config["limits"])
    assert len(out["readings"].gaps) == 6
    assert out["forbidden"] == []


def test_cpu_rehearsal_traced():
    out = harness.execute(CELL, SEED + 1, WINDOW_S, True, device="cpu",
                          overrides=tiny())
    r = out["result"]
    assert r["correct"], out["lines"]
    # the span and counter readers find the frontend's log; the device
    # reader finds no device activity on the CPU
    assert {"mono.step_ms", "mono.syncs"} <= set(r["metrics"])
    assert "mono.device_ops" not in r["metrics"]
    assert r["metrics"]["mono.step_ms"]["value"] > 0


@pytest.mark.parametrize("fault", ["state_unchanged", "pose_lost"])
def test_fault_is_not_correct(fault):
    out = harness.execute(CELL, SEED, WINDOW_S, False, device="cpu",
                          overrides=tiny(), program_hook=faults.plant(fault))
    assert not out["result"]["correct"], out["lines"]
    assert failed_a_limit(out), out["lines"]


def shifted_image(driver):
    """A program hook: the step sees its image moved one pixel to the
    right, as a matcher whose positions are a pixel off would report."""
    fe = driver.system.frontend
    step = fe._step

    def shifted(img, *args, **kwargs):
        return step(torch.roll(img, 1, dims=-1), *args, **kwargs)

    fe._step = shifted


def test_matches_a_pixel_off_are_not_correct():
    # the pose, the depths and the trajectory follow the matches: the
    # matches' distance from the scene's truth tells
    out = harness.execute(CELL, SEED, WINDOW_S, False, device="cpu",
                          overrides=tiny(), program_hook=shifted_image)
    assert not out["result"]["correct"], out["lines"]
    limits = manifest.Cell(CELL).config["limits"]
    over = {k for k, v in out["readings"].values.items() if v > limits[k]}
    assert {"match_px_median", "match_far_share"} <= over, out["lines"]


def test_reference_loads_nothing_of_the_port():
    code = ("import perfbench.reference.mono_frame, perfbench.checks."
            "mono_step\nimport sys\nprint(sorted({m.split('.')[0] for m in "
            "sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=300)
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not tops & {"scavislam_tpu_torch", "scavislam_tpu", "jax",
                       "jaxlib", "flax"}


def _folded(spans, syncs=None):
    return {"spans": spans, "syncs": syncs or {}}


# (total_s, self_s, count) per span name: a plain frame, a keyframe's
# consume (its spawn, with a window solve adopted inside it), the frame
# after it (MonoSystem's window dispatch and place query fold there) and a
# frame whose consume adopts a landed solve
PLAIN = _folded({"mono.dispatch": (0.300, 0.010, 1),
                 "mono.step": (0.290, 0.290, 1),
                 "mono.consume": (0.004, 0.004, 1)})
SPAWN = _folded({"mono.dispatch": (0.310, 0.010, 1),
                 "mono.step": (0.300, 0.300, 1),
                 "mono.consume": (0.040, 0.004, 1),
                 "mono.spawn": (0.036, 0.030, 1),
                 "mono.adopt": (0.006, 0.006, 1)},
                {"keyframe.pose": 3, "spawn.upload": 3})
AFTER = _folded({"mono.window_ba": (0.110, 0.100, 1),
                 "mono.adopt": (0.010, 0.010, 1),
                 "mono.place": (0.012, 0.012, 1),
                 "mono.dispatch": (0.300, 0.010, 1),
                 "mono.step": (0.290, 0.290, 1),
                 "mono.consume": (0.004, 0.004, 1)},
                {"window.upload": 18, "describe.fetch": 1, "cand.upload": 1})
ADOPT = _folded({"mono.dispatch": (0.300, 0.010, 1),
                 "mono.step": (0.290, 0.290, 1),
                 "mono.adopt": (0.020, 0.020, 1),
                 "mono.consume": (0.004, 0.004, 1)},
                {"adopt.upload": 4, "pose.upload": 2})


def _read(name, rec):
    return manifest.load_reader(name)(rec)


def _record(entries, trace=None):
    """The driver's logs: the window's entries, and the run's (here the
    same) that the keyframe readers read."""
    log = [(i, 0.3, 0.0, 0.004, f) for i, f in enumerate(entries)]
    return Record({"fe_timing": log, "fe_run_timing": log}, trace)


def test_the_readers_on_a_synthetic_record():
    rec = _record([PLAIN, SPAWN, AFTER, ADOPT],
                  {"calls": 8, "device_events": 111338})
    assert _read("mono.step_ms", rec) == pytest.approx(
        1e3 * (0.290 + 0.300 + 0.290 + 0.290) / 4)
    assert _read("mono.device_ops", rec) == pytest.approx(111338 / 8)
    # the spawn by its self time (the adopt inside it is the window's)
    assert _read("mono.spawn_ms", rec) == pytest.approx(30.0)
    # the window's self time and every adopt, per window dispatched
    assert _read("mono.window_ms", rec) == pytest.approx(
        1e3 * (0.100 + 0.006 + 0.010 + 0.020))
    assert _read("mono.place_ms", rec) == pytest.approx(12.0)
    assert _read("mono.syncs", rec) == pytest.approx((6 + 20 + 6) / 4)


def test_keyframe_readers_read_the_run_and_the_others_the_window():
    log = [(i, 0.3, 0.0, 0.004, f)
           for i, f in enumerate([PLAIN, SPAWN, AFTER, ADOPT])]
    rec = Record({"fe_timing": log[:1], "fe_run_timing": log}, None)
    assert _read("mono.spawn_ms", rec) == pytest.approx(30.0)
    assert _read("mono.place_ms", rec) == pytest.approx(12.0)
    assert _read("mono.syncs", rec) == 0
    assert _read("mono.step_ms", rec) == pytest.approx(290.0)


def test_a_window_without_keyframes_reads_no_keyframe_metric():
    rec = _record([PLAIN, PLAIN], {"calls": 2, "device_events": 0})
    for name in ("mono.spawn_ms", "mono.window_ms", "mono.place_ms",
                 "mono.device_ops"):
        assert _read(name, rec) is None
    assert _read("mono.syncs", rec) == 0
    assert _read("mono.step_ms", rec) == pytest.approx(290.0)


STEREO = _folded({"frontend.dispatch": (0.030, 0.002, 1),
                  "step.launch": (0.028, 0.028, 1),
                  "frontend.consume": (0.040, 0.001, 1),
                  "frontend.spawn": (0.039, 0.039, 1)},
                 {"spawn.upload": 2, "spawn.fetch": 1})


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_in_other_records(name):
    # a stereo frontend's log (the same key and entry shape: the span
    # readers find no mono span there, and mono.syncs is frontend.syncs'
    # count of it), a pool's, an untraced run
    stereo = Record({"fe_timing": [(1, 0.03, 0.0, 0.04, STEREO)]}, None)
    if name == "mono.syncs":
        assert _read(name, stereo) == _read("frontend.syncs", stereo) == 3
    else:
        assert _read(name, stereo) is None
    for logs in ({"pool_timing": [(0.006, 0.048, 0.040)]}, {}):
        assert _read(name, Record(logs, None)) is None
