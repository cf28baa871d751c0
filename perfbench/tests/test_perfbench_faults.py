"""The comparison that decides ``correct`` fails when the timed path is
broken underneath: a run driven on the CPU at a tiny size (the look for a
card skipped) with each fault the cells can have planted in the program
(``core/faults.py``). (The cells run on one card: no exchange between
cards to leave out.)"""

import pytest

from perfbench.core import faults, harness
from perfbench.tests.test_perfbench_rehearsal import (
    SEED,
    WINDOW_S,
    kernel_route,
    tiny,
)


def failed_a_limit(out) -> bool:
    """A number compared read past its limit (not only a check left
    without its samples)."""
    rd = out["readings"]
    return any(rd.values.get(k, 0.0) > lim for k, lim in rd.limits.items())


@pytest.mark.parametrize("fault", ["state_unchanged", "answer_altered"])
def test_single_stream_fault_is_not_correct(fault):
    out = harness.execute("nc_stereo.wander", SEED, WINDOW_S, False,
                          device="cpu", overrides=tiny(),
                          program_hook=faults.plant(fault))
    assert not out["result"]["correct"], out["lines"]
    assert failed_a_limit(out), out["lines"]


def test_frames_without_a_pose_are_not_correct():
    """Frames the system returns no pose for count, in the window and in
    the prefix that ATE is taken over, even where the poses it did return
    are right."""
    out = harness.execute("nc_stereo.wander", SEED, WINDOW_S, False,
                          device="cpu", overrides=tiny(),
                          program_hook=faults.plant("pose_lost"))
    assert out["readings"].values["frames_without_pose"] > 0
    assert not out["result"]["correct"], out["lines"]
    assert failed_a_limit(out), out["lines"]


@pytest.mark.parametrize("fault", ["half_batch", "answer_altered",
                                   "one_lane"])
def test_pool_fault_is_not_correct(fault):
    out = harness.execute("fleet8.wander", SEED, WINDOW_S, False, device="cpu",
                          overrides=tiny(streams=2, check_frames=3, check_span=4),
                          program_hook=faults.plant(fault, kernel_route))
    assert not out["result"]["correct"], out["lines"]
    assert failed_a_limit(out), out["lines"]
