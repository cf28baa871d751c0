"""The helpers of chip_smoke.py's phase 15 on the CPU: the phase runs the
port on the card and on the CPU over the same CPU-rendered uint8 frames and
the same RANSAC draws, and holds the pair to the north star (ATE within 1%
relative, equal counts). Here both "devices" are the CPU, on the first 12
frames of the 90-frame spin at 256x192 (chip_smoke.py phase 9's camera and
configuration), so the comparison itself is held before the card runs it.
"""

import copy

import numpy as np
import pytest
import torch

import chip_smoke as cs
from scavislam_tpu_torch.io.synthetic import closed_box
from scavislam_tpu_torch.models.placerec import NUM_HYPOTHESES
from scavislam_tpu_torch.ops.ransac import draw_hypotheses
from scavislam_tpu_torch.utils.config import Config

N_SPIN = 90  # the spin's length: its step is 1 / (N_SPIN - 1)
N_FRAMES = 12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def spin():
    cam, cfg = cs._loop_cam_cfg(Config(), 0.25, windows=(3, 8))
    frames = cs.parity_frames(cam, N_FRAMES, kind="spin", planes=closed_box(),
                              step=1.0 / (N_SPIN - 1))
    return cam, cfg, frames


@pytest.fixture(scope="module")
def runs(spin):
    cam, cfg, frames = spin
    return (cs.parity_run(cam, cfg, "cpu", frames),
            cs.parity_run(cam, cfg, "cpu", frames))


def test_parity_frames_are_quantized_host_arrays(spin):
    cam, _, frames = spin
    assert [f["frame_id"] for f in frames] == list(range(N_FRAMES))
    for f in frames:
        for side in ("left", "right"):
            assert isinstance(f[side], np.ndarray)
            assert f[side].dtype == np.uint8
            assert f[side].shape == (cam.size[1], cam.size[0])
    assert frames[0]["left"].std() > 10  # textured, not clipped flat


def test_two_runs_bit_equal(runs):
    a, b = runs
    assert a["tracked"] == a["frames"] == N_FRAMES
    assert a["keyframes"] >= 2 and a["solves"] >= 1
    cmp = cs.parity_compare(a, b, cs.SPIN_COUNTS)
    assert cmp["misses"] == []
    assert cmp["bit_equal"]
    assert cmp["ate_rel_diff"] == 0.0
    assert cmp["traj_rmse_m"] == 0.0
    assert cmp["first_diverged"] is None
    assert a["counters"] == b["counters"]


def test_draws_independent_of_device():
    # the draws come from a CPU generator whatever device they are moved to
    # ("meta" stands in for the card here): the same sequence, and the
    # sequence of a fresh CPU generator seeded 42
    ref = torch.Generator().manual_seed(42)
    on_cpu, elsewhere = cs.CpuDraws("cpu"), cs.CpuDraws("meta")
    assert elsewhere.generator.device.type == "cpu"
    for n in (40, 256, 7):
        a = on_cpu(n)
        b = elsewhere.draw(n)
        assert a.device.type == "cpu" and b.device.type == "cpu"
        assert torch.equal(a, b)
        assert torch.equal(a, draw_hypotheses(n, NUM_HYPOTHESES, ref, "cpu"))
        assert int(a.min()) >= 0 and int(a.max()) < n
    moved = cs.CpuDraws("meta")(64)
    assert moved.device.type == "meta"
    assert tuple(moved.shape) == (NUM_HYPOTHESES, 3)


@pytest.mark.parametrize("key,delta", [("keyframes", 1), ("solves", -1),
                                       ("metric_edges", 1),
                                       ("appearance_edges", 1),
                                       ("closed_loops", 1)])
def test_compare_fails_on_a_count(runs, key, delta):
    a, b = runs
    bad = copy.deepcopy(b)
    bad[key] += delta
    misses = cs.parity_compare(a, bad, cs.SPIN_COUNTS)["misses"]
    assert len(misses) == 1 and misses[0].startswith(key)
    # the wander's criteria hold keyframes and solves only
    misses = cs.parity_compare(a, bad, cs.WANDER_COUNTS)["misses"]
    assert len(misses) == (key in cs.WANDER_COUNTS)


@pytest.mark.parametrize("scale,missed", [(1.0099, False), (1.0101, True),
                                          (0.9899, True)])
def test_compare_holds_the_ate_bound(runs, scale, missed):
    a, b = runs
    bad = dict(a, ate=a["ate"] * scale)
    cmp = cs.parity_compare(bad, b, cs.SPIN_COUNTS)
    assert abs(cmp["ate_rel_diff"] - abs(scale - 1)) < 1e-9
    assert bool(cmp["misses"]) == missed
    assert cmp["bit_equal"]  # the trajectories themselves were not touched


def test_compare_reports_divergence_and_lost_frames(runs):
    a, b = runs
    bad = copy.deepcopy(b)
    fid = N_FRAMES - 3
    R, t = bad["trajectory"][fid]
    bad["trajectory"][fid] = (R, t + np.array([0.0, 2e-4, 0.0]))
    cmp = cs.parity_compare(a, bad, cs.SPIN_COUNTS)
    assert cmp["first_diverged"] == fid and not cmp["bit_equal"]
    assert cmp["misses"] == []  # a divergence is printed, not gated
    assert cmp["traj_rmse_m"] == pytest.approx(2e-4 / np.sqrt(N_FRAMES))
    del bad["trajectory"][fid]
    bad["tracked"] -= 1
    misses = cs.parity_compare(a, bad, cs.SPIN_COUNTS)["misses"]
    assert misses == [f"cpu run tracked {N_FRAMES - 1}/{N_FRAMES}"]
