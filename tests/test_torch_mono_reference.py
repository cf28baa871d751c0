"""The monocular frame step (models/mono_step.py, as MonoFrontend runs it)
against the benchmark's plain float64 reference of it
(perfbench/reference/mono_frame.py, judged by perfbench/checks/mono_step.py)
at 128x96 on the CPU: the numbers compared fall within the limits of the
benchmark's mono configuration, while the reference computed a precision
lower (float32 with the matrix products' inputs rounded to TF32, as a card
does with TF32 allowed) and a step that returns the pose it was handed
each read past at least one of them.

Frames: the benchmark's generator at its tiny test camera, the forward
arc of the cell's traffic with a longer step, so that a keyframe spawns
within a few frames; the checked frames include the first after it.
"""

import functools

import pytest
import torch
from torch.overrides import TorchFunctionMode

from perfbench.checks import mono_step as check_mono
from perfbench.core import check, faults, manifest
from perfbench.core.program import program_config
from perfbench.core.traffic import Traffic, ground_truth
from perfbench.tests.conftest import TINY_CAMERA
from scavislam_tpu_torch.models.mono_frontend import MonoFrontend

STEPS = ("step_pose_gap_median", "step_pose_gap", "psi_gap")
EARLY = (8, 12)  # checked frames before the first keyframe spawn


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _cell():
    cell = manifest.Cell("mono.forward_arc")
    config = dict(cell.config, camera=TINY_CAMERA)
    traffic = dict(cell.traffic, step=0.035, max_frames=30)
    stacks, _ = Traffic(traffic, TINY_CAMERA, 1, 7, "cpu").streams[0]
    world = ground_truth(traffic, 0, len(stacks))[1]
    return config, stacks, traffic["scenes"][0], world


def run_checked(fault=None, shift=0, truth=False):
    """The frames through MonoFrontend (synchronous) with the step's state
    and output kept at EARLY and at the frame after the first keyframe
    spawn; returns (samples, config, the spawn's frame). `shift` moves the
    step's image that many pixels right; with `truth` each kept state
    holds the true poses its matches are judged by, as the benchmark's
    driver gives them."""
    config, stacks, scene, world = _cell()
    cfg, cam = program_config(config)
    m = config["mono_system"]
    fe = MonoFrontend(cam, cfg, prior_idepth=m["prior_idepth"],
                      conv_q_info=m["conv_q_info"],
                      prior_weight=m["prior_weight"], device="cpu")
    if fault is not None:
        orig = fe._step

        def broken(*args, **kwargs):
            state = check_mono.take_state(args, kwargs)
            return faults.FAULTS[fault](orig(*args, **kwargs), state)

        fe._step = broken
    if shift:
        step = fe._step

        def shifted(img, *args, **kwargs):
            return step(torch.roll(img, shift, dims=-1), *args, **kwargs)

        fe._step = shifted
    kf_frames = {}
    now = [0]

    def take_state(args, kwargs):
        state = check_mono.take_state(args, kwargs)
        if truth:
            def pose(i):
                return world[i].R, world[i].t

            state["truth"] = {
                "scene": scene, "frame": pose(now[0]),
                "keyframes": {k: pose(i) for k, i in kf_frames.items()}}
        return state

    rec = check.CallRecorder(fe, "_step", take_state, check_mono.keep_out)
    fe.process_first_frame({"frame_id": 0, "stacked_dev": stacks[0]})
    kf_frames[fe.actkey_id] = 0
    spawn = None
    for i in range(1, len(stacks)):
        now[0] = i
        if i in EARLY or (spawn is not None and i == spawn + 1):
            rec.arm(i)
        ok, dropped = fe.process_frame({"frame_id": i,
                                        "stacked_dev": stacks[i]})
        if fault is None:
            assert ok, f"tracking failed at frame {i}"
        if dropped:
            kf_frames[fe.actkey_id] = i
        if dropped and spawn is None:
            spawn = i
        if spawn is not None and i > spawn:
            break
    return rec.samples, config, spawn


def _tf32(x):
    """float32 rounded to TF32's 10 mantissa bits (to nearest)."""
    if not (isinstance(x, torch.Tensor) and x.dtype == torch.float32):
        return x
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


class Tf32Products(TorchFunctionMode):
    """The inputs of every float32 matrix product rounded to TF32, as a
    card computes them with TF32 allowed."""

    PRODUCTS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__,
                torch.Tensor.__rmatmul__, torch.bmm, torch.mm, torch.einsum}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self.PRODUCTS:
            args = tuple(_tf32(a) for a in args)
        return func(*args, **(kwargs or {}))


MATCHES = ("match_px_median", "match_far_share")


def _exceeds(values, limits) -> list:
    return [k for k in STEPS if values.get(k, 0.0) > limits[k]]


def test_step_within_the_limits_and_the_control_past_one():
    samples, config, spawn = run_checked()
    assert spawn is not None and [i for i, _, _ in samples] == [
        *EARLY, spawn + 1]
    limits = config["limits"]
    readings = check.Readings(dict(limits))
    control = check.Readings(dict(limits))
    with Tf32Products():
        check_mono.compare(samples, None, config, readings, control)
    assert len(readings.gaps) == 3
    for k in STEPS:
        assert readings.values[k] <= limits[k], (k, readings.values)
    assert _exceeds(control.values, limits), control.values


def test_step_against_reference_is_not_tf32_rounded():
    """The emulation rounds float32 products only: the float64 reference,
    and so the program's readings, are the same with it or without it."""
    samples, config, _ = run_checked()
    a = check.Readings(dict(config["limits"]))
    b = check.Readings(dict(config["limits"]))
    check_mono.compare(samples, None, config, a)
    with Tf32Products():
        check_mono.compare(samples, None, config, b)
    assert a.values == b.values


def test_state_unchanged_is_past_a_limit():
    samples, config, _ = run_checked("state_unchanged")
    readings = check.Readings(dict(config["limits"]))
    check_mono.compare(samples, None, config, readings)
    assert _exceeds(readings.values, config["limits"]), readings.values


@pytest.mark.parametrize("shift", [0, 1], ids=["sound", "a_pixel_off"])
def test_matches_against_the_scene(shift):
    """The step's matches within the limits of their distance from the
    scene's truth, and every other number within its own; with the image
    a pixel off, the matches past both of theirs."""
    samples, config, _ = run_checked(shift=shift, truth=True)
    limits = config["limits"]
    readings = check.Readings(dict(limits))
    check_mono.compare(samples, None, config, readings)
    over = {k for k in MATCHES if readings.values[k] > limits[k]}
    if shift:
        assert over == set(MATCHES), readings.values
    else:
        assert over == set(), readings.values
        assert not _exceeds(readings.values, limits), readings.values
