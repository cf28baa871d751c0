"""The comparison of the stereo frame step (``frontend_step``, single
stream or the pool's vmapped tick) with its plain reference.

At calls of the window drawn from the seed, the recorder keeps the
program's state that the timed path's own frame step was handed (the
previous pose, the map) and what it returned (the pose, the disparity,
its matches). Once the window has closed and the program is released, the
reference works out, from the frames the benchmark made, the disparity and
the pose the step should have returned (``reference/frame.py``), in
float64:

- ``disp_mismatch_px``: pixels of the checked frames' disparity that
  differ from plain block matching's (exact: limit 0);
- ``step_pose_gap_median``: the median, over every checked call and, in
  the pool, every lane of it, of the largest absolute difference over the
  12 numbers of the pose (R_cw, t_cw; t in metres);
- ``step_pose_gap``: the widest of them. The motion-only LM stops where
  an IRLS step no longer lowers its cost, which depends on where it
  started: rounding in the tracked pose moves a pose by up to ~1e-3 now
  and then (PERF.md). The median holds the precision; the widest, at a
  looser limit, holds every single pose and lane.

The control (``perfbench/control.py``) is the reference computed in
float32 with TF32 allowed, put in the program's place: the same numbers
for it against the float64 reference.
"""

from __future__ import annotations

import statistics

import torch

from perfbench.core.check import Readings, pose_gap, precision
from perfbench.reference import frame as ref
from perfbench.reference.stereo_bm import disparity_of_frames


def _clone(x):
    return x.detach().clone()


def take_state(args, kwargs) -> dict:
    """The program's state a frame step was handed (single stream or
    pool: the same argument positions)."""
    poses, points = args[8], args[9]
    return {"R": _clone(args[5]), "t": _clone(args[6]),
            "poses": (_clone(poses.R), _clone(poses.t)),
            "points": (_clone(points.psi), _clone(points.anchor),
                       _clone(points.level)),
            "cand": _clone(args[10])}


def keep_out(out) -> dict:
    """What a frame step returned that the checks judge."""
    return {"R": _clone(out.R_cw), "t": _clone(out.t_cw),
            "disp": _clone(out.disp), "obs": _clone(out.obs_uvu),
            "matched": _clone(out.matched)}


def camera(config: dict) -> ref.Camera:
    c = config["camera"]
    return ref.Camera(c["f"], c["px"], c["py"], c["baseline"])


def compare(samples, stacks, config: dict, readings: Readings,
            control: Readings = None):
    """Each kept step against the reference. `stacks[s]` holds stream s's
    uint8 frames; a sample's tag is the checked frame's index. A pool's
    step carries a leading stream axis: every lane is checked."""
    cam = camera(config)
    subsample = config["dense_subsample"]
    max_reproj = float(config["max_reproj_error"])
    num_disp = int(config["num_disp"])
    gaps, ctl_gaps = [], []
    for i, state, out in samples:
        pool = out["R"].dim() == 3
        for s in range(len(stacks) if pool else 1):
            lane = (lambda x: x[s]) if pool else (lambda x: x)  # noqa: E731
            prev, cur = stacks[s][i - 1], stacks[s][i]
            disp = disparity_of_frames(cur, num_disp)
            readings.add("disp_mismatch_px", (lane(out["disp"]) != disp).sum())
            inputs = ref.StepInputs(
                prev, cur, disparity_of_frames(prev, num_disp),
                lane(state["R"]), lane(state["t"]),
                tuple(lane(x) for x in state["poses"]),
                tuple(lane(x) for x in state["points"]), lane(state["cand"]),
                lane(out["obs"]), lane(out["matched"]))
            with precision(False):
                R, t = ref.frame_pose(inputs, cam, subsample, max_reproj)
            gaps.append(pose_gap(lane(out["R"]), lane(out["t"]), R, t))
            if control is not None:
                with precision(True):
                    Rc, tc = ref.frame_pose(inputs, cam, subsample,
                                            max_reproj, torch.float32)
                control.add("disp_mismatch_px", 0)
                ctl_gaps.append(pose_gap(Rc, tc, R, t))
    for rd, g in ((readings, gaps), (control, ctl_gaps)):
        if g:
            rd.gaps = g
            rd.worst("step_pose_gap", max(g))
            rd.worst("step_pose_gap_median", statistics.median(g))
