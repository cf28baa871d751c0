"""The comparison of the monocular frame step (``mono_step``) with its
plain reference.

At calls of the window drawn from the seed, the recorder keeps the
program's state that the timed path's own frame step was handed (the
previous pose, the keyframe poses, the points and their information, the
candidates and the two weighing settings) and what it returned (the pose,
its uv matches, its gate, the filtered point table). Once the window has
closed and the program is released, the reference
(``reference/mono_frame.py``) works out in float64, from the handed state
and the step's own matches, the pose, the gate and the filtered points
the step should have returned:

- ``step_pose_gap_median``: the median, over every checked call, of the
  largest absolute difference over the 12 numbers of the pose (R_cw,
  t_cw; t in the map's own scale);
- ``step_pose_gap``: the widest of them (the motion-only LM stops where an
  IRLS step no longer lowers its cost, so rounding moves a pose now and
  then by more than the median shows);
- ``psi_gap``: the widest absolute difference of a filtered point (x/z,
  y/z, 1/z in its anchor keyframe) over the candidates that both the step
  and the reference gate.

The pose and the depths follow the matches, so the matches are judged on
their own, against the scene: where the state holds the truth (the
driver's ``truth``: the scene, the frame's and each keyframe's true
pose), each matched candidate's distance in level pixels from the true
projection of the point its anchor keyframe saw at its creation pixel:

- ``match_px_median``: the median over the matches of every checked call;
- ``match_far_share``: the share of them farther than ``FAR_PX``.

The control (``perfbench/control.py``) is the reference computed in
float32 with TF32 allowed, put in the program's place: the same numbers
for it against the float64 reference.
"""

from __future__ import annotations

import statistics

import torch

from perfbench.core.check import Readings, pose_gap, precision
from perfbench.core.traffic import scene
from perfbench.reference import mono_frame as ref

# a match farther than this (level pixels) from its true position is far
FAR_PX = 1.0

# the packed download's layout (mono_step): the gate at 34, the matched
# flags at 34 + C, of a vector 34 + 5 C long
_HEAD = 34


def _clone(x):
    return x.detach().clone()


def take_state(args, kwargs) -> dict:
    """The program's state a frame step was handed, by the positions of
    ``mono_step(img, R_cw, t_cw, actkey, poses, points, Lam, cand,
    conv_q_info, prior_weight, ...)``."""
    poses, points = args[4], args[5]
    return {"R": _clone(args[1]), "t": _clone(args[2]),
            "poses": (_clone(poses.R), _clone(poses.t)),
            "points": (_clone(points.psi), _clone(points.anchor),
                       _clone(points.level)),
            "uv0": _clone(points.uv0),
            "info": _clone(args[6]), "cand": _clone(args[7]),
            "conv": _clone(torch.as_tensor(args[8])),
            "weight": _clone(torch.as_tensor(args[9]))}


def keep_out(out) -> dict:
    """What a frame step returned that the checks judge."""
    C = out.obs_uv.shape[0]
    flags = out.packed[_HEAD:_HEAD + 2 * C] > 0.5
    return {"R": _clone(out.R_cw), "t": _clone(out.t_cw),
            "obs": _clone(out.obs_uv), "gate": _clone(flags[:C]),
            "matched": _clone(flags[C:]), "psi": _clone(out.points.psi)}


def camera(config: dict) -> ref.Camera:
    c = config["camera"]
    return ref.Camera(c["f"], c["px"], c["py"])


def _psi_gap(psi_table, cand, gate, want) -> float:
    """The widest difference of the filtered points over the candidates
    both `gate` and `want.gate` take."""
    both = gate & want.gate
    if not bool(both.any()):
        return 0.0
    got = psi_table[cand.clamp(0, len(psi_table) - 1).long()]
    return float((got[both].double() - want.psi[both].double()).abs().max())


def compare(samples, stacks, config: dict, readings: Readings,
            control: Readings = None):
    """Each kept step against the reference (the frames are not needed:
    the reference starts from the step's matches)."""
    cam = camera(config)
    max_reproj = float(config["max_reproj_error"])
    gaps, ctl_gaps, errs = [], [], []
    for _i, state, out in samples:
        truth = state.get("truth")
        if truth is not None:
            _psi, anchor, level = state["points"]
            errs.append(ref.match_errors(
                scene(truth["scene"]), truth, anchor, level, state["uv0"],
                state["cand"], out["obs"], out["matched"], cam))
        x = ref.MonoInputs(
            state["R"], state["t"], state["poses"], state["points"],
            state["info"], state["cand"], float(state["conv"]),
            float(state["weight"]), out["obs"], out["matched"])
        with precision(False):
            want = ref.mono_step(x, cam, max_reproj)
        gaps.append(pose_gap(out["R"], out["t"], want.R, want.t))
        readings.worst("psi_gap", _psi_gap(out["psi"], state["cand"],
                                           out["gate"], want))
        if control is not None:
            with precision(True):
                c = ref.mono_step(x, cam, max_reproj, torch.float32)
            ctl_gaps.append(pose_gap(c.R, c.t, want.R, want.t))
            both = c.gate & want.gate
            control.worst("psi_gap", float(
                (c.psi[both].double() - want.psi[both]).abs().max())
                if bool(both.any()) else 0.0)
    if errs:
        e = torch.cat(errs)
        readings.worst("match_px_median",
                       float(e.quantile(0.5)) if len(e) else 0.0)
        readings.worst("match_far_share", float(
            (e > FAR_PX).double().mean()) if len(e) else 0.0)
    for rd, g in ((readings, gaps), (control, ctl_gaps)):
        if g:
            rd.gaps = g
            rd.worst("step_pose_gap", max(g))
            rd.worst("step_pose_gap_median", statistics.median(g))
