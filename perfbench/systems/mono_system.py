"""Driver of configurations whose ``system`` is ``mono_system``: one
camera through ``MonoSystem.process_frame`` (the monocular frontend, the
window BA, place recognition with Sim3 loop closure), the frames handed in
as device-resident uint8 stacks whose plane 0 the step takes (the role of
``FileGrabber``'s device prefetch), in a closed loop."""

from __future__ import annotations

import dataclasses
import sys

from perfbench.core import check, manifest
from perfbench.core.program import program_config
from perfbench.core.traffic import ground_truth


class Driver:
    span = "frame"  # the record_function span around each entry call

    def __init__(self, config: dict, traffic, device, program_hook=None,
                 logs: bool = False):
        from scavislam_tpu_torch.models import mono_frontend
        from scavislam_tpu_torch.pipeline.mono_system import MonoSystem

        cfg, cam = program_config(config)
        cfg = dataclasses.replace(cfg,
                                  use_n_levels_in_frontent=config["levels"])
        # the sizes the configuration states are the program's constants
        have = {"candidates": mono_frontend.CAND_CAP,
                "spawns": list(mono_frontend.NEW_PER_LEVEL)}
        for k, v in have.items():
            if config[k] != v:
                raise ValueError(f"the configuration's {k!r} is "
                                 f"{config[k]}, the program's {v}")
        m = config["mono_system"]
        fe = mono_frontend.MonoFrontend(
            cam, cfg, prior_idepth=m["prior_idepth"],
            conv_q_info=m["conv_q_info"], prior_weight=m["prior_weight"],
            device=device)
        self.system = MonoSystem(
            cam, cfg, pipelined=m["pipelined"],
            pipeline_depth=m["pipeline_depth"], window_ba=m["window_ba"],
            dwo=m["dwo"], dwo_inner=m["dwo_inner"], dwo_outer=m["dwo_outer"],
            loop_close=m["loop_close"], loop_score_thr=m["loop_score_thr"],
            frontend=fe)
        self.stacks, self.gt = traffic.streams[0]
        self.gts = [self.gt]
        # for the check of the matches: the scene, each frame's true pose
        # in the world, and the frame each keyframe was made from
        p = traffic.params
        self.scene = p["scenes"][0]
        self.world = ground_truth(p, int(p["starts"][0]), traffic.n)[1]
        self.kf_frames = {}
        self.next = 0
        self.step_site = (fe, "_step")
        self.check = manifest.load_check(config)
        if program_hook is not None:
            program_hook(self)
        self.steps = check.CallRecorder(*self.step_site, self._take_state,
                                        self.check.keep_out)
        if logs:
            fe.timing_log = []

    # -- the entry ---------------------------------------------------------
    def frame(self, i: int) -> dict:
        return {"frame_id": i, "stacked_dev": self.stacks[i]}

    def _take_state(self, args, kwargs) -> dict:
        """The comparison's state of the step, and the truth its matches
        are judged by (the step of frame `next` runs inside its call)."""
        state = self.check.take_state(args, kwargs)

        def pose(i):
            return self.world[i].R.clone(), self.world[i].t.clone()

        state["truth"] = {
            "scene": self.scene, "frame": pose(self.next),
            "keyframes": {k: pose(i) for k, i in self.kf_frames.items()}}
        return state

    def _note_keyframe(self, n_kf: int):
        """A call that made a keyframe made it from the frame whose pose
        it returned last."""
        fe = self.system.frontend
        if fe.next_kf != n_kf:
            self.kf_frames[fe.actkey_id] = self.system.trajectory[-1][0]

    def first(self):
        traj = self.system.trajectory
        fe = self.system.frontend
        n_kf = fe.next_kf
        self.system.process_first_frame(self.frame(0))
        self._note_keyframe(n_kf)
        if fe.timing_log is not None:
            fe.spans.fold()  # keyframe 0's spawn and indexing: set-up
        self.next = 1
        return [(0, 0)], [(0, fid) for fid, _ in traj]

    def call(self):
        """One entry call: (keys handed in, keys whose pose it returned);
        a key is (stream, frame id)."""
        traj = self.system.trajectory
        n0 = len(traj)
        i = self.next
        n_kf = self.system.frontend.next_kf
        self.system.process_frame(self.frame(i))
        self._note_keyframe(n_kf)
        self.next += 1
        return [(0, i)], [(0, fid) for fid, _ in traj[n0:]]

    # -- the window and the checks -----------------------------------------
    def arm(self, tag):
        """Keep the next frame step's state and output, tagged (None:
        keep nothing)."""
        self.steps.arm(tag)

    def _counts(self) -> dict:
        pr = self.system.place_recognizer
        return {"keyframes": self.system.frontend.next_kf,
                "loops": len(self.system.loops_closed),
                "checks": pr.counters["over_threshold"] if pr else 0,
                "relocalizations": self.system.relocalizations}

    def open_window(self):
        self._fe_log0 = len(self.system.frontend.timing_log or ())
        self._counts0 = self._counts()

    def close_window(self):
        self._fe_log1 = len(self.system.frontend.timing_log or ())
        c1 = self._counts()
        self._window_counts = {k: c1[k] - self._counts0[k] for k in c1}
        print(f"mono: in the window {self._window_counts}", file=sys.stderr,
              flush=True)

    def close(self):
        """Flush the pipeline: the keys of the poses the flush returned."""
        self._fe_log_end = len(self.system.frontend.timing_log or ())
        traj = self.system.trajectory
        n0 = len(traj)
        self.system.finish()
        return [(0, fid) for fid, _ in traj[n0:]]

    def trajectories(self):
        return [list(self.system.trajectory)]

    def layer_logs(self) -> dict:
        """The window's timing_log entries under the stereo drivers' key
        (their entries have the same shape), and for the keyframe readers
        (a keyframe comes every ~50 frames) every entry from the first
        call after the first frame to the end of the profiled calls."""
        log = self.system.frontend.timing_log or []
        return {
            "fe_timing": log[self._fe_log0:self._fe_log1],
            "fe_run_timing": log[:self._fe_log_end],
        }

    def release(self):
        """Drop the program (its state and tables); the recorder keeps
        only what it cloned."""
        self.system = None
        self.step_site = None
        self.steps.orig = None
