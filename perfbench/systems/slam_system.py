"""Driver of configurations whose ``system`` is ``slam_system``: one
stereo stream through ``SlamSystem.process_frame`` (frontend, backend,
place recognition), the frames handed in as device-resident uint8 stacks
(the role of ``FileGrabber``'s device prefetch), in a closed loop."""

from __future__ import annotations

from perfbench.core import check, manifest
from perfbench.core.program import program_config


class Driver:
    span = "frame"  # the record_function span around each entry call

    def __init__(self, config: dict, traffic, device, program_hook=None,
                 logs: bool = False):
        from scavislam_tpu_torch.pipeline.slam_system import SlamSystem

        cfg, cam = program_config(config)
        s = config["slam_system"]
        self.system = SlamSystem(
            cam, cfg, threaded=s["threaded"],
            enable_loop_closure=s["enable_loop_closure"],
            pipelined=s["pipelined"], pipeline_depth=s["pipeline_depth"],
            pr_lossless=s["pr_lossless"], device=device)
        self.stacks, self.gt = traffic.streams[0]
        self.gts = [self.gt]
        self.next = 0
        fe = self.system.frontend
        self.bm_shape = (1, cfg.cam.height, cfg.cam.width,
                         config["num_disp"])
        self.step_site = (fe, "_step")
        self.check = manifest.load_check(config)
        if program_hook is not None:
            program_hook(self)
        self.steps = check.CallRecorder(*self.step_site,
                                        self.check.take_state,
                                        self.check.keep_out)
        if logs:
            fe.timing_log = []

    # -- the entry ---------------------------------------------------------
    def frame(self, i: int) -> dict:
        st = self.stacks[i]
        return {"frame_id": i, "left": st[0], "right": st[1],
                "stacked_dev": st}

    def first(self):
        traj = self.system.trajectory
        self.system.process_first_frame(self.frame(0))
        self.next = 1
        return [(0, 0)], [(0, fid) for fid, _ in traj]

    def call(self):
        """One entry call: (keys handed in, keys whose pose it returned);
        a key is (stream, frame id)."""
        traj = self.system.trajectory
        n0 = len(traj)
        i = self.next
        self.system.process_frame(self.frame(i))
        self.next += 1
        return [(0, i)], [(0, fid) for fid, _ in traj[n0:]]

    # -- the window and the checks -----------------------------------------
    def arm(self, tag):
        """Keep the next frame step's state and output, tagged (None:
        keep nothing)."""
        self.steps.arm(tag)

    def open_window(self):
        self._solve_log0 = len(self.system.backend.graph.solve_log)
        self._fe_log0 = len(self.system.frontend.timing_log or ())

    def close_window(self):
        g = self.system.backend.graph
        self._solve_log1 = len(g.solve_log)
        self._fe_log1 = len(self.system.frontend.timing_log or ())

    def close(self):
        """Flush the pipeline and stop the system's threads: the keys of
        the poses the flush returned."""
        traj = self.system.trajectory
        n0 = len(traj)
        self.system.finish()
        self.system.shutdown()
        return [(0, fid) for fid, _ in traj[n0:]]

    def trajectories(self):
        return [list(self.system.trajectory)]

    def layer_logs(self) -> dict:
        fe = self.system.frontend
        g = self.system.backend.graph
        pr = self.system.place_recognizer
        return {
            "fe_timing": (fe.timing_log or [])[self._fe_log0:self._fe_log1],
            "solve_ms": [ms for _, ms in
                         g.solve_log[self._solve_log0:self._solve_log1]],
            "closed_loops": len(self.system.closed_loops),
            "indexed": (pr.counters["indexed"] if pr is not None else 0),
            "bm_shape": self.bm_shape,
        }

    def release(self):
        """Drop the program (its state, graphs and threads' objects); the
        recorder keeps only what it cloned."""
        self.system = None
        self.step_site = None
        self.steps.orig = None
