"""Driver of configurations whose ``system`` is ``stream_pool``: B stereo
streams through ``StreamPool.process_frames``, one frame per stream per
tick (one batched device program per tick), frames handed in as
device-resident uint8 stacks, in a closed loop. The pool is visual
odometry only: no backend."""

from __future__ import annotations

from perfbench.core import check, manifest
from perfbench.core.program import program_config


class Driver:
    span = "tick"  # the record_function span around each entry call

    def __init__(self, config: dict, traffic, device, program_hook=None,
                 logs: bool = False):
        from scavislam_tpu_torch.parallel.stream_pool import StreamPool

        cfg, cam = program_config(config)
        p = config["stream_pool"]
        self.B = int(config["streams"])
        self.pool = StreamPool(cam, cfg, n_streams=self.B, mesh=None,
                               pipeline_depth=p["pipeline_depth"],
                               device=device)
        self.streams = traffic.streams
        self.gts = [gt for _, gt in traffic.streams]
        self.next = 0
        self.bm_shape = (self.B, cfg.cam.height, cfg.cam.width,
                         config["num_disp"])
        self.step_site = (self.pool, "step")
        self.check = manifest.load_check(config)
        if program_hook is not None:
            program_hook(self)
        self.steps = check.CallRecorder(*self.step_site,
                                        self.check.take_state,
                                        self.check.keep_out)
        if logs:
            self.pool.timing_log = []

    def tick(self, i: int) -> list:
        return [{"frame_id": i, "left": st[i, 0], "right": st[i, 1]}
                for st, _ in self.streams]

    def _returned(self, n0):
        return [(s, fid) for s, tr in enumerate(self.pool.trajectories)
                for fid, _ in tr[n0[s]:]]

    def _lens(self):
        return [len(t) for t in self.pool.trajectories]

    def first(self):
        n0 = self._lens()
        self.pool.process_first_frames(self.tick(0))
        self.next = 1
        return [(s, 0) for s in range(self.B)], self._returned(n0)

    def call(self):
        n0 = self._lens()
        i = self.next
        self.pool.process_frames(self.tick(i))
        self.next += 1
        return [(s, i) for s in range(self.B)], self._returned(n0)

    def arm(self, tag):
        """Keep the next tick's state and output, tagged (None: keep
        nothing)."""
        self.steps.arm(tag)

    def open_window(self):
        self._log0 = len(self.pool.timing_log or ())

    def close_window(self):
        self._log1 = len(self.pool.timing_log or ())

    def close(self):
        n0 = self._lens()
        self.pool.finish()
        return self._returned(n0)

    def trajectories(self):
        return [list(t) for t in self.pool.trajectories]

    def layer_logs(self) -> dict:
        return {"pool_timing":
                (self.pool.timing_log or [])[self._log0:self._log1],
                "bm_shape": self.bm_shape}

    def release(self):
        """Drop the program; the recorder keeps only what it cloned."""
        self.pool = None
        self.step_site = None
        self.steps.orig = None
