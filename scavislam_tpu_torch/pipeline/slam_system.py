"""Complete SLAM system: frontend + backend (port of
scavislam_tpu.pipeline.slam_system).

The process topology of the twin: a main thread runs the frontend at camera
rate and a backend thread maintains the DWO graph; all cross-thread traffic
goes through the monitor mailboxes of pipeline.monitors.

Two execution modes:
- threaded=True : the backend runs in its own thread, its device work on its
  own CUDA stream (models.backend);
- threaded=False: synchronous stepping, deterministic: the solve budget is
  off and the drain blocks on the in-flight registration and solve.

Per-frame main loop (parity: stereo_slam.cpp:681-747):
  1. adopt the backend's neighborhood answer if it contains the actkey;
  2. process the frame through the frontend (synchronous or pipelined);
  3. queryNeighborhood(actkey) to the backend;
  4. push the finalized keyframe packets;
  5. collect closed-loop notifications.

Loop closure (the place recognizer) is not ported yet: the caller passes
``enable_loop_closure=False``, and ``True`` raises. Tracking failure is
surfaced to the caller (there is no relocalization without a place
recognizer).
"""

from __future__ import annotations

import threading
import time

import numpy as np

from scavislam_tpu_torch import resolve_device
from scavislam_tpu_torch.core.camera import StereoCamera
from scavislam_tpu_torch.core.lie import PoseRT, umeyama_sim3
from scavislam_tpu_torch.models.backend import Backend
from scavislam_tpu_torch.models.frontend import StereoFrontend
from scavislam_tpu_torch.pipeline.monitors import BackendMonitor
from scavislam_tpu_torch.utils.config import Config
from scavislam_tpu_torch.utils.perfmon import PerformanceMonitor

# the reference's 11 named stages (stereo_slam.cpp:174-184)
STAGES = (
    "drawing", "back end", "grab frame", "preprocess", "stereo",
    "dense tracking", "fast", "match", "process points", "drop keyframe",
    "dense point cloud",
)


class SlamSystem:
    def __init__(self, cam: StereoCamera, cfg: Config = None,
                 threaded: bool = False, enable_loop_closure: bool = True,
                 vocabulary=None, pipelined: bool = False,
                 pipeline_depth: int = None, pr_lossless: bool = False,
                 device=None):
        if enable_loop_closure:
            raise NotImplementedError(
                "enable_loop_closure=True: place recognition and loop closure "
                "are not ported yet (ROADMAP queue 1 item 4); pass "
                "enable_loop_closure=False")
        self.device = resolve_device(device)
        self.cfg = cfg or Config()
        self.cam = cam
        self.per_mon = PerformanceMonitor()
        for s in STAGES:
            self.per_mon.add(s)

        self.backend_monitor = BackendMonitor()
        self.place_monitor = None
        self.place_recognizer = None
        self.frontend = StereoFrontend(cam, self.cfg, device=self.device)
        self.frontend.per_mon = self.per_mon
        if pipeline_depth is not None:
            self.frontend.pipeline_depth = int(pipeline_depth)
        self.backend = Backend(cam, self.cfg, self.backend_monitor, None,
                               device=self.device)
        self.backend.per_mon = self.per_mon
        if not threaded:
            # unthreaded runs are deterministic: no wall-clock solve budget,
            # every dirty query solves, like the reference's per-query
            # optimize
            self.backend.MIN_SOLVE_PERIOD_S = 0.0
        self.threaded = threaded
        self._stop = threading.Event()
        self._threads = []
        self.trajectory = []  # (frame_id, PoseRT T_cw estimate)
        self.closed_loops = []
        self.tracking_ok = True
        self.lost = False
        self.relocalizations = 0
        self.pipelined = pipelined

        if threaded:
            t_be = threading.Thread(
                target=self.backend.run, args=(self._stop,), daemon=True
            )
            t_be.start()
            self._threads.append(t_be)

    # ------------------------------------------------------------------ #
    def process_first_frame(self, frame: dict):
        pkt = self.frontend.process_first_frame(frame)
        self.backend_monitor.pushKeyframe(pkt)
        if not self.threaded:
            self._drain_workers()
        self.trajectory.append(
            (frame.get("frame_id", 0), self.frontend._world_pose())
        )

    def process_frame(self, frame: dict) -> bool:
        """One main-loop iteration. Returns False on tracking failure."""
        pm = self.per_mon
        pm.new_frame()

        # neighborhood adoption (stereo_slam.cpp:694-703)
        nb = self.backend_monitor.getNeighborhood()
        if nb is not None:
            self.frontend.apply_neighborhood(nb)

        # the frame step's stages are one dispatch here; the dispatch and
        # consume are accounted under "dense tracking", its largest part
        pm.start("dense tracking")
        if self.pipelined:
            res = self.frontend.process_frame_pipelined(frame)
            if res is None:
                pm.stop("dense tracking")
                return True  # pipeline still filling; nothing consumed yet
            success, dropped, consumed_id = res
        else:
            success, dropped = self.frontend.process_frame(frame)
            consumed_id = frame.get("frame_id", len(self.trajectory))
        pm.stop("dense tracking")
        if not success:
            self.tracking_ok = False
            return False

        self.backend_monitor.queryNeighborhood(self.frontend.actkey_id)
        for pkt in self.frontend.take_ready_packets():
            self.backend_monitor.pushKeyframe(pkt)

        loop = self.backend_monitor.getClosedLoop()
        if loop is not None:
            self.closed_loops.append(loop)

        if not self.threaded:
            self._drain_workers()

        self.trajectory.append(
            (consumed_id, self.frontend._world_pose())
        )
        return True

    def _drain_workers(self):
        while True:
            if self.backend.step():
                continue
            # deterministic unthreaded semantics: BLOCK on in-flight async
            # work (registration fetch, solve fetch) instead of letting it
            # land on a later frame
            if self.backend._pending_reg is not None:
                self.backend._pending_reg[2].result()
                continue
            if self.backend.graph.solve_pending():
                self.backend.graph.finish_pending()
                continue
            break

    # ------------------------------------------------------------------ #
    def finish(self, timeout: float = 60.0):
        """Drain pending backend work after the last frame: without this, a
        threaded run that ends right after the last frame abandons queued
        keyframes."""
        self._flush_frontend()
        if not self.threaded:
            self._drain_workers()
        else:
            t0 = time.time()
            while time.time() - t0 < timeout:
                loop = self.backend_monitor.getClosedLoop()
                if loop is not None:
                    self.closed_loops.append(loop)
                    continue
                busy = (
                    len(self.backend_monitor.keyframes) > 0
                    or getattr(self.backend, "working", False)
                    or bool(self.backend.local_registration_stack)
                    or self.backend._pending_reg is not None
                    or self.backend.graph.solve_pending()
                )
                if not busy:
                    break
                time.sleep(0.005)
        # adopt any solve still in flight (the drain stops as soon as no
        # poll work remains, which can precede the fetch)
        self.backend.graph.finish_pending()
        loop = self.backend_monitor.getClosedLoop()
        while loop is not None:
            self.closed_loops.append(loop)
            loop = self.backend_monitor.getClosedLoop()

    def _flush_frontend(self):
        if self.pipelined and (len(self.frontend._pending) > 0
                               or self.frontend._pending_spawn is not None):
            for success, dropped, fid, pose, pkt in \
                    self.frontend.flush_pipeline():
                if not success:
                    self.tracking_ok = False
                    break
                if fid is not None:
                    self.trajectory.append((fid, pose))
            for pkt in self.frontend.take_ready_packets():
                self.backend_monitor.pushKeyframe(pkt)

    def shutdown(self):
        self._flush_frontend()
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5.0)

    def export_trajectory(self) -> np.ndarray:
        """(N, 7): frame_id, translation (3), rotation log (3)."""
        rows = []
        for fid, T in self.trajectory:
            xi = np.asarray(PoseRT.from_any(T).log())
            rows.append(np.concatenate([[fid], np.asarray(T.t), xi[3:]]))
        return np.asarray(rows)


def ate_rmse_aligned(trajectory, gt_poses, with_scale: bool = True) -> float:
    """ATE RMSE after a closed-form Sim3 (Umeyama) alignment of the camera
    centers; with_scale=False gives the SE3-aligned variant."""
    est, gt = [], []
    for (fid, T_est), T_gt in zip(trajectory, gt_poses):
        Te = PoseRT.from_any(T_est)
        Tg = PoseRT.from_any(T_gt)
        est.append(-Te.R.T @ Te.t)  # camera centers in world
        gt.append(-Tg.R.T @ Tg.t)
    est = np.stack(est)
    gt = np.stack(gt)
    s, R, t = umeyama_sim3(est, gt, with_scale=with_scale)
    resid = gt - (s * est @ R.T + t)
    return float(np.sqrt((resid ** 2).sum(axis=1).mean()))


def ate_rmse(trajectory, gt_poses) -> float:
    """Absolute trajectory error (translation RMSE), no alignment: both
    trajectories share the first-frame gauge. Host numpy."""
    errs = []
    for (fid, T_est), T_gt in zip(trajectory, gt_poses):
        e = PoseRT.from_any(T_est) @ PoseRT.from_any(T_gt).inverse()
        errs.append(e.t)
    errs = np.stack(errs)
    return float(np.sqrt((errs**2).sum(axis=1).mean()))
