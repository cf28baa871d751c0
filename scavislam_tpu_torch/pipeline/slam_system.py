"""Complete SLAM system: frontend + backend + place recognition (port of
scavislam_tpu.pipeline.slam_system).

The process topology of the twin (stereo_slam.cpp:164-216): a main thread
runs the frontend at camera rate, a backend thread maintains the DWO graph,
and a place-recognizer thread detects appearance loops; all cross-thread
traffic goes through the monitor mailboxes of pipeline.monitors.

Two execution modes:
- threaded=True : the backend and the place recognizer run in their own
  threads, each with its device work on its own CUDA stream;
- threaded=False: synchronous stepping, deterministic: the solve budget is
  off and the drain blocks on the in-flight registration and solve, then
  indexes every queued keyframe.

Per-frame main loop (parity: stereo_slam.cpp:681-747):
  1. adopt the backend's neighborhood answer if it contains the actkey;
  2. process the frame through the frontend (synchronous or pipelined);
  3. queryNeighborhood(actkey) to the backend;
  4. push the finalized keyframe packets;
  5. collect closed-loop notifications.

With loop closure on (the default) the frontend's keyframe spawn also
computes each keyframe's bag-of-words block (``pr_vocab``), the backend
forwards it to the recognizer, and loops it finds come back to the
backend's ``global_loop_closure``. A tracking failure then puts the system
in ``lost`` mode: each new frame is queried against the place index until a
geometric check re-seeds the pose (relocalization; the reference exits on
tracking failure). Without loop closure a tracking failure is surfaced to
the caller.
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
from scavislam_tpu_torch.models.placerec import PlaceRecognizer
from scavislam_tpu_torch.pipeline.monitors import (
    BackendMonitor,
    PlaceRecognizerMonitor,
)
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
        # pr_lossless: feed EVERY keyframe to place recognition through a
        # FIFO instead of the reference's newest-only/refusing mailbox
        # (placerecognizer.cpp:36-63), so that which keyframes get indexed
        # does not depend on thread scheduling (benchmarks, offline runs)
        self.device = resolve_device(device)
        self.cfg = cfg or Config()
        self.cam = cam
        self.per_mon = PerformanceMonitor()
        for s in STAGES:
            self.per_mon.add(s)

        self.backend_monitor = BackendMonitor()
        self.place_monitor = (
            PlaceRecognizerMonitor(lossless=pr_lossless)
            if enable_loop_closure else None
        )
        self.frontend = StereoFrontend(cam, self.cfg, device=self.device)
        self.frontend.per_mon = self.per_mon
        if pipeline_depth is not None:
            self.frontend.pipeline_depth = int(pipeline_depth)
        self.backend = Backend(cam, self.cfg, self.backend_monitor,
                               self.place_monitor, device=self.device)
        self.backend.per_mon = self.per_mon
        if not threaded:
            # unthreaded runs are deterministic: no wall-clock solve budget,
            # every dirty query solves, like the reference's per-query
            # optimize
            self.backend.MIN_SOLVE_PERIOD_S = 0.0
        self.place_recognizer = (
            PlaceRecognizer(cam, vocabulary, self.place_monitor,
                            device=self.device)
            if enable_loop_closure else None
        )
        if self.place_recognizer is not None:
            # the keyframe spawn computes the BoW block and it rides home in
            # the spawn payload: the PR thread does no per-keyframe device
            # work
            self.frontend.pr_vocab = self.place_recognizer.vocab
        self.threaded = threaded
        self._stop = threading.Event()
        self._threads = []
        self.trajectory = []  # (frame_id, PoseRT T_cw estimate)
        self.closed_loops = []
        self.tracking_ok = True
        # relocalization: with a place recognizer, a tracking failure puts
        # the system in `lost` mode until a frame relocalizes;
        # relocalizations counts the recoveries
        self.lost = False
        self.relocalizations = 0
        self.pipelined = pipelined

        if threaded:
            t_be = threading.Thread(
                target=self.backend.run, args=(self._stop,), daemon=True
            )
            t_be.start()
            self._threads.append(t_be)
            if self.place_recognizer is not None:
                t_pr = threading.Thread(
                    target=self.place_recognizer.run, args=(self._stop,),
                    daemon=True,
                )
                t_pr.start()
                self._threads.append(t_pr)

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
        """One main-loop iteration. Returns False on tracking failure
        (unrecoverable: no place recognizer; with one the system stays alive
        in `lost` mode)."""
        pm = self.per_mon
        pm.new_frame()

        if self.lost:
            if self._try_relocalize(frame):
                self.lost = False
                self.tracking_ok = True
                self.relocalizations += 1
            return True  # stay alive; keep consuming frames while lost

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
            if self.place_recognizer is not None:
                self.lost = True
                # drop the stale in-flight frames: relocalization restarts
                # the chain from scratch
                self.frontend._pending.clear()
                return True
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

    def _try_relocalize(self, frame: dict) -> bool:
        """Kidnapped-robot recovery: run the frame step for this frame's
        pyramid + disparity (its pose output is discarded), query the place
        index with no covisibility exclusions, and on a passed geometric
        check re-seed the frontend at T_query_from_loop * T_loop_from_world.
        Runs on the frame thread."""
        fe = self.frontend
        cand = np.full((len(fe._collect_candidates()),), -1, np.int64)
        out = fe._run_step(frame, cand)
        hit = self.place_recognizer.relocalize(out.pyr[0], out.disp)
        if hit is None:
            return False
        loop_id, (R_ql, t_ql) = hit
        # the loop keyframe's world pose: prefer the backend-optimized graph
        g = self.backend.graph
        if loop_id in g.vertices:
            R_lw = np.asarray(g.vertices[loop_id].R, np.float32)
            t_lw = np.asarray(g.vertices[loop_id].t, np.float32)
        elif loop_id in fe.pose_np:
            R_lw, t_lw = fe.pose_np[loop_id]
        else:
            return False
        R_qw = (R_ql @ R_lw).astype(np.float32)
        t_qw = (R_ql @ t_lw + t_ql).astype(np.float32)
        fe.reseed(R_qw, t_qw, actkey_id=loop_id)
        # the step's rolled cloud state anchors dense tracking at THIS
        # frame, so the next frame tracks normally from the recovered pose
        fe._roll(out)
        self.trajectory.append(
            (frame.get("frame_id", len(self.trajectory)), fe._world_pose()))
        return True

    def _drain_workers(self):
        def drain_backend():
            while True:
                if self.backend.step():
                    continue
                # deterministic unthreaded semantics: BLOCK on in-flight
                # async work (registration fetch, solve fetch) instead of
                # letting it land on a later frame
                spans = self.frontend.spans
                if self.backend._pending_reg is not None:
                    fut = self.backend._pending_reg[2]
                    if not fut.done():
                        spans.sync("drain.registration")
                    fut.result()
                    continue
                if self.backend.graph.solve_pending():
                    if not self.backend.graph.solve_ready():
                        spans.sync("drain.solve")
                    self.backend.graph.finish_pending()
                    continue
                break

        drain_backend()
        if self.place_recognizer is not None:
            while self.place_recognizer.step():
                pass
            # loops found by the recognizer need one more backend pass
            drain_backend()

    # ------------------------------------------------------------------ #
    def finish(self, timeout: float = 60.0):
        """Drain pending backend / place-recognition work after the last
        frame: without this, a threaded run that ends right after the last
        frame abandons queued keyframes, and any loop closure they would
        have produced."""
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
                    or (self.place_monitor is not None
                        and (self.place_monitor.pending()
                             or self.place_recognizer.working))
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
