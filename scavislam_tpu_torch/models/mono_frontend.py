"""Monocular front-end: host orchestrator over the mono frame step (port of
scavislam_tpu.models.mono_frontend).

The reference scaffolds a monocular mode behind ``#ifdef MONO`` (Sim3
types, anchored_points.h:180-218; uv prediction models,
transformations.h:623-660; the information-filter point initializer,
pose_optimizer.h:300-422) and ships no mono frontend; the twin enables it,
and this is its port. As the stereo frontend: one frame step per frame
(models.mono_step.mono_step), one spawn step per new keyframe
(spawn_points_mono), the host does scalar policy only.

Differences from the stereo frontend, by the sensor:
- no dense tracking (it needs per-pixel depth): guided matching searches
  around the PREVIOUS pose's predictions;
- every candidate carries an information matrix; depth converges with
  parallax through the batched RSS'10 filter inside the frame step;
- scale is gauged by the spawn-time inverse-depth prior: evaluate with the
  Sim3-aligned ATE (pipeline.slam_system.ate_rmse_aligned).

Per frame the host uploads the image (unless the frame carries it on the
device: ``left_dev``, or ``stacked_dev`` whose plane 0 is taken) and the
candidate ids when they change, and downloads one packed vector through a
:class:`~scavislam_tpu_torch.models.frontend.Fetch` (a pinned copy behind a
CUDA event). Pipelined, the policy runs ``pipeline_depth`` frames behind
the dispatch; the device pose chain advances without the host.

Window BA (``window_ba``): the last-K window or, with ``dwo=True``, the
covisibility double window with frozen marginalized relative-pose
constraints, solved by ``ba_solver.solve_ba`` with the disparity residual
zero-weighted. Synchronous, or dispatched and adopted at a later frame
boundary (``adopt_pending_ba``); a map re-gauge in between discards it.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from scavislam_tpu_torch import resolve_device
from scavislam_tpu_torch.core.camera import StereoCamera
from scavislam_tpu_torch.core.lie import SE3, PoseRT
from scavislam_tpu_torch.models.ba_solver import BAProblem, solve_ba
from scavislam_tpu_torch.models.frontend import Fetch
from scavislam_tpu_torch.models.frontend_step import (
    level_sections,
    normalize_frames,
)
from scavislam_tpu_torch.models.map_store import (
    MAX_KEYFRAMES,
    MAX_POINTS,
    PointTable,
    PoseTable,
    scatter_psi,
)
from scavislam_tpu_torch.models.mono_step import mono_step, spawn_points_mono
from scavislam_tpu_torch.ops.image import build_pyramid
from scavislam_tpu_torch.utils.config import Config

CAND_CAP = 512
NEW_PER_LEVEL = (192, 64, 32)
TRACKED_CAP = 512
MIN_TRACK_OBS = 15


def _solve_mono_window(cam_params, prob: BAProblem, iters: int):
    """The mono window solve: the stereo DWO Schur solver with the
    disparity residual row zero-weighted (uv-only observations)."""
    return solve_ba(cam_params, prob, iters=iters,
                    disp_info=torch.zeros_like(prob.obs_weight))


class MonoFrontend:
    """Feature-based monocular VO with filter-initialized inverse depth.

    The keyframe policy mirrors the stereo rules (stereo_frontend.cpp:
    512-528) with the translation threshold in prior-scale units."""

    def __init__(self, cam: StereoCamera, cfg: Config = None, *,
                 prior_idepth: float = 0.25, conv_q_info: float = 25.0,
                 prior_weight: float = 0.05, device=None):
        self.cfg = cfg or Config()
        self.device = resolve_device(device)
        self.cam = cam
        self.levels = self.cfg.use_n_levels_in_frontent
        self.cams = [cam.scale_level(l) for l in range(self.levels)]
        self._cam_params = tuple(
            (c.focal, c.pp[0], c.pp[1]) for c in self.cams)
        self._cam_statics = tuple(c.size for c in self.cams)
        self.prior_idepth = float(prior_idepth)
        self.conv_q_info = float(conv_q_info)
        self.prior_weight = float(prior_weight)
        # device scalars made once (device fills, no per-frame upload)
        dev = self.device
        self._conv_dev = torch.full((), self.conv_q_info, dtype=torch.float32,
                                    device=dev)
        self._pw_dev = torch.full((), self.prior_weight, dtype=torch.float32,
                                  device=dev)
        self._actkey_cache = None

        self.poses = PoseTable.empty(device=dev)
        self.points = PointTable.empty(device=dev)
        self.Lam = torch.zeros((MAX_POINTS, 3, 3), dtype=torch.float32,
                               device=dev)

        self.next_kf = 0
        self.next_point = 0
        self.kf_point_ids: dict[int, np.ndarray] = {}
        # per-keyframe observations for the window BA: point ids and the
        # level-0 uv each was (re-)observed at when the keyframe was made
        # (tracked survivors) or spawned (anchor observations)
        self.kf_obs: dict[int, tuple] = {}
        self.covis: dict[int, dict[int, int]] = {}
        self.pose_np: dict[int, tuple] = {}
        self.actkey_id = -1
        self.frame_id = -1
        self.trajectory: list = []

        self._meta_anchor = np.full(MAX_POINTS, -1, np.int64)
        self._meta_level = np.zeros(MAX_POINTS, np.int64)

        self._R_cw = np.eye(3, dtype=np.float32)
        self._t_cw = np.zeros(3, np.float32)
        self._dev_R_cw = None
        self._dev_t_cw = None
        self._cand_np = None
        self._cand_dev = None
        self._tracked_ids = np.zeros(0, np.int64)
        self._tracked_uv = np.zeros((0, 2), np.float32)
        self.last_lam_qq = np.zeros(0, np.float32)
        self.last_pyr = None
        self.last_kf_img = None

        # pipelined mode: frames in flight, each a list [frame_id,
        # cand_ids, MonoStepOut, Fetch, kf_epoch, correction or None]
        self.pipeline_depth = 2
        self._pending = deque()
        self._pending_ba = None  # in-flight async window solve
        self._map_gen = 0  # bumped on re-gauge; stale solves discarded
        self.last_ba_chi2 = None
        self._kf_epoch = 0
        # frozen marginalized relative-pose constraints (mono DWO):
        # (a, b) a<b -> (R_b_from_a, t_b_from_a, Lambda 6x6), made when a
        # covis edge leaves the inner window, dropped when both ends
        # re-enter it or the map re-gauges
        self.edge_constraints: dict = {}

    # -- helpers ----------------------------------------------------------- #
    def _world_pose(self) -> PoseRT:
        return PoseRT(self._R_cw.astype(np.float64).copy(),
                      self._t_cw.astype(np.float64).copy())

    def _actkey_dev(self):
        key = max(self.actkey_id, 0)
        cached = self._actkey_cache
        if cached is None or cached[0] != key:
            cached = (key, torch.full((), key, dtype=torch.int64,
                                      device=self.device))
            self._actkey_cache = cached
        return cached[1]

    def _cand_device(self, cand_ids):
        if self._cand_np is None or not np.array_equal(self._cand_np,
                                                       cand_ids):
            self._cand_np = cand_ids.copy()
            self._cand_dev = torch.as_tensor(cand_ids.astype(np.int32),
                                             device=self.device)
        return self._cand_dev

    def _collect_candidates(self) -> np.ndarray:
        lists = []
        if self.actkey_id in self.kf_point_ids:
            lists.append(self.kf_point_ids[self.actkey_id])
        for nbr in sorted(self.covis.get(self.actkey_id, {}),
                          key=lambda k: -self.covis[self.actkey_id][k]):
            lists.append(self.kf_point_ids.get(nbr, np.zeros(0, np.int64)))
        ids = (np.unique(np.concatenate(lists)) if lists
               else np.zeros(0, np.int64))
        out = np.full((CAND_CAP,), -1, np.int64)
        if len(ids):
            lv = self._meta_level[np.clip(ids, 0, MAX_POINTS - 1)]
            off = 0
            for l, cap in enumerate(level_sections(self.levels, CAND_CAP)):
                sel = ids[lv == l][:cap]
                out[off:off + len(sel)] = sel
                off += cap
        return out

    def _pose_dev(self):
        R = (self._dev_R_cw if self._dev_R_cw is not None
             else torch.as_tensor(self._R_cw, dtype=torch.float32,
                                  device=self.device))
        t = (self._dev_t_cw if self._dev_t_cw is not None
             else torch.as_tensor(self._t_cw, dtype=torch.float32,
                                  device=self.device))
        return R, t

    def _image_dev(self, frame):
        """The frame's left plane on this frontend's device: `left_dev`
        (prefetched by the IO layer), plane 0 of `stacked_dev`, or `left`
        uploaded. A prefetched plane is ordered after its upload event and
        recorded on the current stream for the allocator."""
        for key in ("left_dev", "stacked_dev"):
            if key in frame:
                x = frame[key]
                if x.is_cuda:
                    stream = torch.cuda.current_stream(x.device)
                    if frame.get("upload_event") is not None:
                        stream.wait_event(frame["upload_event"])
                    x.record_stream(stream)
                x = x.to(self.device)
                return x if key == "left_dev" else x[0]
        left = frame["left"]
        if isinstance(left, torch.Tensor):
            return left.to(self.device)
        return torch.as_tensor(np.asarray(left), device=self.device)

    # -- frame processing --------------------------------------------------- #
    def _run_step(self, frame, cand_ids):
        R_cw, t_cw = self._pose_dev()
        out = mono_step(
            self._image_dev(frame), R_cw, t_cw, self._actkey_dev(),
            self.poses, self.points, self.Lam, self._cand_device(cand_ids),
            self._conv_dev, self._pw_dev, self._cam_params,
            self._cam_statics, self.levels,
            float(self.cfg.ui.max_reproj_error), 0.18)
        self.points = out.points
        self.Lam = out.Lam
        self._dev_R_cw = out.R_cw
        self._dev_t_cw = out.t_cw
        self.last_pyr = out.pyr
        return out

    def process_first_frame(self, frame: dict):
        self.frame_id = frame.get("frame_id", 0)
        kf_id = self._new_keyframe_id()
        T_kw = PoseRT.from_any(frame["T_cw_init"]) if "T_cw_init" in frame \
            else PoseRT(np.eye(3), np.zeros(3))
        R_kw = np.asarray(T_kw.R, np.float32)
        t_kw = np.asarray(T_kw.t, np.float32)
        self.poses = self.poses.set(kf_id, SE3(torch.as_tensor(R_kw),
                                               torch.as_tensor(t_kw)))
        self.pose_np[kf_id] = (R_kw.copy(), t_kw.copy())
        self.actkey_id = kf_id
        self._R_cw, self._t_cw = R_kw.copy(), t_kw.copy()
        self.covis[kf_id] = {}

        # the pyramid of the (f32) left image, for spawning only
        left = frame["left"] if "left" in frame else self._image_dev(frame)
        if not isinstance(left, torch.Tensor):
            left = torch.as_tensor(np.asarray(left))
        img = normalize_frames(left.to(self.device)).to(torch.float32)
        self._spawn(build_pyramid(img, self.levels), kf_id, None)
        self.trajectory.append((self.frame_id, self._world_pose()))

    def process_frame(self, frame: dict):
        """Track one frame synchronously. Returns (success, dropped)."""
        # adopt BEFORE dispatch: the step seeds from the adopted chain
        self.adopt_pending_ba()
        self.frame_id = frame.get("frame_id", self.frame_id + 1)
        cand_ids = self._collect_candidates()
        out = self._run_step(frame, cand_ids)
        return self._consume(self.frame_id, cand_ids, out,
                             Fetch(out.packed).result(), self._kf_epoch)

    def process_frame_pipelined(self, frame: dict):
        """Dispatch this frame; consume the one dispatched `pipeline_depth`
        frames ago (its packed download has been in flight behind the later
        frames' device work). Returns (success, dropped, consumed_frame_id)
        or None while filling."""
        # adopt BEFORE dispatch: frames already in flight get a pose
        # correction attached; this frame dispatches against the adopted
        # chain
        self.adopt_pending_ba()
        self.frame_id = frame.get("frame_id", self.frame_id + 1)
        cand_ids = self._collect_candidates()
        out = self._run_step(frame, cand_ids)
        self._pending.append([self.frame_id, cand_ids, out, Fetch(out.packed),
                              self._kf_epoch, None])
        if len(self._pending) <= max(1, self.pipeline_depth):
            return None
        fid, cand_ids, out, fut, epoch, corr = self._pending.popleft()
        ok, dropped = self._consume(fid, cand_ids, out, fut.result(), epoch,
                                    corr)
        return ok, dropped, fid

    def flush_pipeline(self):
        """Consume all in-flight frames (end of sequence), stopping at the
        first failure. Returns [(success, dropped, frame_id)]."""
        results = []
        while self._pending:
            fid, cand_ids, out, fut, epoch, corr = self._pending.popleft()
            ok, dropped = self._consume(fid, cand_ids, out, fut.result(),
                                        epoch, corr)
            results.append((ok, dropped, fid))
            if not ok:
                self._pending.clear()
                break
        return results

    def _consume(self, frame_id, cand_ids, out, pk, epoch, corr=None):
        C = CAND_CAP
        R_cw = pk[0:9].reshape(3, 3)
        t_cw = pk[9:12]
        if corr is not None:
            # dispatched before an async window-BA adoption: the chain's
            # right-multiplicative actkey correction
            # (T_cw' = T_cw_packet @ T_akw_old^-1 T_akw_new)
            R_c, t_c = corr
            t_cw = R_cw @ t_c + t_cw
            R_cw = R_cw @ R_c
        n_matched, n_gated, n_conv, t_norm, mean_track_len = pk[24:29]
        quad_counts = pk[30:34]
        gate = pk[34:34 + C] > 0.5
        obs_uv = pk[34 + 2 * C: 34 + 4 * C].reshape(C, 2)
        self.last_lam_qq = pk[34 + 4 * C: 34 + 5 * C]

        if int(n_gated) < MIN_TRACK_OBS or not np.isfinite(t_cw).all():
            if epoch != self._kf_epoch:
                # dispatched before the latest keyframe spawn: a transient
                # skip, not a tracking loss
                return True, False
            return False, False
        self._R_cw = R_cw.astype(np.float32)
        self._t_cw = t_cw.astype(np.float32)
        self._tracked_ids = cand_ids[gate]
        self._tracked_uv = obs_uv[gate]
        self.trajectory.append((frame_id, self._world_pose()))

        # keyframe decisions (switch and spawn) only on current-epoch
        # frames: stale-epoch statistics re-trigger the conditions the last
        # decision fixed
        dropped = False
        switched = (epoch == self._kf_epoch
                    and self._maybe_switch_keyframe(float(t_norm)))
        if (not switched and epoch == self._kf_epoch
                and self._shall_drop_keyframe(
                    quad_counts, float(t_norm), float(mean_track_len))):
            self._add_new_keyframe(out)
            dropped = True
        return True, dropped

    def _maybe_switch_keyframe(self, t_norm: float) -> bool:
        """Re-target the active keyframe when a covisible keyframe is closer
        than 0.5 * parallax_thr and shares > 100 tracked features
        (shallWeSwitchKeyframe, stereo_frontend.cpp:445-510)."""
        ids = self._tracked_ids
        if len(ids) == 0 or self.actkey_id < 0:
            return False
        anch = self._meta_anchor[np.clip(ids, 0, MAX_POINTS - 1)]
        best = None
        for nbr in self.covis.get(self.actkey_id, {}):
            shared = int((anch == nbr).sum())
            if shared <= 100 or nbr not in self.pose_np:
                continue
            Rn, tn = self.pose_np[nbr]
            R_cn = self._R_cw @ Rn.T
            d = float(np.linalg.norm(self._t_cw - R_cn @ tn))
            if d < 0.5 * self.cfg.ui.parallax_thr and d < t_norm:
                if best is None or d < best[1]:
                    best = (nbr, d)
        if best is None:
            return False
        self.actkey_id = best[0]
        self._actkey_cache = None
        self._cand_np = None
        # in-flight frames' statistics refer to the OLD actkey
        self._kf_epoch += 1
        return True

    def relocalize(self, place_recognizer, frame) -> bool:
        """Lost-mode recovery: BoW-query the keyframe index with no
        covisibility exclusions, re-seed the pose at the best-scoring
        keyframe and confirm by running the frame step (guided matching
        against that keyframe's map + uv motion BA either passes the
        tracking floor or the attempt is rejected). A failed confirm
        restores the tables and the pose it started from. Returns True on
        recovery."""
        left = frame["left"]
        img = (left if isinstance(left, torch.Tensor)
               else np.asarray(left, np.float32))
        words, _desc, _uvd, _xyz, valid = place_recognizer.describe(img, None)
        scores = place_recognizer._score(words[valid], exclude=set())
        if not scores:
            return False
        best = max(scores, key=scores.get)
        if best not in self.pose_np:
            return False
        self.invalidate_pending_ba()
        Rk, tk = self.pose_np[best]
        # the tables are never written in place, so references are
        # snapshots: a failed confirm must not keep the wrong-pose filter
        # updates the frame step made
        snap = (self.points, self.Lam, self._R_cw.copy(), self._t_cw.copy(),
                self.actkey_id)
        self._R_cw, self._t_cw = Rk.copy(), tk.copy()
        self._dev_R_cw = None
        self._dev_t_cw = None
        self.actkey_id = best
        self._actkey_cache = None
        self._cand_np = None
        self._pending.clear()
        ok, _ = self.process_frame(frame)
        if not ok:
            (self.points, self.Lam, self._R_cw, self._t_cw,
             self.actkey_id) = snap
            self._dev_R_cw = None
            self._dev_t_cw = None
            self._actkey_cache = None
            self._cand_np = None
        return ok

    # -- keyframe policy ----------------------------------------------------- #
    def _shall_drop_keyframe(self, quad_counts, t_norm, mean_track_len):
        cfg = self.cfg
        featureless = int(
            (np.asarray(quad_counts) < cfg.ui.min_num_points).sum())
        if featureless >= cfg.frontend.new_keyframe_featureless_corners_thr:
            return True
        if t_norm > cfg.ui.parallax_thr:
            return True
        if mean_track_len > cfg.frontend.new_keyframe_pixel_thr:
            return True
        return False

    def _new_keyframe_id(self) -> int:
        kf = self.next_kf
        assert kf < MAX_KEYFRAMES, "keyframe table full"
        self.next_kf += 1
        return kf

    def _spawn(self, pyr, kf_id: int, tracked_uv):
        caps = NEW_PER_LEVEL[: self.levels]
        total = sum(caps)
        if self.next_point + total > MAX_POINTS:
            self.next_point = 0
        starts = []
        for cap in caps:
            starts.append(self.next_point)
            self.next_point += cap

        t_uv0 = np.zeros((TRACKED_CAP, 2), np.float32)
        t_val = np.zeros(TRACKED_CAP, bool)
        if tracked_uv is not None and len(tracked_uv) > 0:
            n = min(len(tracked_uv), TRACKED_CAP)
            t_uv0[:n] = tracked_uv[:n]
            t_val[:n] = True

        self.points, self.Lam, payloads = spawn_points_mono(
            pyr, torch.as_tensor(t_uv0, device=self.device),
            torch.as_tensor(t_val, device=self.device),
            self.points, self.Lam, starts, kf_id, self.prior_idepth,
            self._cam_params, self._cam_statics, self.levels, tuple(caps),
            float(self.cfg.frontend.newpoint_clearance))
        pk = Fetch(payloads).result()
        all_ids, all_uv = [], []
        off = 0
        for l, cap in enumerate(caps):
            off += cap * 3  # psi
            uv0 = pk[off: off + cap * 2].reshape(cap, 2)
            off += cap * 2
            ok = pk[off: off + cap] > 0.5
            off += cap
            ids = np.arange(starts[l], starts[l] + cap, dtype=np.int64)
            self._meta_anchor[ids] = kf_id
            self._meta_level[ids] = l
            self._meta_anchor[ids[~ok]] = -1
            all_ids.append(ids[ok])
            all_uv.append(uv0[ok])
        self.kf_point_ids[kf_id] = np.concatenate(all_ids)
        # anchor observations (each new point seen at uv0 in its keyframe)
        self._append_obs(kf_id, np.concatenate(all_ids),
                         np.concatenate(all_uv).astype(np.float32))
        self._cand_np = None

    def _append_obs(self, kf_id, ids, uv):
        prev = self.kf_obs.get(kf_id)
        if prev is not None:
            ids = np.concatenate([prev[0], ids])
            uv = np.concatenate([prev[1], uv])
        self.kf_obs[kf_id] = (ids, uv)

    def _add_new_keyframe(self, out):
        # the new keyframe's pose must chain from ADOPTED state
        self.adopt_pending_ba(force=True)
        self._kf_epoch += 1
        # the keyframe's level-0 image on the device, for loop-detection
        # indexing later (pipelined, the spawn frame is pipeline_depth
        # frames behind the caller's frame)
        self.last_kf_img = out.pyr[0]
        kf_id = self._new_keyframe_id()
        self.poses = self.poses.set(kf_id, SE3(torch.as_tensor(self._R_cw),
                                               torch.as_tensor(self._t_cw)))
        self.pose_np[kf_id] = (self._R_cw.copy(), self._t_cw.copy())

        anch = self._meta_anchor[np.clip(self._tracked_ids, 0,
                                         MAX_POINTS - 1)]
        strengths = {}
        for a, c in zip(*np.unique(anch, return_counts=True)):
            if int(a) >= 0 and int(c) >= self.cfg.frontend.covis_thr:
                strengths[int(a)] = int(c)
        self.covis[kf_id] = dict(strengths)
        for a, s in strengths.items():
            self.covis.setdefault(a, {})[kf_id] = s

        # tracked survivors are OBSERVATIONS of this keyframe (the window
        # BA links the new pose to older anchors through them)
        self._append_obs(kf_id, self._tracked_ids.copy(),
                         self._tracked_uv.copy().astype(np.float32))
        # new candidates fill the cells the tracked points leave uncovered
        self._spawn(out.pyr, kf_id, self._tracked_uv)
        # this keyframe's candidate list: its spawns + the tracked
        # survivors (which stay owned by their anchors)
        self.kf_point_ids[kf_id] = np.concatenate(
            [self.kf_point_ids[kf_id], self._tracked_ids])
        self.actkey_id = kf_id
        self._cand_np = None

    # -- mono window BA ------------------------------------------------------ #
    # the window problem's fixed capacities (poses, points, observations)
    BA_CAPS = (8, 1024, 3072)
    # the double window: poses, points, observations, relative-pose edges
    DWO_CAPS = (24, 1024, 3072, 96)

    def window_ba(self, window: int = 5, iters: int = 4,
                  sync: bool = True, dwo: bool = False, outer: int = 16):
        """Joint pose + structure refinement over the last `window`
        keyframes: anchored inverse-depth ternary factors with uv-only
        observations through the stereo DWO's Schur solver (the third
        residual zero-weighted; the reference's mono scaffold's ObsDim=2,
        slam_graph-impl.cpp:128-249). The oldest window pose is the gauge.

        sync=True solves and writes back at once and returns
        (chi2_initial, chi2_final), or None when the window is degenerate.
        sync=False enqueues the solve, starts its packed download and
        returns "dispatched"; ``adopt_pending_ba`` applies it at a later
        frame boundary, unless the map re-gauged in between.

        With dwo=True the window is the covisibility DOUBLE window:
        `window` INNER keyframes (strongest-covisibility BFS from the
        actkey) get full point BA, up to `outer` OUTER keyframes are pose
        vertices held by marginalized relative-pose constraints frozen
        when their edges left the inner window (slam_graph.cpp:555-663)."""
        self.adopt_pending_ba(force=True)
        meta = (self._assemble_window_dwo(window, outer) if dwo
                else self._assemble_window(window))
        if meta is None:
            return None
        cam0 = self.cams[0]
        R_out, t_out, psi_out, stats = _solve_mono_window(
            (cam0.focal, cam0.pp[0], cam0.pp[1], cam0.baseline),
            meta["prob"], iters)
        packed = torch.cat([
            R_out.reshape(-1), t_out.reshape(-1),
            torch.stack([stats.chi2_initial, stats.chi2_final]),
        ])
        meta["psi_out"] = psi_out
        meta["gen"] = self._map_gen
        if sync:
            self._writeback_window(meta, Fetch(packed).result())
            return self.last_ba_chi2
        meta["fut"] = Fetch(packed)
        self._pending_ba = meta
        return "dispatched"

    def adopt_pending_ba(self, force: bool = False) -> bool:
        """Apply a landed async window solve (wait for it with force);
        discard it when the map generation moved since its dispatch. Called
        at every frame and before any graph-mutating op, so asynchrony
        never reorders map updates."""
        pb = self._pending_ba
        if pb is None:
            return False
        if not force and not pb["fut"].done():
            return False
        self._pending_ba = None
        packed = pb["fut"].result()
        if pb["gen"] != self._map_gen:
            return False  # stale across a loop closure / relocalization
        self._writeback_window(pb, packed)
        return True

    def invalidate_pending_ba(self):
        """The map gauge changed (loop-closure re-gauge, relocalization):
        an in-flight window solve no longer applies, and the frozen
        constraints (relative poses from pre-gauge estimates) are dropped
        (re-frozen from post-gauge estimates when an edge next leaves the
        inner window)."""
        self._map_gen += 1
        self._pending_ba = None
        self.edge_constraints.clear()

    def _assemble_window(self, window: int):
        """The problem over the LAST `window` keyframes (sliding window),
        as a meta dict (problem + index maps), or None when degenerate."""
        kf_ids = sorted(self.pose_np.keys())[-window:]
        return self._assemble_core(kf_ids, anchor_set=set(kf_ids),
                                   caps=self.BA_CAPS + (1,), edges=[])

    # -- mono DWO: covisibility double window + marginalized constraints -- #
    def _compute_double_window(self, root: int, inner_n: int, outer_n: int):
        """BFS from the root by covisibility, strongest links first: the
        first `inner_n` reached are INNER, the next `outer_n` OUTER
        (slam_graph.cpp:555-596 on the mono covisibility graph)."""
        order, seen = [], set()
        q = deque([root])
        while q and len(order) < inner_n + outer_n:
            v = q.popleft()
            if v in seen or v not in self.pose_np:
                continue
            seen.add(v)
            order.append(v)
            for nbr in sorted(self.covis.get(v, {}),
                              key=lambda k: -self.covis[v][k]):
                if nbr not in seen:
                    q.append(nbr)
        return order[:inner_n], order[inner_n:]

    def _freeze_constraint(self, a: int, b: int):
        """Marginalized relative-pose constraint T_b_from_a with the
        heuristic information of computeConstraint (slam_graph.cpp:785-846:
        strength * diag((350 |t| / depth)^2 I3, 100^2 I3)), frozen from the
        current estimates; the depth unit is the mono prior depth
        1 / prior_idepth (the scale gauge)."""
        Ra, ta = self.pose_np[a]
        Rb, tb = self.pose_np[b]
        R_ba = (Rb @ Ra.T).astype(np.float32)
        t_ba = (tb - R_ba @ ta).astype(np.float32)
        strength = max(self.covis.get(a, {}).get(b, 1), 1)
        med_depth = 1.0 / self.prior_idepth
        norm_dist = float(np.linalg.norm(t_ba)) / med_depth
        Lam = np.eye(6, dtype=np.float32) * float(strength)
        Lam[:3, :3] *= (350.0 * norm_dist) ** 2
        Lam[3:, 3:] *= 100.0 ** 2
        return R_ba, t_ba, Lam

    def _assemble_window_dwo(self, inner_n: int, outer_n: int):
        """Double-window assembly: INNER keyframes own the active points
        (full BA); OUTER keyframes are pose vertices held by the frozen
        constraints. Edges fully inside the inner window are un-marginalized
        (slam_graph.cpp:728-759)."""
        if self.actkey_id < 0 or len(self.pose_np) < 2:
            return None
        inner, outer_kfs = self._compute_double_window(
            self.actkey_id, inner_n, outer_n)
        P_cap, L_cap, O_cap, E_cap = self.DWO_CAPS
        # clamp to the pose cap BEFORE building edges (_assemble_core keeps
        # kf_ids[:P_cap]; an edge to a dropped keyframe has no slot)
        kf_ids = (inner + outer_kfs)[:P_cap]
        if len(kf_ids) < 2:
            return None
        inner_set = set(inner[:P_cap])
        in_window = set(kf_ids)
        edges = []
        for a in kf_ids:
            for b, s in self.covis.get(a, {}).items():
                if b <= a or b not in in_window:
                    continue
                if s < self.cfg.frontend.covis_thr:
                    continue
                if a in inner_set and b in inner_set:
                    # un-marginalize: both ends re-entered the inner window
                    self.edge_constraints.pop((a, b), None)
                    continue
                c = self.edge_constraints.get((a, b))
                if c is None:
                    c = self._freeze_constraint(a, b)
                    self.edge_constraints[(a, b)] = c
                edges.append((a, b) + c)
        return self._assemble_core(
            kf_ids, anchor_set=inner_set,
            caps=(P_cap, L_cap, O_cap, E_cap), edges=edges[:E_cap])

    def _assemble_core(self, kf_ids, anchor_set, caps, edges):
        """The problem: poses + anchored points + uv observations (+
        relative-pose edges). Points anchored in `anchor_set` and observed
        by >= 2 window keyframes are free structure."""
        if len(kf_ids) < 2:
            return None
        P_cap, L_cap, O_cap, E_cap = caps
        kf_ids = kf_ids[:P_cap]
        slot = {k: i for i, k in enumerate(kf_ids)}

        counts: dict[int, int] = {}
        for k in kf_ids:
            ids, _uv = self.kf_obs.get(k, (np.zeros(0, np.int64), None))
            for pid in ids:
                counts[int(pid)] = counts.get(int(pid), 0) + 1
        pts = [p for p, c in sorted(counts.items())
               if c >= 2 and self._meta_anchor[p] in slot
               and int(self._meta_anchor[p]) in anchor_set][:L_cap]
        if not pts:
            return None
        lidx = {p: i for i, p in enumerate(pts)}

        Rs = np.zeros((P_cap, 3, 3), np.float32)
        Rs[:] = np.eye(3)
        ts = np.zeros((P_cap, 3), np.float32)
        pv = np.zeros(P_cap, bool)
        pf = np.zeros(P_cap, bool)
        for k, i in slot.items():
            Rs[i], ts[i] = self.pose_np[k]
            pv[i] = True
        pf[slot[min(kf_ids)]] = True  # gauge: the oldest window keyframe

        # psi gathered on the device (no download of the point table)
        anchor = np.array(
            [slot[int(self._meta_anchor[p])] for p in pts], np.int32)
        pids_pad = np.zeros(L_cap, np.int64)
        pids_pad[: len(pts)] = pts
        dev = self.device
        psi_pad = self.points.psi[torch.as_tensor(pids_pad, device=dev)]
        anch_pad = np.zeros(L_cap, np.int32)
        anch_pad[: len(pts)] = anchor
        lval = np.zeros(L_cap, bool)
        lval[: len(pts)] = True

        o_pose, o_point, o_uv, o_w = [], [], [], []
        for k in kf_ids:
            ids, uv = self.kf_obs.get(k, (np.zeros(0, np.int64), None))
            for pid, xy in zip(ids, uv):
                li = lidx.get(int(pid))
                if li is None:
                    continue
                o_pose.append(slot[k])
                o_point.append(li)
                o_uv.append(xy)
                o_w.append(0.25 ** float(self._meta_level[int(pid)]))
        n_obs = min(len(o_pose), O_cap)
        if n_obs < 8:
            return None
        op = np.zeros(O_cap, np.int32)
        opt = np.zeros(O_cap, np.int32)
        ouv = np.zeros((O_cap, 3), np.float32)
        ow = np.ones(O_cap, np.float32)
        ov = np.zeros(O_cap, bool)
        op[:n_obs] = o_pose[:n_obs]
        opt[:n_obs] = o_point[:n_obs]
        ouv[:n_obs, :2] = np.asarray(o_uv[:n_obs], np.float32)
        ow[:n_obs] = o_w[:n_obs]
        ov[:n_obs] = True

        # relative-pose edges (frozen marginalized constraints, DWO mode),
        # T_j_from_i per BAProblem.edge_R
        e_i = np.zeros(E_cap, np.int32)
        e_j = np.zeros(E_cap, np.int32)
        e_R = np.zeros((E_cap, 3, 3), np.float32)
        e_R[:] = np.eye(3)
        e_t = np.zeros((E_cap, 3), np.float32)
        e_info = np.zeros((E_cap, 6, 6), np.float32)
        e_val = np.zeros(E_cap, bool)
        for n, (a, b, R_ba, t_ba, Lam) in enumerate(edges[:E_cap]):
            e_i[n], e_j[n] = slot[a], slot[b]
            e_R[n], e_t[n], e_info[n] = R_ba, t_ba, Lam
            e_val[n] = True

        def up(x):
            return torch.as_tensor(x, device=dev)

        prob = BAProblem(
            R=up(Rs), t=up(ts), pose_valid=up(pv), pose_fixed=up(pf),
            psi=psi_pad, anchor_slot=up(anch_pad), point_valid=up(lval),
            obs_pose=up(op), obs_point=up(opt), obs_uvu=up(ouv),
            obs_weight=up(ow), obs_valid=up(ov),
            edge_i=up(e_i), edge_j=up(e_j), edge_R=up(e_R), edge_t=up(e_t),
            edge_info=up(e_info), edge_valid=up(e_val),
        )
        return {"prob": prob, "kf_ids": kf_ids, "slot": slot, "pts": pts,
                "P_cap": P_cap, "n_edges": int(e_val.sum())}

    def _writeback_window(self, meta, packed):
        """Apply a window solve: poses (host mirrors + device table), the
        psi scatter, and the tracking chain rebased through the CURRENT
        actkey's correction."""
        kf_ids, slot, pts = meta["kf_ids"], meta["slot"], meta["pts"]
        P_cap = meta["P_cap"]
        L_cap = meta["psi_out"].shape[0]
        R_np = packed[: P_cap * 9].reshape(P_cap, 3, 3)
        t_np = packed[P_cap * 9: P_cap * 12].reshape(P_cap, 3)
        self.last_ba_chi2 = (float(packed[P_cap * 12]),
                             float(packed[P_cap * 12 + 1]))
        dev = self.device
        kidx = np.asarray(list(kf_ids), np.int64)
        sidx = np.asarray([slot[k] for k in kf_ids], np.int64)
        self.poses = self.poses.set_many(
            torch.as_tensor(kidx, device=dev),
            torch.as_tensor(np.ascontiguousarray(R_np[sidx]), device=dev),
            torch.as_tensor(np.ascontiguousarray(t_np[sidx]), device=dev))
        # rebase the tracking chain through the actkey correction before
        # overwriting the mirrors (T_cw = T_c_ak @ T_akw_new)
        if self.actkey_id in slot:
            Rk_old, tk_old = self.pose_np[self.actkey_id]
            R_cak = self._R_cw @ Rk_old.T
            t_cak = self._t_cw - R_cak @ tk_old
            Rk_new = R_np[slot[self.actkey_id]]
            tk_new = t_np[slot[self.actkey_id]]
            self._R_cw = (R_cak @ Rk_new).astype(np.float32)
            self._t_cw = (R_cak @ tk_new + t_cak).astype(np.float32)
            self._dev_R_cw = None
            self._dev_t_cw = None
            # frames in flight carry packets from the PRE-adoption chain:
            # attach the right-multiplicative actkey correction
            # T_akw_old^-1 @ T_akw_new (composed if stacked)
            R_c = (Rk_old.T @ Rk_new).astype(np.float32)
            t_c = (Rk_old.T @ (tk_new - tk_old)).astype(np.float32)
            for e in self._pending:
                if e[5] is None:
                    e[5] = (R_c, t_c)
                else:
                    R0, t0 = e[5]
                    e[5] = ((R0 @ R_c).astype(np.float32),
                            (R0 @ t_c + t0).astype(np.float32))
        for k in kf_ids:
            i = slot[k]
            self.pose_np[k] = (R_np[i].astype(np.float32),
                               t_np[i].astype(np.float32))
        pids = np.full(L_cap, MAX_POINTS, np.int64)
        pids[: len(pts)] = pts
        self.points = self.points._replace(
            psi=scatter_psi(self.points.psi, torch.as_tensor(pids, device=dev),
                            meta["psi_out"]))
