"""Stereo front-end: per-frame tracking, keyframe policy, map-point creation
(port of scavislam_tpu.models.frontend.StereoFrontend, synchronous path).

A thin host orchestrator over one frame step per frame
(models.frontend_step.frontend_step) plus one spawn step per new keyframe
(spawn_points_step_packed). Host responsibilities (scalar/set work only):
- candidate-id assembly from covisibility bookkeeping;
- keyframe switch/drop policy on the step's fetched statistics;
- id allocation, covisibility strengths, AddToOptimizer packets.

Per frame the host uploads one stacked image tensor (and the candidate ids
when they change) and fetches one packed vector (``.cpu().numpy()``).

Not ported yet (the pipelining slice): ``process_frame_pipelined``,
``flush_pipeline``, ``apply_neighborhood``, ``reseed``, the
``_effective_depth`` staleness guard and the deferred keyframe spawn.
Rectification is not ported: a config with ``framepipe.rectify_frame`` set
is refused.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from scavislam_tpu_torch.core.camera import StereoCamera
from scavislam_tpu_torch.core.lie import SE3, PoseRT
from scavislam_tpu_torch.models.frontend_step import (
    DENSE_SUBS,
    FrontendStepOut,
    frontend_step,
    level_sections,
    spawn_points_step_packed,
)
from scavislam_tpu_torch.models.map_store import (
    MAX_KEYFRAMES,
    MAX_POINTS,
    PointTable,
    PoseTable,
)
from scavislam_tpu_torch.utils.config import Config

CAND_CAP = 768  # candidate points considered per frame
NEW_PER_LEVEL = (320, 96, 32)  # new points per keyframe per level
TRACKED_CAP = 1024  # padded tracked-obs buffer for clearance tests
MIN_TRACK_OBS = 20  # tracking failure threshold (stereo_frontend.cpp:1053)


@dataclass
class AddToOptimizer:
    """Frontend -> backend keyframe packet (parity: AddToOptimzer [sic],
    data_structures.h:153-171). Carries the new points' payload plus
    snapshots of the device tables (tables are updated functionally, so a
    reference IS a snapshot) and this keyframe's pyramid."""

    kf_id: int
    T_kw: tuple  # numpy (R, t)
    new_point_ids: np.ndarray
    new_psi: np.ndarray  # (m, 3)
    new_levels: np.ndarray  # (m,)
    new_uvu: np.ndarray  # (m, 3)
    tracked_point_ids: np.ndarray
    tracked_obs: np.ndarray  # (n, 3)
    tracked_levels: np.ndarray
    covis_strengths: dict
    pyr: tuple = None
    disp: object = None
    points_snapshot: object = None
    poses_snapshot: object = None
    pr_packed: np.ndarray = None  # place-recognition block (not ported yet)


class StereoFrontend:
    """Public surface mirrors stereo_frontend.h:85-128 (synchronous mode)."""

    def __init__(self, cam: StereoCamera, cfg: Config = None, device=None):
        self.cfg = cfg or Config()
        if self.cfg.framepipe.rectify_frame:
            raise NotImplementedError(
                "framepipe.rectify_frame: rectification is not ported yet")
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.cam = cam
        self.levels = self.cfg.use_n_levels_in_frontent
        self.cams = [cam.scale_level(l) for l in range(self.levels)]
        self._cam_params = tuple(
            (c.focal, c.pp[0], c.pp[1], c.baseline) for c in self.cams)
        self._cam_statics = tuple(c.size for c in self.cams)
        self.poses = PoseTable.empty(device=self.device)
        self.points = PointTable.empty(device=self.device)

        self.next_kf = 0
        self.next_point = 0
        self.kf_point_ids: dict[int, np.ndarray] = {}
        self.covis: dict[int, dict[int, int]] = {}
        self.keyframe_map: dict[int, dict] = {}
        self.pose_np: dict[int, tuple] = {}  # host mirror of keyframe poses
        self.actkey_id = -1
        self.to_optimizer_stack: list[AddToOptimizer] = []

        # host numpy mirrors of point metadata (for policy only)
        self._meta_anchor = np.full(MAX_POINTS, -1, np.int64)
        self._meta_level = np.zeros(MAX_POINTS, np.int64)

        # rolling per-frame state (device + small host scalars)
        self._prev_clouds = None
        self._prev_intens = None
        self._prev_valids = None
        self._prev_J = None
        self._R_cak = np.eye(3, dtype=np.float32)
        self._t_cak = np.zeros(3, np.float32)
        self._R_cw = np.eye(3, dtype=np.float32)
        self._t_cw = np.zeros(3, np.float32)
        self._num_disp = 16 * self.cfg.ui.num_disp16
        self.frame_id = -1

        self._tracked_ids = np.zeros((0,), np.int64)
        self._tracked_obs = np.zeros((0, 3), np.float32)
        self._tracked_levels = np.zeros((0,), np.int64)

        self._cand_np = None
        self._cand_dev = None
        self._dev_R_cw = None  # device tensors chaining the world pose
        self._dev_t_cw = None
        # finalized AddToOptimizer packets not yet handed to the system
        self._ready_packets = []

    # -- public pose accessors ------------------------------------------- #
    def _world_pose(self) -> PoseRT:
        return PoseRT(self._R_cw.astype(np.float64).copy(),
                      self._t_cw.astype(np.float64).copy())

    # -- frame processing -------------------------------------------------- #
    def _cand_device(self, cand_ids):
        """Upload candidate ids only when they changed."""
        if self._cand_np is None or not np.array_equal(self._cand_np, cand_ids):
            self._cand_np = cand_ids.copy()
            self._cand_dev = torch.as_tensor(
                cand_ids.astype(np.int32), device=self.device)
        return self._cand_dev

    def _run_step(self, frame, cand_ids):
        ext = frame.get("disp")
        use_ext = ext is not None or frame.get("use_gt_disp", False)
        if frame.get("use_gt_disp", False):
            ext = frame["disp_gt"]
        # ONE stacked (2|3, H, W) tensor, uint8 when no external disparity
        # plane is needed: host frames are stacked on the host and uploaded
        # once, device frames are stacked in place
        left, right = frame["left"], frame.get("right")
        on_host = not isinstance(left, torch.Tensor)
        if on_host:
            left = np.asarray(left)
            right = np.zeros_like(left) if right is None else np.asarray(right)
        elif right is None:
            right = torch.zeros_like(left)
        planes = ([_as_f32(left), _as_f32(right), _as_f32(ext)] if use_ext
                  else [_to_u8(left), _to_u8(right)])
        stacked = (torch.as_tensor(np.stack(planes), device=self.device)
                   if on_host else torch.stack([p.to(self.device) for p in planes]))
        R_cw = (self._dev_R_cw if self._dev_R_cw is not None
                else torch.as_tensor(self._R_cw, dtype=torch.float32,
                                     device=self.device))
        t_cw = (self._dev_t_cw if self._dev_t_cw is not None
                else torch.as_tensor(self._t_cw, dtype=torch.float32,
                                     device=self.device))
        out = frontend_step(
            stacked,
            self._prev_clouds, self._prev_intens, self._prev_valids,
            self._prev_J,
            R_cw, t_cw,
            max(self.actkey_id, 0),
            self.poses, self.points,
            self._cand_device(cand_ids),
            self._cam_params, self._cam_statics,
            self.levels, self._num_disp, bool(use_ext),
            float(self.cfg.ui.max_reproj_error),
            int(self.cfg.ui.stereo_method),
        )
        self._dev_R_cw = out.R_cw
        self._dev_t_cw = out.t_cw
        return out

    def _empty_prev_state(self, shape):
        h, w = shape
        clouds, intens, valids, Js = [], [], [], []
        dev = self.device
        for l in range(self.levels):
            sub = DENSE_SUBS[l] if l < len(DENSE_SUBS) else 1
            step = (2**l) * sub
            n = -(-h // step) * -(-w // step)
            clouds.append(torch.zeros((n, 3), dtype=torch.float32, device=dev))
            intens.append(torch.zeros((n,), dtype=torch.float32, device=dev))
            valids.append(torch.zeros((n,), dtype=torch.bool, device=dev))
            Js.append(torch.zeros((n, 6), dtype=torch.float32, device=dev))
        return tuple(clouds), tuple(intens), tuple(valids), tuple(Js)

    def process_first_frame(self, frame: dict):
        """Bootstrap: frame 0 becomes the first keyframe at the origin."""
        h, w = tuple(frame["left"].shape)
        (self._prev_clouds, self._prev_intens, self._prev_valids,
         self._prev_J) = self._empty_prev_state((h, w))
        cand_ids = np.full(CAND_CAP, -1, np.int64)
        self.frame_id = frame.get("frame_id", 0)
        out = self._run_step(frame, cand_ids)
        pkt = self.bootstrap_first(out, frame)
        self._roll(out)
        return pkt

    def bootstrap_first(self, out: FrontendStepOut, frame: dict):
        """First-keyframe bookkeeping given an already-run step output: the
        first keyframe sits at the world origin."""
        self.frame_id = frame.get("frame_id", 0)
        kf_id = self._new_keyframe_id()
        T_np = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
        self.poses = self.poses.set(kf_id, self._se3(T_np))
        self.pose_np[kf_id] = T_np
        self.actkey_id = kf_id
        self._R_cak = np.eye(3, dtype=np.float32)
        self._t_cak = np.zeros(3, np.float32)
        self._R_cw = T_np[0].copy()
        self._t_cw = T_np[1].copy()

        new_ids, new_psi, new_lvl, new_uvu = self._spawn(out, kf_id, None)
        self.kf_point_ids[kf_id] = new_ids
        self.covis[kf_id] = {}
        self.keyframe_map[kf_id] = {"T_kw": T_np}
        pkt = AddToOptimizer(
            kf_id, T_np, new_ids, new_psi, new_lvl, new_uvu,
            np.zeros(0, np.int64), np.zeros((0, 3), np.float32),
            np.zeros(0, np.int64), {},
            pyr=out.pyr, disp=out.disp,
            points_snapshot=self.points, poses_snapshot=self.poses,
        )
        self.to_optimizer_stack.append(pkt)
        return pkt

    def process_frame(self, frame: dict):
        """Track one frame. Returns (success, dropped_new_keyframe)."""
        self.frame_id = frame.get("frame_id", self.frame_id + 1)
        cand_ids = self._collect_candidates()
        out = self._run_step(frame, cand_ids)

        # ---- the one host fetch per frame
        C = CAND_CAP
        pk = out.packed.cpu().numpy()
        R_cw = pk[0:9].reshape(3, 3)
        t_cw = pk[9:12]
        R_cak = pk[12:21].reshape(3, 3)
        t_cak = pk[21:24]
        n_matched, n_gated, t_norm, mean_track_len = pk[24:28]
        quad_counts = pk[30:34]
        gate = pk[34:34 + C] > 0.5
        obs_all = pk[34 + 2 * C: 34 + 5 * C].reshape(C, 3)

        if int(n_matched) < MIN_TRACK_OBS or int(n_gated) < MIN_TRACK_OBS:
            return False, False
        if not np.isfinite(t_cw).all():
            return False, False

        self._R_cw, self._t_cw = R_cw, t_cw
        self._R_cak, self._t_cak = R_cak, t_cak

        levels_arr = self._meta_level[np.clip(cand_ids, 0, MAX_POINTS - 1)]
        self._tracked_ids = cand_ids[gate]
        self._tracked_obs = obs_all[gate]
        self._tracked_levels = levels_arr[gate]

        dropped = False
        switched = self._maybe_switch_keyframe(float(t_norm))
        if not switched and self._shall_drop_keyframe(
            quad_counts, float(t_norm), float(mean_track_len)
        ):
            self._add_new_keyframe(out)
            dropped = True

        self._roll(out)
        return True, dropped

    def _roll(self, out: FrontendStepOut):
        self._prev_clouds = out.clouds
        self._prev_valids = out.cloud_valids
        self._prev_intens = out.intens
        self._prev_J = out.cloud_J

    # -- candidate assembly ------------------------------------------------ #
    def _collect_candidates(self) -> np.ndarray:
        """actkey's points + covis neighbours' points, deduped, packed into
        the per-level sections (parity: stereo_frontend.cpp:977-1050)."""
        lists = []
        if self.actkey_id in self.kf_point_ids:
            lists.append(self.kf_point_ids[self.actkey_id])
        for nbr in sorted(
            self.covis.get(self.actkey_id, {}),
            key=lambda k: -self.covis[self.actkey_id][k],
        ):
            lists.append(self.kf_point_ids.get(nbr, np.zeros(0, np.int64)))
        ids = pd_unique(np.concatenate(lists)) if lists else np.zeros(0, np.int64)
        out = np.full((CAND_CAP,), -1, np.int64)
        if len(ids):
            lv = self._meta_level[np.clip(ids, 0, MAX_POINTS - 1)]
            off = 0
            for l, cap in enumerate(level_sections(self.levels, CAND_CAP)):
                sel = ids[lv == l][:cap]
                out[off:off + len(sel)] = sel
                off += cap
        return out

    # -- keyframe policy --------------------------------------------------- #
    def _shall_drop_keyframe(self, quad_counts, t_norm, mean_track_len):
        """Parity: stereo_frontend.cpp:512-528."""
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

    def _maybe_switch_keyframe(self, t_norm: float) -> bool:
        """Parity: stereo_frontend.cpp:445-510."""
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
        nbr = best[0]
        Rn, tn = self.pose_np[nbr]
        R_cn = self._R_cw @ Rn.T
        t_cn = self._t_cw - R_cn @ tn
        self.actkey_id = nbr
        self._R_cak = R_cn.astype(np.float32)
        self._t_cak = t_cn.astype(np.float32)
        self._cand_np = None
        return True

    # -- keyframe creation ------------------------------------------------- #
    def _new_keyframe_id(self) -> int:
        kf = self.next_kf
        if kf >= MAX_KEYFRAMES:
            raise RuntimeError("keyframe table full")
        self.next_kf += 1
        return kf

    def _se3(self, T_np) -> SE3:
        return SE3(torch.as_tensor(T_np[0], dtype=torch.float32,
                                   device=self.device),
                   torch.as_tensor(T_np[1], dtype=torch.float32,
                                   device=self.device))

    def _spawn_dispatch(self, out: FrontendStepOut, kf_id: int, tracked_obs):
        """Run the spawn step + host id allocation. Metas are set for every
        allocated slot; finalize clears the rejected ones."""
        caps = NEW_PER_LEVEL[: self.levels]
        # wrap-around recycling when the table fills
        if self.next_point + sum(caps) > MAX_POINTS:
            self.next_point = 0
        starts = []
        for cap in caps:
            starts.append(self.next_point)
            self.next_point += cap

        # ONE packed upload: [uv0 | valid | starts | kf_id]
        packed_in = np.zeros(3 * TRACKED_CAP + self.levels + 1, np.float32)
        if tracked_obs is not None and len(tracked_obs) > 0:
            n = min(len(tracked_obs), TRACKED_CAP)
            packed_in[: 2 * n] = np.asarray(
                tracked_obs[:n, :2], np.float32).ravel()
            packed_in[2 * TRACKED_CAP: 2 * TRACKED_CAP + n] = 1.0
        packed_in[3 * TRACKED_CAP: 3 * TRACKED_CAP + self.levels] = starts
        packed_in[3 * TRACKED_CAP + self.levels] = kf_id

        self.points, payloads = spawn_points_step_packed(
            out.pyr, out.disp, packed_in, self.points,
            self._cam_params, self._cam_statics,
            self.levels, tuple(caps),
            float(self.cfg.frontend.newpoint_clearance), TRACKED_CAP,
        )
        for l, cap in enumerate(caps):
            ids = np.arange(starts[l], starts[l] + cap, dtype=np.int64)
            self._meta_anchor[ids] = kf_id
            self._meta_level[ids] = l
        return {"kf_id": kf_id, "caps": caps, "starts": starts,
                "payloads": payloads}

    def _spawn_finalize(self, rec):
        """Fetch the spawn payload: exact per-slot validity. Returns
        (ids, psi, levels, uvu0)."""
        payloads = rec["payloads"].cpu().numpy()
        caps, starts = rec["caps"], rec["starts"]
        all_ids, all_psi, all_lvl, all_uvu = [], [], [], []
        off = 0
        for l, cap in enumerate(caps):
            psi = payloads[off: off + cap * 3].reshape(cap, 3)
            off += cap * 3
            uvu0 = payloads[off: off + cap * 3].reshape(cap, 3)
            off += cap * 3
            ok = payloads[off: off + cap] > 0.5
            off += cap
            ids = np.arange(starts[l], starts[l] + cap, dtype=np.int64)
            self._meta_anchor[ids[~ok]] = -1  # clear rejected slots
            all_ids.append(ids[ok])
            all_psi.append(psi[ok])
            all_lvl.append(np.full(int(ok.sum()), l, np.int64))
            all_uvu.append(uvu0[ok])
        return (np.concatenate(all_ids), np.concatenate(all_psi),
                np.concatenate(all_lvl), np.concatenate(all_uvu))

    def _spawn(self, out: FrontendStepOut, kf_id: int, tracked_obs):
        return self._spawn_finalize(
            self._spawn_dispatch(out, kf_id, tracked_obs))

    def _add_new_keyframe(self, out: FrontendStepOut):
        """Parity: addNewKeyframe (stereo_frontend.cpp:309-443), synchronous:
        the new keyframe is the current frame at its tracked pose."""
        T_np = (self._R_cw.copy(), self._t_cw.copy())
        tracked_ids = self._tracked_ids
        tracked_obs = self._tracked_obs
        tracked_levels = self._tracked_levels
        kf_id = self._new_keyframe_id()
        self.poses = self.poses.set(kf_id, self._se3(T_np))
        self.pose_np[kf_id] = T_np

        anch = self._meta_anchor[np.clip(tracked_ids, 0, MAX_POINTS - 1)]
        strengths = {}
        for a, c in zip(*np.unique(anch, return_counts=True)):
            if int(a) >= 0 and int(c) >= self.cfg.frontend.covis_thr:
                strengths[int(a)] = int(c)
        self.covis[kf_id] = dict(strengths)
        for a, c in strengths.items():
            self.covis.setdefault(a, {})[kf_id] = c

        rec = self._spawn_dispatch(out, kf_id, tracked_obs)
        self.keyframe_map[kf_id] = {"T_kw": T_np}
        pkt_args = dict(
            kf_id=kf_id, T_cw=T_np,
            tracked_ids=np.asarray(tracked_ids).copy(),
            tracked_obs=np.asarray(tracked_obs).copy(),
            tracked_levels=np.asarray(tracked_levels).copy(),
            strengths=strengths, pyr=out.pyr, disp=out.disp,
        )
        self._finalize_keyframe(rec, pkt_args)
        self.actkey_id = kf_id
        # current frame IS the new keyframe
        self._R_cak = (self._R_cw @ T_np[0].T).astype(np.float32)
        self._t_cak = (self._t_cw - self._R_cak @ T_np[1]).astype(np.float32)
        self._cand_np = None

    def _finalize_keyframe(self, rec, pkt_args) -> AddToOptimizer:
        """Consume the spawn payload, build + queue the backend packet."""
        new_ids, new_psi, new_lvl, new_uvu = self._spawn_finalize(rec)
        kf_id = pkt_args["kf_id"]
        self.kf_point_ids[kf_id] = np.concatenate(
            [new_ids, pkt_args["tracked_ids"]])
        self._cand_np = None
        pkt = AddToOptimizer(
            kf_id, pkt_args["T_cw"], new_ids, new_psi, new_lvl, new_uvu,
            pkt_args["tracked_ids"], pkt_args["tracked_obs"],
            pkt_args["tracked_levels"], pkt_args["strengths"],
            pyr=pkt_args["pyr"], disp=pkt_args["disp"],
            points_snapshot=self.points, poses_snapshot=self.poses,
        )
        self.to_optimizer_stack.append(pkt)
        self._ready_packets.append(pkt)
        return pkt

    def take_ready_packets(self):
        """Finalized keyframe packets since the last call."""
        pkts, self._ready_packets = self._ready_packets, []
        return pkts


def _as_f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return np.asarray(x, np.float32)


def _to_u8(img):
    """[0, 1] float image -> uint8 (round half up), on the host for numpy
    input and on the device for a tensor."""
    if isinstance(img, torch.Tensor):
        if img.dtype == torch.uint8:
            return img
        return (torch.clamp(img.to(torch.float32), 0.0, 1.0) * 255.0
                + 0.5).to(torch.uint8)
    if img.dtype == np.uint8:
        return img
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def pd_unique(ids: np.ndarray) -> np.ndarray:
    """Order-preserving unique (first occurrence wins)."""
    _, idx = np.unique(ids, return_index=True)
    return ids[np.sort(idx)]
