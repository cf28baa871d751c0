"""The host shell of the frame-step frontends (``frontend.StereoFrontend``
and ``mono_frontend.MonoFrontend``), written once: the keyframe map and its
bookkeeping (the device tables, their host mirrors, the covisibility graph,
id allocation, the drop and switch rules of stereo_frontend.cpp:445-528),
the step's device inputs (pinned non-blocking uploads, the active keyframe
as a device fill, a prefetched frame ordered after its upload), and the
frames in flight (one :class:`InFlight` each, its packed download a
:class:`Fetch`, the corrections stacked on it, the wait for it, its
``timing_log`` entry). What a frontend does with a landed frame (its
consume policy, its spawn, how it applies a correction) stays in it.
"""

from __future__ import annotations

from collections import deque
from typing import NamedTuple

import numpy as np
import torch

from scavislam_tpu_torch import resolve_device
from scavislam_tpu_torch.core.lie import SE3, PoseRT
from scavislam_tpu_torch.models.frontend_step import level_sections
from scavislam_tpu_torch.models.map_store import (
    MAX_KEYFRAMES,
    MAX_POINTS,
    PointTable,
    PoseTable,
)
from scavislam_tpu_torch.utils.config import Config
from scavislam_tpu_torch.utils.perfmon import Spans, span_s


class Fetch:
    """A device->host copy of one tensor in flight, with a future's
    ``done()``/``result()``. On a CUDA device: a non-blocking copy into a
    pinned host buffer and a CUDA event recorded behind it on the current
    stream (a timing event when ``timed``); ``done()`` queries the event,
    ``result()`` waits for it and returns the numpy view. On the CPU the
    copy is complete at once."""

    def __init__(self, x: torch.Tensor, timed: bool = False):
        self.event = None
        if x.is_cuda:
            self._host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            self._host.copy_(x, non_blocking=True)
            self.event = torch.cuda.Event(enable_timing=timed)
            self.event.record(torch.cuda.current_stream(x.device))
        else:
            self._host = x.detach()

    def done(self) -> bool:
        return self.event is None or self.event.query()

    def result(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self._host.numpy()


class InFlight(NamedTuple):
    """A dispatched frame whose policy has not run yet."""

    frame_id: int
    cand_ids: np.ndarray
    out: object  # the frame step's output
    fetch: Fetch  # its packed vector's download
    epoch: int  # the keyframe epoch it was dispatched in
    # (R, t) to right-multiply onto its fetched world pose: the rebases of
    # the chain made after its dispatch, or None
    corr: tuple

    def corrected(self, R: np.ndarray, t: np.ndarray) -> "InFlight":
        """This frame with one more right-multiplied correction (R, t)."""
        if self.corr is None:
            return self._replace(corr=(R, t))
        R0, t0 = self.corr
        return self._replace(corr=((R0 @ R).astype(np.float32),
                                   (R0 @ t + t0).astype(np.float32)))

    def world_pose(self, R_cw: np.ndarray, t_cw: np.ndarray):
        """The fetched world pose (R_cw, t_cw) with the correction applied
        (not re-orthonormalized)."""
        if self.corr is None:
            return R_cw, t_cw
        R_c, t_c = self.corr
        return R_cw @ R_c, R_cw @ t_c + t_cw


class HostFrontend:
    """The host state and bookkeeping a frame-step frontend keeps. A
    subclass sets ``SPAN_PREFIX`` (its spans' first name), ``_cam_params``
    and ``_step``, and defines ``_consume(InFlight) -> (success,
    dropped)``, its policy on a dispatched frame."""

    SPAN_PREFIX: str

    def __init__(self, cam, cfg: Config, device):
        self.cfg = cfg or Config()
        self.device = resolve_device(device)
        self.cam = cam
        self.levels = self.cfg.use_n_levels_in_frontent
        self.cams = [cam.scale_level(l) for l in range(self.levels)]
        self._cam_statics = tuple(c.size for c in self.cams)
        self.tables_version = 0
        self.poses = PoseTable.empty(device=self.device)
        self.points = PointTable.empty(device=self.device)

        self.next_kf = 0
        self.next_point = 0
        self.kf_point_ids: dict[int, np.ndarray] = {}
        self.covis: dict[int, dict[int, int]] = {}
        self.pose_np: dict[int, tuple] = {}  # host mirror of keyframe poses
        self.actkey_id = -1
        self.frame_id = -1
        # host numpy mirrors of point metadata (for policy only)
        self._meta_anchor = np.full(MAX_POINTS, -1, np.int64)
        self._meta_level = np.zeros(MAX_POINTS, np.int64)

        self._R_cw = np.eye(3, dtype=np.float32)
        self._t_cw = np.zeros(3, np.float32)
        self._dev_R_cw = None  # device tensors chaining the world pose
        self._dev_t_cw = None
        self._tracked_ids = np.zeros(0, np.int64)
        self._cand_np = None
        self._cand_dev = None
        self._actkey_cache = None  # (actkey_id, its device int32 scalar)

        # pipelined mode: the frames in flight, oldest first
        self._pending: deque[InFlight] = deque()
        # keyframe generation counter: frames dispatched before a keyframe
        # decision carry statistics that would re-trigger the conditions
        # the decision just fixed; their keyframe decisions are suppressed
        # at consume
        self._kf_epoch = 0
        # frames in flight before results are consumed; keyframe policy
        # lags `pipeline_depth` frames
        self.pipeline_depth = 2
        # when set to a list, each call that steps a frame (and each frame
        # the flush consumes, where the frontend logs it) appends one
        # (frame_id, dispatch_s, fetch_wait_s, consume_s, folded) tuple:
        # the seconds of its <prefix>.dispatch, its <prefix>.fetch_wait
        # and the rest of its <prefix>.consume, and what `spans` recorded
        # since the previous entry (perfmon.Spans.fold: the spans by name,
        # the synchronizing calls by site)
        self.timing_log = None
        # host spans and synchronizing calls (a StreamPool hands its own)
        self.spans = Spans(self)

    # -- device tables ----------------------------------------------------- #
    # poses/points are properties so that every write bumps tables_version:
    # StreamPool restacks its batched tables when a version moved
    @property
    def poses(self):
        return self._poses_table

    @poses.setter
    def poses(self, value):
        self._poses_table = value
        self.tables_version += 1

    @property
    def points(self):
        return self._points_table

    @points.setter
    def points(self, value):
        self._points_table = value
        self.tables_version += 1

    def _world_pose(self) -> PoseRT:
        return PoseRT(self._R_cw.astype(np.float64).copy(),
                      self._t_cw.astype(np.float64).copy())

    # -- the step's device inputs ------------------------------------------ #
    def _cand_device(self, cand_ids):
        """Upload candidate ids only when they changed (no host sync)."""
        if self._cand_np is None or not np.array_equal(self._cand_np, cand_ids):
            self._cand_np = cand_ids.copy()
            self._cand_dev = _upload(cand_ids.astype(np.int32), self.device)
        return self._cand_dev

    def _actkey_dev(self):
        """The active keyframe's id as a device int32 scalar (a fill, not a
        host copy), the frame step's input."""
        key = max(self.actkey_id, 0)
        if self._actkey_cache is None or self._actkey_cache[0] != key:
            self._actkey_cache = (key, torch.full(
                (), key, dtype=torch.int32, device=self.device))
        return self._actkey_cache[1]

    def _pose_dev(self):
        """The pose chain's seed: the last step's device pose, or the host
        pose after a re-seed (no host sync)."""
        if self._dev_R_cw is None:
            return (_upload_f32(self._R_cw, self.device),
                    _upload_f32(self._t_cw, self.device))
        return self._dev_R_cw, self._dev_t_cw

    def _prefetched(self, frame, key):
        """``frame[key]``, a tensor the IO layer already copied to a device,
        on this frontend's device: ordered after the frame's upload on this
        frontend's stream, and recorded on that stream for the allocator."""
        x = frame[key]
        if x.is_cuda:
            stream = torch.cuda.current_stream(x.device)
            if frame.get("upload_event") is not None:
                stream.wait_event(frame["upload_event"])
            x.record_stream(stream)
        return x.to(self.device)

    # -- candidates ------------------------------------------------------- #
    def _covis_point_lists(self) -> list:
        """The active keyframe's point ids, then its covisible keyframes',
        strongest link first."""
        lists = []
        if self.actkey_id in self.kf_point_ids:
            lists.append(self.kf_point_ids[self.actkey_id])
        links = self.covis.get(self.actkey_id, {})
        for nbr in sorted(links, key=lambda k: -links[k]):
            lists.append(self.kf_point_ids.get(nbr, np.zeros(0, np.int64)))
        return lists

    def _sectioned(self, ids: np.ndarray, cap: int) -> np.ndarray:
        """`ids` packed into the frame step's per-level candidate sections
        (-1 padded), each section keeping its level's first ids."""
        out = np.full((cap,), -1, np.int64)
        if len(ids):
            lv = self._meta_level[np.clip(ids, 0, MAX_POINTS - 1)]
            off = 0
            for l, sec in enumerate(level_sections(self.levels, cap)):
                sel = ids[lv == l][:sec]
                out[off:off + len(sel)] = sel
                off += sec
        return out

    # -- keyframes -------------------------------------------------------- #
    def _first_keyframe(self, T_np) -> int:
        """The first keyframe, at the world pose `T_np`, active."""
        kf_id = self._new_keyframe_id()
        self._set_keyframe_pose(kf_id, T_np)
        self.actkey_id = kf_id
        self._R_cw, self._t_cw = T_np[0].copy(), T_np[1].copy()
        self.covis[kf_id] = {}
        return kf_id

    def _new_keyframe_id(self) -> int:
        kf = self.next_kf
        if kf >= MAX_KEYFRAMES:
            raise RuntimeError("keyframe table full")
        self.next_kf += 1
        return kf

    def _set_keyframe_pose(self, kf_id: int, T_np):
        """A keyframe's pose into the device pose table and the host mirror:
        its R and t go up from pageable memory, and the valid flag's write
        is a third synchronizing copy."""
        self.spans.sync("keyframe.pose", 3)
        self.poses = self.poses.set(kf_id, SE3(
            torch.as_tensor(T_np[0], dtype=torch.float32, device=self.device),
            torch.as_tensor(T_np[1], dtype=torch.float32, device=self.device)))
        self.pose_np[kf_id] = T_np

    def _allocate_points(self, caps, kf_id: int) -> list:
        """The point-table starts of a spawn's per-level blocks of `caps`
        slots, wrapping around to 0 when the table fills. Every slot's
        metadata names `kf_id` and the level; the spawn clears the anchor
        of each slot it rejects."""
        if self.next_point + sum(caps) > MAX_POINTS:
            self.next_point = 0
        starts = []
        for l, cap in enumerate(caps):
            starts.append(self.next_point)
            self._meta_anchor[self.next_point:self.next_point + cap] = kf_id
            self._meta_level[self.next_point:self.next_point + cap] = l
            self.next_point += cap
        return starts

    def _link_keyframe(self, kf_id: int, tracked_ids) -> dict:
        """A new keyframe's covisibility: per anchor keyframe the tracked
        points it anchors, where at least ``covis_thr``; linked both ways
        and returned."""
        anch = self._meta_anchor[np.clip(tracked_ids, 0, MAX_POINTS - 1)]
        strengths = {}
        for a, c in zip(*np.unique(anch, return_counts=True)):
            if int(a) >= 0 and int(c) >= self.cfg.frontend.covis_thr:
                strengths[int(a)] = int(c)
        self.covis[kf_id] = dict(strengths)
        for a, c in strengths.items():
            self.covis.setdefault(a, {})[kf_id] = c
        return strengths

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

    def _nearer_keyframe(self, t_norm: float):
        """The covisible keyframe to switch to (stereo_frontend.cpp:445-510):
        the nearest that shares more than 100 tracked features and is
        nearer than both 0.5 * parallax_thr and `t_norm`, as (id,
        distance), or None."""
        ids = self._tracked_ids
        if len(ids) == 0 or self.actkey_id < 0:
            return None
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
        return best

    def _restart_chain(self, R_cw, t_cw, actkey_id: int):
        """Restart tracking at the host pose (R_cw, t_cw) with `actkey_id`
        active: the frames in flight are dropped, and the next step's pose
        chain and candidates go up anew."""
        self._pending.clear()
        self._R_cw, self._t_cw = R_cw, t_cw
        self._dev_R_cw = self._dev_t_cw = None
        self.actkey_id = actkey_id
        self._cand_np = None

    # -- frames in flight ------------------------------------------------- #
    def _in_flight(self, cand_ids, out) -> InFlight:
        """The frame just stepped, its packed download started."""
        return InFlight(self.frame_id, cand_ids, out, Fetch(out.packed),
                        self._kf_epoch, None)

    def _correct_in_flight(self, R: np.ndarray, t: np.ndarray):
        """Stack the right-multiplied correction (R, t) onto every frame in
        flight: their fetched poses predate a rebase of the chain."""
        for i, f in enumerate(self._pending):
            self._pending[i] = f.corrected(R, t)

    def _fetched(self, fetch, site: str) -> np.ndarray:
        """`fetch`'s result, its wait counted at `site` where it has not
        landed."""
        if not fetch.done():
            self.spans.sync(site)
        return fetch.result()

    def _landed(self, fetch) -> np.ndarray:
        """A frame's packed vector, waiting where it has not landed."""
        if fetch.done():
            return fetch.result()
        with self.spans.span(f"{self.SPAN_PREFIX}.fetch_wait"):
            return self._fetched(fetch, "frame.fetch")

    def _consume_behind(self, depth: int):
        """After a dispatch: the policy on the oldest frame in flight once
        more than `depth` are, as (success, dropped, frame_id), or None
        while the pipeline fills; either way the call's timing_log entry."""
        if len(self._pending) <= depth:
            self._log_entry(self.frame_id)
            return None
        f = self._pending.popleft()
        success, dropped = self._consume(f)
        self._log_entry(f.frame_id)
        return success, dropped, f.frame_id

    def _drain(self):
        """Consume every frame in flight, oldest first: yields (frame,
        success, dropped), and stops after the first failure."""
        while self._pending:
            f = self._pending.popleft()
            success, dropped = self._consume(f)
            yield f, success, dropped
            if not success:
                self._pending.clear()
                return

    def _log_entry(self, frame_id):
        """Append the frame's timing_log entry (when there is a log)."""
        if self.timing_log is None:
            return
        p = self.SPAN_PREFIX
        f = self.spans.fold()
        wait = span_s(f, f"{p}.fetch_wait")
        self.timing_log.append((frame_id, span_s(f, f"{p}.dispatch"), wait,
                                span_s(f, f"{p}.consume") - wait, f))


def _upload(x: np.ndarray, device) -> torch.Tensor:
    """Host array -> device tensor; a pinned non-blocking copy on a card
    (no host sync)."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _upload_f32(x: np.ndarray, device) -> torch.Tensor:
    """f32 host array -> device tensor, as `_upload`."""
    return _upload(np.asarray(x, np.float32), device)


def _project_so3(R: np.ndarray) -> np.ndarray:
    """Nearest rotation matrix (Frobenius) via SVD, host-side."""
    u, _, vt = np.linalg.svd(R.astype(np.float64))
    u[:, 2] *= np.sign(np.linalg.det(u @ vt))
    return (u @ vt).astype(np.float32)
