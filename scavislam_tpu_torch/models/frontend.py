"""Stereo front-end: per-frame tracking, keyframe policy, map-point creation
(port of scavislam_tpu.models.frontend.StereoFrontend).

A thin host orchestrator over one frame step per frame
(models.frontend_step.frontend_step) plus one spawn step per new keyframe
(spawn_points_step_packed). Host responsibilities (scalar/set work only):
- candidate-id assembly from covisibility bookkeeping;
- keyframe switch/drop policy on the step's fetched statistics;
- id allocation, covisibility strengths, AddToOptimizer packets.

Per frame the host uploads one stacked image tensor (and the candidate ids
when they change) and fetches one packed vector.

Two modes, as in the twin: synchronous (``process_frame``: the policy runs
on the frame just stepped) and pipelined (``process_frame_pipelined``: the
policy runs on the frame dispatched ``pipeline_depth`` frames earlier, its
packed vector fetched through a :class:`Fetch` — a non-blocking copy into
pinned host memory behind a CUDA event; the keyframe spawn's payload fetch
is deferred to a later consume). The step's two LMs read their stop flags
on the host once per iteration, so on a card the dispatch itself waits for
the device and pipelining overlaps little beyond the fetch.

Backend feedback: ``apply_neighborhood`` adopts a backend-optimized
neighborhood (host mirrors at once; the device pose/psi writes as ONE packed
upload and ONE fused scatter at the top of the next frame step) and rebases
the in-flight pipelined frames by a right-multiplied correction. Each
finalized keyframe packet carries a CUDA event (``ready_event``) recorded on
the frontend's stream, which the backend's stream waits on.

Place recognition: with ``pr_vocab`` set (SlamSystem sets it to the
recognizer's vocabulary), every keyframe spawn also computes the keyframe's
bag-of-words block on the device, and it comes home in the spawn payload's
one download as the packet's ``pr_packed``.

Frames from disk: a frame that carries ``stacked_dev`` (a stack the IO
layer already copied to the device, ``io.filegrabber.FileGrabber`` with
``device_prefetch``) is used in place; the frontend's stream waits on the
frame's ``upload_event`` and records itself on the tensor, so that the
caching allocator does not hand its memory to a later upload too early.
With ``framepipe.rectify_frame`` set, every stack is undistorted and
rectified (``ops.rectify.Rectifier``, maps resident on the device) ahead of
the frame step, on the synchronous and the pipelined path.

Draw and debug state (what apps/visualize.py and apps/watch.py read):
``draw_data.tracked_uv`` holds the consumed frame's gated observations
(host numpy the policy already fetched); ``prev_pyr``, ``last_pyr``,
``last_dx``, ``last_dy``, ``last_disp`` and ``last_right`` are references to
the last dispatched step's device tensors, set at every dispatch and never
copied or downloaded here. With ``keep_kf_images`` set, each keyframe's
pyramid and disparity stay in ``keyframe_map[kf_id]`` (off by default:
they hold device memory for the whole run).
"""

from __future__ import annotations

import time
import warnings
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from scavislam_tpu_torch import resolve_device
from scavislam_tpu_torch.core.camera import StereoCamera
from scavislam_tpu_torch.core.lie import SE3, PoseRT
from scavislam_tpu_torch.models.frontend_step import (
    DENSE_SUBS,
    MATCH_SEARCH_RADIUS_PX,
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
    scatter_psi,
)
from scavislam_tpu_torch.ops.descriptors import BOW_COLS, BOW_KEYPOINTS
from scavislam_tpu_torch.ops.rectify import Rectifier
from scavislam_tpu_torch.utils.config import Config

# fixed scatter capacities of the neighborhood adoption: one shape per site
_POSE_SCATTER_CAP = 128
_PSI_SCATTER_CAP = 8192

CAND_CAP = 768  # candidate points considered per frame
NEW_PER_LEVEL = (320, 96, 32)  # new points per keyframe per level
TRACKED_CAP = 1024  # padded tracked-obs buffer for clearance tests
MIN_TRACK_OBS = 20  # tracking failure threshold (stereo_frontend.cpp:1053)
# minimum match signal for a rescue spawn (a below-floor frame that still
# sees a real fraction of its candidates; a kidnapped frame sees ~0)
RESCUE_MIN_MATCHES = 10


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
    # the keyframe's place-recognition block (ops.descriptors.bow_describe:
    # (BOW_KEYPOINTS, BOW_COLS)) when the frontend has a pr_vocab; the
    # place recognizer then indexes it with no device work of its own
    pr_packed: np.ndarray = None
    # CUDA event recorded on the frontend's stream when the packet was
    # finalized; the backend's stream waits on it (None on the CPU)
    ready_event: object = None


@dataclass
class FrontendDrawData:
    """Minimal draw snapshot (parity surface: StereoFrontendDrawData,
    stereo_frontend.h:41-82)."""

    tracked_uv: np.ndarray = field(default_factory=lambda: np.zeros((0, 2)))
    new_uv: np.ndarray = field(default_factory=lambda: np.zeros((0, 2)))


class StereoFrontend:
    """Public surface mirrors stereo_frontend.h:85-128."""

    def __init__(self, cam: StereoCamera, cfg: Config = None, device=None):
        self.cfg = cfg or Config()
        self.device = resolve_device(device)
        self.cam = cam
        self.levels = self.cfg.use_n_levels_in_frontent
        self.cams = [cam.scale_level(l) for l in range(self.levels)]
        self._cam_params = tuple(
            (c.focal, c.pp[0], c.pp[1], c.baseline) for c in self.cams)
        self._cam_statics = tuple(c.size for c in self.cams)
        self.tables_version = 0
        self.poses = PoseTable.empty(device=self.device)
        self.points = PointTable.empty(device=self.device)

        self.next_kf = 0
        self.next_point = 0
        self.kf_point_ids: dict[int, np.ndarray] = {}
        self.covis: dict[int, dict[int, int]] = {}
        self.keyframe_map: dict[int, dict] = {}
        # keep each keyframe's device pyramid and disparity in keyframe_map
        # for the keyframe view (apps/visualize.render_keyframe_view); off
        # by default, since they hold device memory for the whole run
        self.keep_kf_images = False
        self.pose_np: dict[int, tuple] = {}  # host mirror of keyframe poses
        self.actkey_id = -1
        self.neighborhood = None
        self.to_optimizer_stack: list[AddToOptimizer] = []
        self.draw_data = FrontendDrawData()
        # the debug views' device state: references to the last dispatched
        # step's tensors (and the step before's pyramid), never copied here
        self.prev_pyr = None
        self.last_pyr = None
        self.last_dx = self.last_dy = None
        self.last_disp = None
        self.last_right = None
        self.per_mon = None  # optional named-stage timer (set by SlamSystem)
        # (K, 128) BoW vocabulary tensor on this frontend's device: set, the
        # keyframe spawn also computes the place-recognition block
        self.pr_vocab = None
        # when set to a list, process_frame_pipelined appends one
        # (frame_id, dispatch_s, fetch_wait_s, consume_s) tuple per frame
        self.timing_log = None
        self._fetch_wait_s = 0.0

        # host numpy mirrors of point metadata (for policy only)
        self._meta_anchor = np.full(MAX_POINTS, -1, np.int64)
        self._meta_level = np.zeros(MAX_POINTS, np.int64)

        # dense-cloud density (per-level extra stride; StreamPool sets the
        # batched density) and the dense sampler (both samplers are exact)
        self.dense_subs = DENSE_SUBS
        self.dense_sample = "qpack"

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
        self._rectifier = Rectifier(cam, self.cfg, device=self.device)
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
        # neighborhood-adoption upload (apply_neighborhood) whose scatter
        # applies at the top of the next frame step
        self._nb_pending = None

        # pipelined mode. Deferred keyframe spawn: (rec, pkt_args) whose
        # payload fetch is in flight, finalized once it has landed
        self._pending_spawn = None
        # True after a RESCUE spawn (see _consume) until a frame passes the
        # tracking floor again: a second below-floor frame while a rescue is
        # unvalidated is a genuine loss, not staleness
        self._rescue_pending = False
        # in-flight frames, each a list [frame_id, cand_ids, FrontendStepOut,
        # Fetch, corr_R, corr_t, kf_epoch] where (corr_R, corr_t)
        # right-corrects the fetched world pose for backend rebases that
        # happened after the frame was dispatched
        self._pending = deque()
        # keyframe generation counter: frames dispatched before a keyframe
        # spawn carry a stale candidate set whose statistics would
        # re-trigger the keyframe conditions the spawn just fixed; their
        # keyframe decisions are suppressed at consume
        self._kf_epoch = 0
        # frames in flight before results are consumed; keyframe policy
        # lags `pipeline_depth` frames
        self.pipeline_depth = 2
        # staleness guard: depth x per-frame rotation must stay within the
        # matcher's search radius expressed as a rotation (_effective_depth
        # clamps and warns once); auto_depth=False forces the raw depth
        self.auto_depth = True
        self._rot_hist = deque(maxlen=8)
        self._prev_consumed_R = None
        self._depth_clamp_warned = False

    # -- device table accessors ------------------------------------------ #
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
        if "stacked_dev" in frame:
            stacked = self._prefetched(frame)
        else:
            # ONE stacked (2|3, H, W) tensor, uint8 when no external
            # disparity plane is needed: host frames are stacked on the host
            # and uploaded once, device frames are stacked in place
            left, right = frame["left"], frame.get("right")
            on_host = not isinstance(left, torch.Tensor)
            if on_host:
                left = np.asarray(left)
                right = (np.zeros_like(left) if right is None
                         else np.asarray(right))
            elif right is None:
                right = torch.zeros_like(left)
            planes = ([_as_f32(left), _as_f32(right), _as_f32(ext)]
                      if use_ext else [_to_u8(left), _to_u8(right)])
            stacked = (torch.as_tensor(np.stack(planes), device=self.device)
                       if on_host
                       else torch.stack([p.to(self.device) for p in planes]))
        # optional undistort + rectify ahead of the frame step
        stacked = self._rectifier.rectify_stacked(stacked)
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
            (int(self.cfg.ui.stereo_iters), int(self.cfg.ui.stereo_levels),
             int(self.cfg.ui.stereo_nr_plane)),
            dense_subs=self.dense_subs,
            dense_sample=self.dense_sample,
        )
        self._dev_R_cw = out.R_cw
        self._dev_t_cw = out.t_cw
        self.prev_pyr = self.last_pyr
        self.last_pyr = out.pyr
        self.last_dx, self.last_dy = out.dx, out.dy
        self.last_disp = out.disp
        self.last_right = stacked[1]
        return out

    def _prefetched(self, frame):
        """A frame's device-resident stack: ordered after its upload on this
        frontend's stream, and recorded on that stream for the allocator."""
        stacked = frame["stacked_dev"]
        if stacked.is_cuda:
            stream = torch.cuda.current_stream(stacked.device)
            if frame.get("upload_event") is not None:
                stream.wait_event(frame["upload_event"])
            stacked.record_stream(stream)
        return stacked.to(self.device)

    def _empty_prev_state(self, shape):
        h, w = shape
        clouds, intens, valids, Js = [], [], [], []
        dev = self.device
        for l in range(self.levels):
            sub = self.dense_subs[l] if l < len(self.dense_subs) else 1
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

        new_ids, new_psi, new_lvl, new_uvu, pr_packed = self._spawn(
            out, kf_id, None)
        self.kf_point_ids[kf_id] = new_ids
        self.covis[kf_id] = {}
        self.keyframe_map[kf_id] = self._kf_entry(out, T_np)
        pkt = AddToOptimizer(
            kf_id, T_np, new_ids, new_psi, new_lvl, new_uvu,
            np.zeros(0, np.int64), np.zeros((0, 3), np.float32),
            np.zeros(0, np.int64), {},
            pyr=out.pyr, disp=out.disp,
            points_snapshot=self.points, poses_snapshot=self.poses,
            pr_packed=pr_packed, ready_event=self._ready_event(),
        )
        self.to_optimizer_stack.append(pkt)
        return pkt

    def _kf_entry(self, out: FrontendStepOut, T_np) -> dict:
        """A keyframe's keyframe_map entry: its pose, and its device
        pyramid and disparity when keep_kf_images is set."""
        if self.keep_kf_images:
            return {"pyr": out.pyr, "disp": out.disp, "T_kw": T_np}
        return {"T_kw": T_np}

    def _ready_event(self):
        """A CUDA event behind everything the frontend enqueued so far on
        its stream (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def process_frame(self, frame: dict):
        """Track one frame. Returns (success, dropped_new_keyframe)."""
        self._apply_nb_pending(block=True)  # sync mode: no table lag
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
        self.draw_data.tracked_uv = obs_all[gate][:, :2]

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

    # -- pipelined mode ------------------------------------------------------ #
    def process_frame_pipelined(self, frame: dict):
        """Dispatch this frame, then consume the results of the frame
        dispatched `pipeline_depth` frames ago (fetch + keyframe policy).
        The device pose chain advances without waiting for the host policy;
        keyframe decisions lag `pipeline_depth` frames.

        Returns (success, dropped, consumed_frame_id) for the consumed frame,
        or None while the pipeline is still filling."""
        tlog = self.timing_log
        t_a = time.perf_counter() if tlog is not None else 0.0
        self._apply_nb_pending()
        self.frame_id = frame.get("frame_id", self.frame_id + 1)
        cand_ids = self._collect_candidates()
        out = self._run_step(frame, cand_ids)
        self._pending.append([self.frame_id, cand_ids, out, Fetch(out.packed),
                              None, None, self._kf_epoch])
        self._roll(out)
        if tlog is not None:
            t_b = time.perf_counter()
        if len(self._pending) <= self._effective_depth():
            if tlog is not None:
                tlog.append((self.frame_id, t_b - t_a, 0.0, 0.0))
            return None
        entry = self._pending.popleft()
        fid = entry[0]
        self._fetch_wait_s = 0.0
        success, dropped = self._consume(*entry[1:])
        if tlog is not None:
            t_c = time.perf_counter()
            tlog.append((fid, t_b - t_a, self._fetch_wait_s,
                         t_c - t_b - self._fetch_wait_s))
        return success, dropped, fid

    def flush_pipeline(self):
        """Consume ALL in-flight frames (end of sequence). Returns a list of
        (success, dropped, frame_id, world_pose, keyframe_packet_or_None),
        stopping at the first failure. Pose and packet are captured at each
        consume."""
        results = []
        while self._pending:
            entry = self._pending.popleft()
            fid = entry[0]
            success, dropped = self._consume(*entry[1:])
            pkt = self.to_optimizer_stack[-1] if dropped else None
            results.append((success, dropped, fid, self._world_pose(), pkt))
            if not success:
                self._pending.clear()
                break
        if self._pending_spawn is not None:
            # a keyframe decided at the last consume: finalize its packet
            # now (frame id None: no trajectory entry, just the packet)
            rec, pkt_args = self._pending_spawn
            self._pending_spawn = None
            pkt = self._finalize_keyframe(rec, pkt_args)
            results.append((True, True, None, None, pkt))
        return results

    def _effective_depth(self) -> int:
        """Dispatch-ahead depth after the staleness guard: depth x median
        per-frame rotation <= 3.4 x (search_radius / focal), the twin's
        budget (calibrated there on the 4 deg/frame 360-spin)."""
        d = max(1, self.pipeline_depth)
        if not self.auto_depth or len(self._rot_hist) < 4:
            return d
        rate = float(np.median(self._rot_hist))  # rad/frame
        if rate <= 1e-6:
            return d
        budget = 3.4 * MATCH_SEARCH_RADIUS_PX / float(self.cam.focal)
        d_max = max(1, int(budget / rate))
        if d > d_max and not self._depth_clamp_warned:
            warnings.warn(
                f"pipeline_depth={d} exceeds the staleness budget at the "
                f"measured rotation rate {np.degrees(rate):.1f} deg/frame "
                f"(matcher search radius {MATCH_SEARCH_RADIUS_PX:.0f} px at "
                f"f={float(self.cam.focal):.0f}); clamping dispatch-ahead "
                f"depth to {d_max} to avoid deterministic tracking "
                f"divergence", stacklevel=3)
            self._depth_clamp_warned = True
        return min(d, d_max)

    def _freshest_spawn_source(self):
        """Spawn-at-pipeline-head: the newest in-flight frame whose packed
        fetch has LANDED and whose statistics pass the tracking floor, as an
        (out, T_np, tracked) triple for _add_new_keyframe, or None. A spawn
        from the consumed frame's own view is already `pipeline_depth`
        frames stale; the newest landed frame cuts that to the fetch's
        latency with no extra device work (its own consume still happens
        later, at a stale epoch)."""
        C = CAND_CAP
        for entry in reversed(self._pending):
            _, cand_ids, out, fut, corr_R, corr_t, _ = entry
            if not fut.done():
                continue
            pk = fut.result()
            R_cw = pk[0:9].reshape(3, 3)
            t_cw = pk[9:12]
            if corr_R is not None:
                t_cw = R_cw @ corr_t + t_cw
                R_cw = R_cw @ corr_R
            n_matched, n_gated = int(pk[24]), int(pk[25])
            if (n_matched < MIN_TRACK_OBS or n_gated < MIN_TRACK_OBS
                    or not np.isfinite(t_cw).all()):
                continue
            gate = pk[34:34 + C] > 0.5
            obs_all = pk[34 + 2 * C: 34 + 5 * C].reshape(C, 3)
            lv = self._meta_level[np.clip(cand_ids, 0, MAX_POINTS - 1)]
            T_np = (np.asarray(R_cw, np.float32),
                    np.asarray(t_cw, np.float32))
            tracked = (cand_ids[gate], obs_all[gate], lv[gate])
            return out, T_np, tracked
        return None

    def _consume(self, cand_ids, out: FrontendStepOut, fut=None,
                 corr_R=None, corr_t=None, epoch=None):
        """The host policy on one fetched frame (pipelined mode): pose
        update, tracked set, switch and drop decisions, deferred spawns.
        Returns (success, packet_landed)."""
        C = CAND_CAP
        # a keyframe decided at an earlier consume finalizes once its spawn
        # payload fetch has landed
        spawn_landed = False
        if (self._pending_spawn is not None
                and self._pending_spawn[0]["fut"].done()):
            rec, pkt_args = self._pending_spawn
            self._pending_spawn = None
            self._finalize_keyframe(rec, pkt_args)
            spawn_landed = True
        if fut is not None:
            if self.timing_log is not None and not fut.done():
                t_w = time.perf_counter()
                pk = fut.result()
                self._fetch_wait_s = time.perf_counter() - t_w
            else:
                pk = fut.result()
        else:
            pk = out.packed.cpu().numpy()
        R_cw = pk[0:9].reshape(3, 3)
        t_cw = pk[9:12]
        if corr_R is not None:
            # dispatched before a backend rebase: apply the same
            # right-multiplicative world correction the chain received
            t_cw = R_cw @ corr_t + t_cw
            R_cw = R_cw @ corr_R
        n_matched, n_gated, t_norm, mean_track_len = pk[24:28]
        quad_counts = pk[30:34]
        gate = pk[34:34 + C] > 0.5
        obs_all = pk[34 + 2 * C: 34 + 5 * C].reshape(C, 3)

        bad = (int(n_matched) < MIN_TRACK_OBS
               or int(n_gated) < MIN_TRACK_OBS
               or not np.isfinite(t_cw).all())
        if bad:
            if epoch is not None and epoch != self._kf_epoch:
                # transient, not a loss: dispatched before the latest
                # keyframe spawn, so its candidate set is stale. Skip the
                # frame: keep the previous host pose, no keyframe decision
                # (a genuine loss also fails current-epoch frames)
                return True, spawn_landed
            if (not self._rescue_pending
                    and int(n_matched) >= RESCUE_MIN_MATCHES
                    and int(n_gated) > 0
                    and np.isfinite(t_cw).all()
                    and np.isfinite(R_cw).all()):
                # RESCUE SPAWN: partial matching and a finite chain mean the
                # pose is still good, so refresh the candidate set with a
                # keyframe from THIS frame's own view instead of declaring
                # loss (n_gated > 0 keeps it connected in the covis graph).
                # One rescue per validation: if the next current-epoch frame
                # is still under the floor, the loss is real
                self._R_cw, self._t_cw = R_cw, t_cw
                self._tracked_ids = cand_ids[gate]
                self._tracked_obs = obs_all[gate]
                self._tracked_levels = self._meta_level[
                    np.clip(cand_ids, 0, MAX_POINTS - 1)][gate]
                self._add_new_keyframe(out, defer=True)
                self._rescue_pending = True
                return True, spawn_landed
            return False, False
        self._rescue_pending = False
        if self._prev_consumed_R is not None:
            # rotation-rate sample for the staleness guard
            c = (np.trace(self._prev_consumed_R.T @ R_cw) - 1.0) * 0.5
            self._rot_hist.append(float(np.arccos(np.clip(c, -1.0, 1.0))))
        self._prev_consumed_R = np.asarray(R_cw, np.float64).copy()
        self._R_cw, self._t_cw = R_cw, t_cw
        # the chain from the WORLD pose + the CURRENT actkey: a keyframe or
        # switch after this frame was dispatched changed the actkey
        Rk, tk = self.pose_np[self.actkey_id]
        self._R_cak = (R_cw @ Rk.T).astype(np.float32)
        self._t_cak = (t_cw - self._R_cak @ tk).astype(np.float32)

        levels_arr = self._meta_level[np.clip(cand_ids, 0, MAX_POINTS - 1)]
        self._tracked_ids = cand_ids[gate]
        self._tracked_obs = obs_all[gate]
        self._tracked_levels = levels_arr[gate]
        self.draw_data.tracked_uv = obs_all[gate][:, :2]

        switched = self._maybe_switch_keyframe(
            float(np.linalg.norm(self._t_cak)))
        # frames dispatched before the latest keyframe spawn carry stale
        # candidate-set statistics: no keyframe decisions from them
        epoch_ok = epoch is None or epoch == self._kf_epoch
        if not switched and epoch_ok and self._shall_drop_keyframe(
            quad_counts, float(np.linalg.norm(self._t_cak)),
            float(mean_track_len),
        ):
            # decision + device dispatch now; the packet lands at a later
            # consume. The spawn source is the newest landed in-flight frame
            # when one qualifies
            if self.per_mon is not None:
                self.per_mon.start("drop keyframe")
            src = self._freshest_spawn_source()
            if src is not None:
                self._add_new_keyframe(src[0], defer=True,
                                       T_np=src[1], tracked=src[2])
            else:
                self._add_new_keyframe(out, defer=True)
            if self.per_mon is not None:
                self.per_mon.stop("drop keyframe")
        return True, spawn_landed

    # -- candidate assembly ------------------------------------------------ #
    def _collect_candidates(self) -> np.ndarray:
        """actkey's points + covis neighbours' points + the adopted
        neighborhood's points, deduped, packed into the per-level sections
        (parity: stereo_frontend.cpp:977-1050)."""
        lists = []
        if self.actkey_id in self.kf_point_ids:
            lists.append(self.kf_point_ids[self.actkey_id])
        for nbr in sorted(
            self.covis.get(self.actkey_id, {}),
            key=lambda k: -self.covis[self.actkey_id][k],
        ):
            lists.append(self.kf_point_ids.get(nbr, np.zeros(0, np.int64)))
        if self.neighborhood is not None:
            lists.append(np.asarray(
                self.neighborhood.get("point_ids", []), np.int64))
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
        """Run the spawn step + host id allocation; the payload's fetch is
        left in flight (a :class:`Fetch`). Metas are set for every allocated
        slot; finalize clears the rejected ones."""
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
            self.pr_vocab,
        )
        for l, cap in enumerate(caps):
            ids = np.arange(starts[l], starts[l] + cap, dtype=np.int64)
            self._meta_anchor[ids] = kf_id
            self._meta_level[ids] = l
        return {"kf_id": kf_id, "caps": caps, "starts": starts,
                "pr": self.pr_vocab is not None, "fut": Fetch(payloads)}

    def _spawn_finalize(self, rec):
        """Read the spawn payload's fetch: exact per-slot validity. Returns
        (ids, psi, levels, uvu0, pr_packed); pr_packed is the keyframe's BoW
        block, or None without a pr_vocab."""
        payloads = rec["fut"].result()
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
        pr_packed = None
        if rec["pr"]:
            pr_packed = payloads[off: off + BOW_KEYPOINTS * BOW_COLS].reshape(
                BOW_KEYPOINTS, BOW_COLS)
        return (np.concatenate(all_ids), np.concatenate(all_psi),
                np.concatenate(all_lvl), np.concatenate(all_uvu), pr_packed)

    def _spawn(self, out: FrontendStepOut, kf_id: int, tracked_obs):
        return self._spawn_finalize(
            self._spawn_dispatch(out, kf_id, tracked_obs))

    def _add_new_keyframe(self, out: FrontendStepOut, defer: bool = False,
                          T_np=None, tracked=None):
        """Parity: addNewKeyframe (stereo_frontend.cpp:309-443).

        With defer=True (pipelined mode) the spawn payload's fetch stays in
        flight and the AddToOptimizer packet is finalized at a later
        consume; everything matching needs (device point table, actkey
        switch, candidate ids) is in place at once. T_np/tracked override
        the keyframe pose and tracked set when the spawn source is not the
        consumed frame (_freshest_spawn_source); `out` is then the step
        output of that same source frame."""
        if self._pending_spawn is not None:
            # consecutive keyframe decisions: force the outstanding one out
            rec, pkt_args = self._pending_spawn
            self._pending_spawn = None
            self._finalize_keyframe(rec, pkt_args)
        if T_np is None:
            T_np = (self._R_cw.copy(), self._t_cw.copy())
        if tracked is None:
            tracked = (self._tracked_ids, self._tracked_obs,
                       self._tracked_levels)
        tracked_ids, tracked_obs, tracked_levels = tracked
        self._kf_epoch += 1
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
        self.keyframe_map[kf_id] = self._kf_entry(out, T_np)
        pkt_args = dict(
            kf_id=kf_id, T_cw=T_np,
            tracked_ids=np.asarray(tracked_ids).copy(),
            tracked_obs=np.asarray(tracked_obs).copy(),
            tracked_levels=np.asarray(tracked_levels).copy(),
            strengths=strengths, pyr=out.pyr, disp=out.disp,
        )
        if defer:
            # optimistic candidate set: every allocated slot (the device
            # valid flags gate the rejected ones); exact ids at finalize
            all_slots = np.concatenate([
                np.arange(s, s + c, dtype=np.int64)
                for s, c in zip(rec["starts"], rec["caps"])])
            self.kf_point_ids[kf_id] = np.concatenate(
                [all_slots, np.asarray(tracked_ids)])
            self._pending_spawn = (rec, pkt_args)
        else:
            self._finalize_keyframe(rec, pkt_args)
        self.actkey_id = kf_id
        # current-frame-from-actkey: identity when the spawn source is the
        # current frame, the relative pose when it is a newer in-flight one
        self._R_cak = (self._R_cw @ T_np[0].T).astype(np.float32)
        self._t_cak = (self._t_cw - self._R_cak @ T_np[1]).astype(np.float32)
        self._cand_np = None

    def _finalize_keyframe(self, rec, pkt_args) -> AddToOptimizer:
        """Consume the spawn payload, build + queue the backend packet."""
        new_ids, new_psi, new_lvl, new_uvu, pr_packed = \
            self._spawn_finalize(rec)
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
            pr_packed=pr_packed, ready_event=self._ready_event(),
        )
        self.to_optimizer_stack.append(pkt)
        self._ready_packets.append(pkt)
        return pkt

    def reseed(self, R_cw: np.ndarray, t_cw: np.ndarray,
               actkey_id: int = None):
        """Re-seed the tracking state at an externally estimated world pose
        (relocalization). In-flight pipelined frames are discarded (their
        pose chain is invalid)."""
        self._pending.clear()
        self._pending_spawn = None
        self._dev_R_cw = None
        self._dev_t_cw = None
        self._R_cw = np.asarray(R_cw, np.float32)
        self._t_cw = np.asarray(t_cw, np.float32)
        if actkey_id is not None and actkey_id in self.pose_np:
            self.actkey_id = actkey_id
        if self.actkey_id in self.pose_np:
            Rk, tk = self.pose_np[self.actkey_id]
            self._R_cak = (self._R_cw @ Rk.T).astype(np.float32)
            self._t_cak = (self._t_cw - self._R_cak @ tk).astype(np.float32)
        self._cand_np = None

    def take_ready_packets(self):
        """Finalized keyframe packets since the last call."""
        pkts, self._ready_packets = self._ready_packets, []
        return pkts

    # -- backend feedback --------------------------------------------------- #
    def apply_neighborhood(self, nb):
        """Adopt a backend-optimized neighborhood (stereo_slam.cpp:694-703:
        adopt only if it contains the current actkey, or shares a covis link
        with it — the backend answers a not-yet-inserted actkey's query at
        its newest inserted ancestor).

        The host mirrors update at once; the device writes (poses and psis)
        go up as ONE packed upload whose fused scatter applies at the top of
        the next frame step (`_apply_nb_pending`)."""
        if nb is None:
            return False
        kf_ids = nb.get("kf_ids", [])
        if self.actkey_id not in kf_ids:
            if not set(kf_ids) & set(self.covis.get(self.actkey_id, {})):
                return False
        nb_poses = nb.get("poses", {})
        P, C = _POSE_SCATTER_CAP, _PSI_SCATTER_CAP
        # index padding 1<<30 (exact in f32); the scatter drops it
        pidx = np.full(P, 1 << 30, np.int32)
        Rp = np.zeros((P, 3, 3), np.float32)
        tp = np.zeros((P, 3), np.float32)
        if nb_poses:
            kfs = np.fromiter(nb_poses.keys(), np.int64, len(nb_poses))[:P]
            Rs = np.stack([nb_poses[int(k)][0]
                           for k in kfs]).astype(np.float32)
            ts = np.stack([nb_poses[int(k)][1]
                           for k in kfs]).astype(np.float32)
            pidx[: len(kfs)] = kfs
            Rp[: len(kfs)] = Rs
            tp[: len(kfs)] = ts
            for k, R, t in zip(kfs, Rs, ts):
                self.pose_np[int(k)] = (R, t)
        cidx = np.full(C, 1 << 30, np.int32)
        vals = np.zeros((C, 3), np.float32)
        pids = nb.get("psi_ids")
        n_psi = 0 if pids is None else min(len(pids), C)
        if n_psi:
            cidx[:n_psi] = np.asarray(pids)[:n_psi]
            vals[:n_psi] = np.asarray(nb["psi_vals"], np.float32)[:n_psi]
        if nb_poses or n_psi:
            buf = np.concatenate([
                pidx.astype(np.float32), Rp.reshape(-1), tp.reshape(-1),
                cidx.astype(np.float32), vals.reshape(-1),
            ])
            if self._nb_pending is not None:
                self._apply_nb_pending(block=True)
            self._nb_pending = _upload_f32(buf, self.device)
        # keep the world pose consistent with the (possibly moved) actkey,
        # SVD-projected back onto SO(3) so adoptions do not accumulate
        # non-orthonormality
        R_old, t_old = self._R_cw.copy(), self._t_cw.copy()
        Rk, tk = self.pose_np[self.actkey_id]
        self._R_cw = _project_so3(self._R_cak @ Rk)
        self._t_cw = (self._R_cak @ tk + self._t_cak).astype(np.float32)
        # propagate the rebase to the in-flight device pose chain exactly:
        # one right-multiplication by D = T_cw_old^-1 o T_cw_new
        if self._dev_R_cw is not None and np.isfinite(R_old).all():
            D_R = (R_old.T @ self._R_cw).astype(np.float32)
            D_t = (R_old.T @ (self._t_cw - t_old)).astype(np.float32)
            D = _upload_f32(np.concatenate([D_R.reshape(-1), D_t]),
                            self.device)
            self._dev_R_cw, self._dev_t_cw = _compose_right(
                self._dev_R_cw, self._dev_t_cw, D[:9].reshape(3, 3), D[9:])
            # fetched (or in-fetch) packed results of in-flight frames are
            # raw: record the correction for their consume
            for entry in self._pending:
                if entry[4] is None:
                    entry[4], entry[5] = D_R, D_t
                else:
                    cR, ct = entry[4], entry[5]
                    entry[4] = (cR @ D_R).astype(np.float32)
                    entry[5] = (cR @ D_t + ct).astype(np.float32)
        self.neighborhood = nb
        self._cand_np = None  # the neighborhood may add candidates
        return True

    def _apply_nb_pending(self, block: bool = False):
        """Apply the pending neighborhood upload to the device tables (ONE
        fused scatter, no fetch). The upload is ordered on the frontend's
        stream before the scatter, so it is always ready; `block` is kept
        for the twin's call sites."""
        buf = self._nb_pending
        if buf is None:
            return
        self._nb_pending = None
        self.poses, psi = _nb_scatter_packed(self.poses, self.points.psi, buf)
        self.points = self.points._replace(psi=psi)


def _upload_f32(x: np.ndarray, device) -> torch.Tensor:
    """f32 host array -> device tensor; a pinned non-blocking copy on a
    card (no host sync)."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _nb_scatter_packed(poses: PoseTable, psi_tab: torch.Tensor,
                       buf: torch.Tensor):
    """Neighborhood adoption as one fused scatter over one packed buffer:
    the pose writeback (R, t, valid — PoseTable.set_many) and the psi
    writeback (scatter_psi). Layout of `buf` (f32): [pose idx (P), R (P*9),
    t (P*3), psi idx (C), psi (C*3)]; the indices are integral f32 values
    and the padding rows (1<<30) are dropped."""
    P, C = _POSE_SCATTER_CAP, _PSI_SCATTER_CAP
    o = 0
    pidx = buf[o:o + P].to(torch.int64)
    o += P
    Rp = buf[o:o + P * 9].reshape(P, 3, 3)
    o += P * 9
    tp = buf[o:o + P * 3].reshape(P, 3)
    o += P * 3
    cidx = buf[o:o + C].to(torch.int64)
    o += C
    vals = buf[o:o + C * 3].reshape(C, 3)
    return poses.set_many(pidx, Rp, tp), scatter_psi(psi_tab, cidx, vals)


def _project_so3(R: np.ndarray) -> np.ndarray:
    """Nearest rotation matrix (Frobenius) via SVD, host-side."""
    u, _, vt = np.linalg.svd(R.astype(np.float64))
    u[:, 2] *= np.sign(np.linalg.det(u @ vt))
    return (u @ vt).astype(np.float32)


def _compose_right(R, t, D_R, D_t):
    """(R,t) o (D_R,D_t): right-multiply a pose by a correction, then
    re-orthonormalize by Gram-Schmidt on the rows (handedness kept by the
    cross product), so the correction chain does not accumulate
    non-orthonormality."""
    Rc = R @ D_R
    r0 = Rc[0] / torch.linalg.norm(Rc[0])
    r1 = Rc[1] - torch.dot(Rc[1], r0) * r0
    r1 = r1 / torch.linalg.norm(r1)
    r2 = torch.linalg.cross(r0, r1)
    return torch.stack([r0, r1, r2]), R @ D_t + t


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
