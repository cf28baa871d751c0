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

The host shell it shares with the stereo frontend (the keyframe map and
its bookkeeping, the step's device inputs, the frames in flight) is
``models.host_frontend.HostFrontend``, its base class.

Per frame the host uploads the image (unless the frame carries it on the
device: ``left_dev``, or ``stacked_dev`` whose plane 0 is taken) and the
candidate ids when they change (a pinned copy), and downloads one packed
vector through a ``host_frontend.Fetch`` (a pinned copy behind a CUDA
event). On a card the step is one CUDA graph replay
(``step_graph.MonoStepGraph``, captured at the first frame stepped), on
the CPU the eager ``mono_step``. Pipelined, the policy runs
``pipeline_depth`` frames behind the dispatch; the device pose chain
advances without the host.

Window BA (``window_ba``): the last-K window or, with ``dwo=True``, the
covisibility double window with frozen marginalized relative-pose
constraints, solved by ``ba_solver.solve_ba`` with the disparity residual
zero-weighted. Synchronous, or dispatched and adopted at a later frame
boundary (``adopt_pending_ba``); a map re-gauge in between discards it.

Host spans and synchronizing calls (``utils/perfmon.Spans``), on while
``timing_log`` is a list: ``mono.dispatch`` (candidates, inputs and the
step) holding ``mono.step`` (the step's call); ``mono.consume`` holding
``mono.fetch_wait``; ``mono.spawn`` (a keyframe's spawn and its payload
read); ``mono.window_ba`` (the window's assembly and dispatch) and
``mono.adopt`` (a landed solve's write-back); ``MonoSystem`` adds
``mono.place`` and ``mono.relocalize``. Each call that steps a frame, and
each frame the flush consumes, appends one entry (see
``HostFrontend.timing_log``); spans a caller records after a call
(``MonoSystem``'s window BA and place recognition) fold into the next.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from scavislam_tpu_torch.core.camera import StereoCamera
from scavislam_tpu_torch.core.lie import PoseRT
from scavislam_tpu_torch.models.ba_solver import BAProblem, solve_ba
from scavislam_tpu_torch.models.frontend_step import normalize_frames
from scavislam_tpu_torch.models.host_frontend import (
    Fetch,
    HostFrontend,
    InFlight,
    _project_so3,
)
from scavislam_tpu_torch.models.map_store import MAX_POINTS, scatter_psi
from scavislam_tpu_torch.models.mono_step import (
    PackedMonoStep,
    mono_step,
    spawn_points_mono,
)
from scavislam_tpu_torch.models.step_graph import MonoStepGraph
from scavislam_tpu_torch.ops.image import build_pyramid
from scavislam_tpu_torch.utils.config import Config
from scavislam_tpu_torch.utils.perfmon import spanned

CAND_CAP = 512
NEW_PER_LEVEL = (192, 64, 32)
TRACKED_CAP = 512
MIN_TRACK_OBS = 15


def _solve_mono_window(cam_params, prob: BAProblem, iters: int):
    """The mono window solve: the stereo DWO Schur solver with the
    disparity residual row zero-weighted (uv-only observations)."""
    return solve_ba(cam_params, prob, iters=iters,
                    disp_info=torch.zeros_like(prob.obs_weight))


class MonoFrontend(HostFrontend):
    """Feature-based monocular VO with filter-initialized inverse depth.

    The keyframe policy mirrors the stereo rules (stereo_frontend.cpp:
    512-528) with the translation threshold in prior-scale units."""

    SPAN_PREFIX = "mono"

    def __init__(self, cam: StereoCamera, cfg: Config = None, *,
                 prior_idepth: float = 0.25, conv_q_info: float = 25.0,
                 prior_weight: float = 0.05, device=None):
        super().__init__(cam, cfg, device)
        self._cam_params = tuple(
            (c.focal, c.pp[0], c.pp[1]) for c in self.cams)
        self.prior_idepth = float(prior_idepth)
        self.conv_q_info = float(conv_q_info)
        self.prior_weight = float(prior_weight)
        # device scalars made once (device fills, no per-frame upload)
        dev = self.device
        self._conv_dev = torch.full((), self.conv_q_info, dtype=torch.float32,
                                    device=dev)
        self._pw_dev = torch.full((), self.prior_weight, dtype=torch.float32,
                                  device=dev)
        # the frame step, as in StereoFrontend: CUDA graph replays on a
        # card (captured at the first frame stepped), eager on the CPU
        self._step = (MonoStepGraph() if self.device.type == "cuda"
                      else mono_step)
        self.Lam = torch.zeros((MAX_POINTS, 3, 3), dtype=torch.float32,
                               device=dev)
        # per-keyframe observations for the window BA: point ids and the
        # level-0 uv each was (re-)observed at when the keyframe was made
        # (tracked survivors) or spawned (anchor observations)
        self.kf_obs: dict[int, tuple] = {}
        self.trajectory: list = []

        self._tracked_uv = np.zeros((0, 2), np.float32)
        self.last_lam_qq = np.zeros(0, np.float32)
        self.last_pyr = None
        self.last_kf_img = None

        self._pending_ba = None  # in-flight async window solve
        self._map_gen = 0  # bumped on re-gauge; stale solves discarded
        self.last_ba_chi2 = None
        # frozen marginalized relative-pose constraints (mono DWO):
        # (a, b) a<b -> (R_b_from_a, t_b_from_a, Lambda 6x6), made when a
        # covis edge leaves the inner window, dropped when both ends
        # re-enter it or the map re-gauges
        self.edge_constraints: dict = {}

    # -- helpers ----------------------------------------------------------- #
    def _collect_candidates(self) -> np.ndarray:
        """actkey's points + covis neighbours' points, deduped and sorted,
        packed into the per-level sections."""
        lists = self._covis_point_lists()
        ids = (np.unique(np.concatenate(lists)) if lists
               else np.zeros(0, np.int64))
        return self._sectioned(ids, CAND_CAP)

    def _image_dev(self, frame):
        """The frame's left plane on this frontend's device: `left_dev`
        (prefetched by the IO layer), plane 0 of `stacked_dev`, or `left`
        uploaded."""
        if "left_dev" in frame:
            return self._prefetched(frame, "left_dev")
        if "stacked_dev" in frame:
            return self._prefetched(frame, "stacked_dev")[0]
        left = frame["left"]
        if isinstance(left, torch.Tensor) and left.device == self.device:
            return left
        self.spans.sync("frame.upload")  # from pageable memory
        if isinstance(left, torch.Tensor):
            return left.to(self.device)
        return torch.as_tensor(np.asarray(left), device=self.device)

    # -- frame processing --------------------------------------------------- #
    def _run_step(self, frame, cand_ids):
        R_cw, t_cw = self._pose_dev()
        img, cand = self._image_dev(frame), self._cand_device(cand_ids)
        with self.spans.span("mono.step"):
            out = self._step(
                img, R_cw, t_cw, self._actkey_dev(), self.poses, self.points,
                self.Lam, cand, self._conv_dev, self._pw_dev,
                self._cam_params, self._cam_statics, self.levels,
                float(self.cfg.ui.max_reproj_error), 0.18)
        self.points = out.points
        self.Lam = out.Lam
        self._dev_R_cw = out.R_cw
        self._dev_t_cw = out.t_cw
        self.last_pyr = out.pyr
        return out

    def process_first_frame(self, frame: dict):
        self.frame_id = frame.get("frame_id", 0)
        T_kw = PoseRT.from_any(frame["T_cw_init"]) if "T_cw_init" in frame \
            else PoseRT(np.eye(3), np.zeros(3))
        kf_id = self._first_keyframe((np.array(T_kw.R, np.float32),
                                      np.array(T_kw.t, np.float32)))

        # the pyramid of the (f32) left image, for spawning only
        left = frame["left"] if "left" in frame else self._image_dev(frame)
        if not isinstance(left, torch.Tensor) or left.device != self.device:
            self.spans.sync("frame.upload")  # from pageable memory
        if not isinstance(left, torch.Tensor):
            left = torch.as_tensor(np.asarray(left))
        img = normalize_frames(left.to(self.device)).to(torch.float32)
        with self.spans.span("mono.spawn"):
            self._spawn(build_pyramid(img, self.levels), kf_id, None)
        self.trajectory.append((self.frame_id, self._world_pose()))

    def process_frame(self, frame: dict):
        """Track one frame synchronously. Returns (success, dropped)."""
        # adopt BEFORE dispatch: the step seeds from the adopted chain
        self.adopt_pending_ba()
        with self.spans.span("mono.dispatch"):
            self.frame_id = frame.get("frame_id", self.frame_id + 1)
            cand_ids = self._collect_candidates()
            out = self._run_step(frame, cand_ids)
        res = self._consume(self._in_flight(cand_ids, out))
        self._log_entry(self.frame_id)
        return res

    def process_frame_pipelined(self, frame: dict):
        """Dispatch this frame; consume the one dispatched `pipeline_depth`
        frames ago (its packed download has been in flight behind the later
        frames' device work). Returns (success, dropped, consumed_frame_id)
        or None while filling."""
        # adopt BEFORE dispatch: frames already in flight get a pose
        # correction attached; this frame dispatches against the adopted
        # chain
        self.adopt_pending_ba()
        with self.spans.span("mono.dispatch"):
            self.frame_id = frame.get("frame_id", self.frame_id + 1)
            cand_ids = self._collect_candidates()
            out = self._run_step(frame, cand_ids)
            self._pending.append(self._in_flight(cand_ids, out))
        return self._consume_behind(max(1, self.pipeline_depth))

    def flush_pipeline(self):
        """Consume all in-flight frames (end of sequence), stopping at the
        first failure. Returns [(success, dropped, frame_id)]."""
        results = []
        for f, ok, dropped in self._drain():
            self._log_entry(f.frame_id)
            results.append((ok, dropped, f.frame_id))
        return results

    @spanned("mono.consume")
    def _consume(self, f: InFlight):
        """The frame's packed download (waiting where it has not landed),
        then the policy on it."""
        pk = PackedMonoStep.read(self._landed(f.fetch))
        # dispatched before an async window-BA adoption: the chain's
        # right-multiplicative actkey correction
        # (T_cw' = T_cw_packet @ T_akw_old^-1 T_akw_new), projected onto SO(3)
        R_cw, t_cw = f.world_pose(pk.R_cw, pk.t_cw)
        if f.corr is not None:
            R_cw = _project_so3(R_cw)
        self.last_lam_qq = pk.lam_qq

        if int(pk.n_gated) < MIN_TRACK_OBS or not np.isfinite(t_cw).all():
            if f.epoch != self._kf_epoch:
                # dispatched before the latest keyframe spawn: a transient
                # skip, not a tracking loss
                return True, False
            return False, False
        self._R_cw = R_cw.astype(np.float32)
        self._t_cw = t_cw.astype(np.float32)
        self._tracked_ids = f.cand_ids[pk.gate]
        self._tracked_uv = pk.obs_uv[pk.gate]
        self.trajectory.append((f.frame_id, self._world_pose()))

        # keyframe decisions (switch and spawn) only on current-epoch
        # frames: stale-epoch statistics re-trigger the conditions the last
        # decision fixed
        dropped = False
        current = f.epoch == self._kf_epoch
        switched = current and self._maybe_switch_keyframe(float(pk.t_norm))
        if (not switched and current
                and self._shall_drop_keyframe(pk.quad_counts,
                                              float(pk.t_norm),
                                              float(pk.mean_track_len))):
            with self.spans.span("mono.spawn"):
                self._add_new_keyframe(f.out)
            dropped = True
        return True, dropped

    def _maybe_switch_keyframe(self, t_norm: float) -> bool:
        """Re-target the active keyframe when a covisible keyframe is closer
        than 0.5 * parallax_thr and shares > 100 tracked features
        (shallWeSwitchKeyframe, stereo_frontend.cpp:445-510)."""
        best = self._nearer_keyframe(t_norm)
        if best is None:
            return False
        self.actkey_id = best[0]
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
        self._restart_chain(Rk.copy(), tk.copy(), best)
        ok, _ = self.process_frame(frame)
        if not ok:
            self.points, self.Lam = snap[:2]
            self._restart_chain(*snap[2:])
        return ok

    # -- keyframe creation ------------------------------------------------ #
    def _spawn(self, pyr, kf_id: int, tracked_uv):
        caps = NEW_PER_LEVEL[: self.levels]
        starts = self._allocate_points(caps, kf_id)

        t_uv0 = np.zeros((TRACKED_CAP, 2), np.float32)
        t_val = np.zeros(TRACKED_CAP, bool)
        if tracked_uv is not None and len(tracked_uv) > 0:
            n = min(len(tracked_uv), TRACKED_CAP)
            t_uv0[:n] = tracked_uv[:n]
            t_val[:n] = True

        # the tracked uv and valid uploads, and the new points' Lambda
        self.spans.sync("spawn.upload", 3)
        self.points, self.Lam, payloads = spawn_points_mono(
            pyr, torch.as_tensor(t_uv0, device=self.device),
            torch.as_tensor(t_val, device=self.device),
            self.points, self.Lam, starts, kf_id, self.prior_idepth,
            self._cam_params, self._cam_statics, self.levels, tuple(caps),
            float(self.cfg.frontend.newpoint_clearance))
        pk = self._fetched(Fetch(payloads), "spawn.fetch")
        all_ids, all_uv = [], []
        off = 0
        for l, cap in enumerate(caps):
            off += cap * 3  # psi
            uv0 = pk[off: off + cap * 2].reshape(cap, 2)
            off += cap * 2
            ok = pk[off: off + cap] > 0.5
            off += cap
            ids = np.arange(starts[l], starts[l] + cap, dtype=np.int64)
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
        self._set_keyframe_pose(kf_id, (self._R_cw.copy(), self._t_cw.copy()))
        self._link_keyframe(kf_id, self._tracked_ids)

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

    @spanned("mono.window_ba")
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
            with self.spans.span("mono.adopt"):
                self._writeback_window(meta, self._fetched(
                    Fetch(packed), "window.fetch"))
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
        with self.spans.span("mono.adopt"):
            packed = self._fetched(pb["fut"], "window.fetch")
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
        self.spans.sync("window.upload")  # the point ids, pageable
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

        self.spans.sync("window.upload", 17)  # the problem's arrays
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
        # the keyframe ids, poses and point ids, from pageable memory
        self.spans.sync("adopt.upload", 4)
        kidx = np.asarray(list(kf_ids), np.int64)
        sidx = np.asarray([slot[k] for k in kf_ids], np.int64)
        self.poses = self.poses.set_many(
            torch.as_tensor(kidx, device=dev),
            torch.as_tensor(np.ascontiguousarray(R_np[sidx]), device=dev),
            torch.as_tensor(np.ascontiguousarray(t_np[sidx]), device=dev))
        # rebase the tracking chain through the actkey correction before
        # overwriting the mirrors (T_cw = T_c_ak @ T_akw_new), projected
        # back onto SO(3), as the corrected poses in _consume are:
        # unprojected, the f32 products' non-orthonormality roughly triples
        # at every adoption (the rebased chain seeds the next keyframe's
        # pose, which the next rebase composes again) until the seeded
        # matching fails
        if self.actkey_id in slot:
            Rk_old, tk_old = self.pose_np[self.actkey_id]
            R_cak = self._R_cw @ Rk_old.T
            t_cak = self._t_cw - R_cak @ tk_old
            Rk_new = R_np[slot[self.actkey_id]]
            tk_new = t_np[slot[self.actkey_id]]
            self._R_cw = _project_so3(R_cak @ Rk_new)
            self._t_cw = (R_cak @ tk_new + t_cak).astype(np.float32)
            self._dev_R_cw = None
            self._dev_t_cw = None
            # frames in flight carry packets from the PRE-adoption chain:
            # attach the right-multiplicative actkey correction
            # T_akw_old^-1 @ T_akw_new (composed if stacked)
            self._correct_in_flight(
                (Rk_old.T @ Rk_new).astype(np.float32),
                (Rk_old.T @ (tk_new - tk_old)).astype(np.float32))
        for k in kf_ids:
            i = slot[k]
            self.pose_np[k] = (R_np[i].astype(np.float32),
                               t_np[i].astype(np.float32))
        pids = np.full(L_cap, MAX_POINTS, np.int64)
        pids[: len(pts)] = pts
        self.points = self.points._replace(
            psi=scatter_psi(self.points.psi, torch.as_tensor(pids, device=dev),
                            meta["psi_out"]))
