"""Backend mapping thread: graph maintenance, DWO optimization, registration
(port of scavislam_tpu.models.backend).

The thread body polls four sources in priority order, as the twin does:

  A. new keyframes from the frontend -> insert into the SlamGraph (+ forward
     to the place recognizer, when one is attached),
  B. a neighborhood query -> prepare the double window, answer with the
     root's neighborhood, then dispatch one DWO optimize pass,
  C. pending local-registration jobs ("metric loop closure"): re-match the
     root keyframe against points of non-neighbor keyframes in the extended
     neighborhood to densify the graph,
  D. detected appearance loops -> verify geometry and insert a loop edge,
     then optimize around the loop.

Device work runs on the backend's own CUDA stream (``Backend.stream``), so a
solve never sits in front of the frame loop's host syncs. A keyframe packet
carries a CUDA event recorded when the frontend finalized it; the backend
stream waits on that event before it reads the packet's tensors, and marks
them used on its stream (``record_stream``) so the caching allocator does not
hand their memory back to the frontend while the backend reads them.

Registration and solves are dispatched and return a :class:`Fetch`; their
results are applied at a later poll. The reference's known gaps are kept
for parity: a budget-deferred solve drops that keyframe's registration, and
``MIN_SOLVE_PERIOD_S`` is 0.25 s.
"""

from __future__ import annotations

import sys
import time
from collections import Counter
from contextlib import nullcontext
from functools import lru_cache, partial

import numpy as np
import torch

from scavislam_tpu_torch import resolve_device
from scavislam_tpu_torch.core.camera import StereoCamera
from scavislam_tpu_torch.core.lie import SE3, PoseRT
from scavislam_tpu_torch.models.dense_tracker import to_device_pose
from scavislam_tpu_torch.models.host_frontend import Fetch, _upload
from scavislam_tpu_torch.models.map_store import (
    PointTable,
    PoseTable,
    materialize_points,
)
from scavislam_tpu_torch.models.matcher import _match_level
from scavislam_tpu_torch.models.pose_optimizer import motion_only_ba_robust
from scavislam_tpu_torch.models.slam_graph import (
    INNER,
    OUTER,
    GraphPoint,
    SlamGraph,
)
from scavislam_tpu_torch.models.step_graph import GraphedFn
from scavislam_tpu_torch.ops.fast import corner_buckets_prefiltered
from scavislam_tpu_torch.ops.image import build_pyramid
from scavislam_tpu_torch.pipeline.monitors import (
    BackendMonitor,
    PlaceRecognizerMonitor,
)
from scavislam_tpu_torch.utils.config import Config


def _resolve_solve_device(index: int, device: torch.device):
    """graph.solve_device index -> a card (None = the backend's device).

    An index past the cards present falls back to the default card with a
    warning, as the twin does: configs are shared across hosts with
    different card counts. On the CPU the index is ignored."""
    if index is None or index < 0 or device.type != "cuda":
        return None
    n = torch.cuda.device_count()
    if index >= n:
        print(f"backend: graph.solve_device={index} but only {n} "
              "device(s) present; solving on the default device",
              file=sys.stderr)
        return None
    return torch.device("cuda", index)


def _resolve_solve_mesh(n: int, device: torch.device):
    """graph.solve_mesh device count -> a (dp=1, sp=n) Mesh of the first n
    cards (None = off). With fewer cards than asked (on the CPU: one
    device) it falls back to the single-device solve with a warning, as
    the twin does: configs are shared across hosts."""
    if n is None or n <= 1:
        return None
    have = torch.cuda.device_count() if device.type == "cuda" else 1
    if n > have:
        print(f"backend: graph.solve_mesh={n} but only {have} "
              "device(s) present; single-device solve", file=sys.stderr)
        return None
    from scavislam_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(n, dp=1)


# the thread body's sleep after a poll that found no work (the twin's 1 ms)
POLL_IDLE_S = 0.001
NB_MAX_NEIGHBORS = 10  # backend.cpp:244-386 caps the neighborhood at 10
REG_EXTRA_FRAMES = 40  # framesInNeighborhood(+40), backend.cpp:190-199
MIN_LOOP_MATCHES = 25
CAND_CAP = 1024


class DetectedLoop:
    """Parity: DetectedLoop (placerecognizer.h:43-48)."""

    def __init__(self, query_id, loop_id, T_query_from_loop):
        self.query_id = query_id
        self.loop_id = loop_id
        self.T_query_from_loop = T_query_from_loop


def _packet_tensors(pkt):
    """The device tensors a keyframe packet hands to the backend."""
    out = list(pkt.pyr or ())
    if isinstance(pkt.disp, torch.Tensor):
        out.append(pkt.disp)
    for table in (pkt.points_snapshot, pkt.poses_snapshot):
        if table is not None:
            out.extend(table)
    return [x for x in out if isinstance(x, torch.Tensor)]


class Backend:
    def __init__(self, cam: StereoCamera, cfg: Config = None,
                 monitor: BackendMonitor = None,
                 place_monitor: PlaceRecognizerMonitor = None, device=None):
        self.cfg = cfg or Config()
        self.cam = cam
        self.device = resolve_device(device)
        self.levels = self.cfg.use_n_levels_in_frontent
        self.cams = [cam.scale_level(l) for l in range(self.levels)]
        self.graph = SlamGraph(
            cam,
            covis_thr=self.cfg.frontend.covis_thr,
            inner_window_size=self.cfg.graph.inner_window,
            double_window_size=(
                self.cfg.graph.inner_window + self.cfg.graph.outer_window
            ),
            solve_device=_resolve_solve_device(self.cfg.graph.solve_device,
                                               self.device),
            solve_mesh=_resolve_solve_mesh(self.cfg.graph.solve_mesh,
                                           self.device),
            device=self.device,
        )
        # the backend's own stream (None on the CPU)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self.monitor = monitor or BackendMonitor()
        self.place_monitor = place_monitor
        self.local_registration_stack: list[int] = []
        self.keyframe_snapshots: dict[int, dict] = {}
        # minimum wall-clock spacing between solve dispatches (and the local
        # registrations they queue): the device budget shared with the
        # tracking loop. 0 restores the reference's solve-per-query
        # (SlamSystem sets 0 when unthreaded, for determinism).
        self.MIN_SOLVE_PERIOD_S = 0.25
        # recency window of keyframe image snapshots kept on the device: a
        # root older than the window skips local registration with a counter
        self.SNAPSHOT_KEEP = 128
        self._last_tables = None  # (points_snapshot, poses_snapshot)
        self.prev_kf_id = None
        # one in-flight registration: (root_id, padded ids, Fetch), applied
        # by _finish_registration at a later poll
        self._pending_reg = None
        # the registration program as CUDA graphs, per camera and bounds
        self._register_graphs: dict = {}
        if self.device.type == "cuda":
            self._capture_register_program()
        # why registration / loop-closure attempts succeeded or died
        self.counters = Counter()
        self.per_mon = None

    def _on_stream(self):
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else nullcontext())

    # -- thread body ----------------------------------------------------- #
    def step(self) -> bool:
        """One poll iteration of the backend loop (backend.cpp:157-224).
        Returns True if any work was done."""
        with self._on_stream():
            return self._step()

    def _step(self) -> bool:
        did = False
        # adopt a landed async BA solve before new work
        if self.graph.adopt_pending():
            did = True
        pkt = self.monitor.getKeyframe()
        if pkt is not None:
            self.add_keyframe_packet(pkt)
            did = True

        qid = self.monitor.getQueryFrameId()
        if (qid is not None and qid not in self.graph.vertices
                and self.graph.vertices):
            # the pipelined frontend queries a new actkey before its packet
            # lands: serve the query at the newest inserted keyframe (its
            # direct covis parent, the same map region)
            self.counters["query_served_at_ancestor"] += 1
            qid = max(self.graph.vertices)
        if qid is not None and qid in self.graph.vertices:
            # device budget: the host-side window prepare + neighborhood
            # answer run on every dirty query; only the solve and the
            # registration are throttled by MIN_SOLVE_PERIOD_S
            self._query_count = getattr(self, "_query_count", 0) + 1
            dirty = getattr(self, "_graph_dirty", True)
            now = time.monotonic()
            budget_ok = (now - getattr(self, "_last_solve_t", 0.0)
                         >= self.MIN_SOLVE_PERIOD_S)
            # idle refinement every 24 queries; graph-changing events always
            # solve via the dirty flag (budget permitting)
            if dirty or self._query_count % 24 == 0:
                pm = self.per_mon
                if pm is not None:
                    pm.start("back end")
                if self.graph.prepare_for_optimization(qid):
                    self.counters["prepare_ok"] += 1
                    if self.monitor.want_draw_data:
                        self.monitor.pushDrawData(self.draw_data())
                    nb = self.compute_neighborhood(qid)
                    self.monitor.pushNeighborhood(nb)
                    if budget_ok:
                        self.local_registration_stack.append(qid)
                        # async dispatch, adopted at a later poll
                        self.graph.optimize(num_iters=2, huber=3.0,
                                            sync=False)
                        self._graph_dirty = False
                        self._last_solve_t = now
                    else:
                        self.counters["solve_deferred_budget"] += 1
                else:
                    self.counters[
                        "prepare_fail:" + self.graph.last_prepare_fail] += 1
                if pm is not None:
                    pm.stop("back end")
            did = True

        # apply a landed async registration
        if self._pending_reg is not None and self._pending_reg[2].done():
            self._finish_registration()
            did = True

        # a registration mutates the graph and would force-adopt the solve
        # in flight: wait until it landed; at most one registration in flight
        if (self.local_registration_stack
                and not self.graph.solve_pending()
                and self._pending_reg is None):
            fid = self.local_registration_stack.pop()
            self.local_register_frame(fid)
            did = True

        if self.place_monitor is not None:
            loop = self.place_monitor.getLoop()
            if loop is not None:
                self.global_loop_closure(loop)
                did = True
        return did

    def run(self, stop_event):
        """Thread entry point (parity: Backend::operator())."""
        ctx = (torch.cuda.device(self.device) if self.device.type == "cuda"
               else nullcontext())
        with ctx:
            self.working = False
            while not stop_event.is_set():
                self.working = True
                did = self.step()
                self.working = False
                if not did:
                    time.sleep(POLL_IDLE_S)

    # -- A: keyframe insertion ------------------------------------------- #
    def add_keyframe_packet(self, pkt):
        """Parity: addKeyframeToGraph (backend.cpp:389-404)."""
        if self.stream is not None:
            if getattr(pkt, "ready_event", None) is not None:
                self.stream.wait_event(pkt.ready_event)
            for x in _packet_tensors(pkt):
                if x.is_cuda:
                    x.record_stream(self.stream)
        self._graph_dirty = True
        self.keyframe_snapshots[pkt.kf_id] = {
            "pyr": pkt.pyr, "disp": pkt.disp, "T_kw": pkt.T_kw,
        }
        self._evict_snapshots()
        self._last_tables = (pkt.points_snapshot, pkt.poses_snapshot)
        if not self.graph.vertices:
            self.graph.add_first_keyframe(pkt.kf_id, pkt.T_kw)
            v = self.graph.vertices[pkt.kf_id]
            for i, pid in enumerate(pkt.new_point_ids):
                self.graph.points[int(pid)] = GraphPoint(
                    int(pid), np.asarray(pkt.new_psi[i], np.float64),
                    pkt.kf_id, int(pkt.new_levels[i]), {pkt.kf_id},
                )
                v.feature_table[int(pid)] = (
                    np.asarray(pkt.new_uvu[i], np.float64),
                    int(pkt.new_levels[i]),
                )
        else:
            # bulk-convert once; row views of the f64 arrays
            new_psi64 = np.asarray(pkt.new_psi, np.float64)
            new_uvu64 = np.asarray(pkt.new_uvu, np.float64)
            new_points = [
                (int(pid), new_psi64[i], int(pkt.new_levels[i]),
                 new_uvu64[i])
                for i, pid in enumerate(pkt.new_point_ids)
            ]
            tr_obs64 = np.asarray(pkt.tracked_obs, np.float64)
            tracked = [
                (int(pid), tr_obs64[i], int(pkt.tracked_levels[i]))
                for i, pid in enumerate(pkt.tracked_point_ids)
            ]
            oldkey = self.prev_kf_id if self.prev_kf_id is not None else (
                max(self.graph.vertices)
            )
            self.graph.add_keyframe(
                pkt.kf_id, pkt.T_kw, new_points, tracked,
                pkt.covis_strengths, oldkey,
            )
        self.prev_kf_id = pkt.kf_id
        # forward to place recognition (backend.cpp:407-430)
        if self.place_monitor is not None and pkt.pyr is not None:
            exclude = set(pkt.covis_strengths) | {pkt.kf_id}
            self.place_monitor.addKeyframeData(
                {
                    "kf_id": pkt.kf_id,
                    "img": pkt.pyr[0],
                    "disp": pkt.disp,
                    "exclude": exclude,
                    "pr_packed": getattr(pkt, "pr_packed", None),
                }
            )

    def _evict_snapshots(self):
        """Bounded device memory: snapshots are only read back for the
        current root/query keyframe, so keep a recency window (the graph
        itself, host numpy, keeps everything)."""
        if len(self.keyframe_snapshots) > self.SNAPSHOT_KEEP:
            for k in sorted(self.keyframe_snapshots)[:-self.SNAPSHOT_KEEP]:
                del self.keyframe_snapshots[k]

    # -- B: neighborhood -------------------------------------------------- #
    def compute_neighborhood(self, root_id: int) -> dict:
        """Root + <=10 strongest covisible neighbors inside the double window,
        their points, optimized poses, and inter-neighbor strengths
        (parity: Backend::computeNeighborhood, backend.cpp:244-386)."""
        g = self.graph
        v_root = g.vertices[root_id]
        nbrs = [
            n for n in sorted(v_root.neighbor_strengths,
                              key=lambda k: -v_root.neighbor_strengths[k])
            if n in g.double_window
        ][:NB_MAX_NEIGHBORS]
        kf_ids = [root_id] + nbrs
        poses = {
            kf: (g.vertices[kf].R.copy(), g.vertices[kf].t.copy())
            for kf in kf_ids
        }
        point_ids, psi_ids, psi_vals = [], [], []
        for kf in kf_ids:
            for pid in g.vertices[kf].feature_table:
                if pid in g.points:
                    point_ids.append(pid)
                    p = g.points[pid]
                    if p.anchor_id in kf_ids:
                        psi_ids.append(pid)
                        psi_vals.append(p.psi)
        strengths = {
            (a, b): g.vertices[a].neighbor_strengths.get(b, 0)
            for a in kf_ids for b in kf_ids if a < b
        }
        return {
            "root": root_id,
            "kf_ids": kf_ids,
            "poses": poses,
            "point_ids": np.asarray(sorted(set(point_ids)), np.int64),
            "psi_ids": np.asarray(psi_ids, np.int64),
            "psi_vals": np.asarray(psi_vals, np.float64).reshape(-1, 3),
            "strengths": strengths,
        }

    def draw_data(self) -> dict:
        """Snapshot of the double window for visualization (parity surface:
        BackendDrawData, backend.h:35-44)."""
        g = self.graph
        return {
            "inner": [k for k, v in g.double_window.items() if v == INNER],
            "outer": [k for k, v in g.double_window.items() if v == OUTER],
            "active_points": len(g.active_points),
            "outer_points": len(g.outer_points),
            "edges": [
                (e.id1, e.id2, e.edge_type, e.is_marginalized())
                for e in g.edges.values()
            ],
            "poses": {k: (v.R.copy(), v.t.copy())
                      for k, v in g.vertices.items()},
        }

    # -- C: local registration (metric loop closure) ----------------------- #
    def local_register_frame(self, root_id: int) -> bool:
        """Parity: Backend::localRegisterFrame (backend.cpp:549-611):
        harvest points anchored in frames of the EXTENDED neighborhood that
        are not yet covisible with the root, re-match them against the root
        keyframe's image, align with motion-only BA, then add METRIC edges
        for neighbors passing a coverage test. The match + align is
        dispatched here and applied at a later poll."""
        g = self.graph
        if root_id not in g.vertices:
            return False
        if root_id not in self.keyframe_snapshots:
            self.counters["reg_snapshot_evicted"] += 1
            return False
        if self._last_tables is None:
            return False
        points_tab, poses_tab = self._last_tables

        v_root = g.vertices[root_id]
        direct = set(v_root.neighbor_strengths) | {root_id}
        extended = g.frames_in_neighborhood(
            root_id, len(g.double_window) + REG_EXTRA_FRAMES
        )
        cand_frames = [f for f in extended if f not in direct]
        self.counters["reg_attempts"] += 1
        if not cand_frames:
            self.counters["reg_no_candidate_frames"] += 1
            return False

        # candidate points: anchored at candidate frames, not already seen
        # by the root (backend.cpp:472-546)
        seen = set(v_root.feature_table)
        cand_ids = []
        for f in cand_frames:
            for pid in g.vertices[f].feature_table:
                p = g.points.get(pid)
                if p is not None and p.anchor_id == f and pid not in seen:
                    cand_ids.append(pid)
        if len(cand_ids) < g.covis_thr:
            self.counters["reg_too_few_candidates"] += 1
            return False
        cand_ids = np.asarray(sorted(set(cand_ids))[:CAND_CAP], np.int64)

        snap = self.keyframe_snapshots[root_id]
        ids, fut = self._match_and_align_dispatch(
            snap, v_root.T, cand_ids, points_tab, poses_tab
        )
        self._pending_reg = (root_id, ids, fut)
        return True

    def _finish_registration(self) -> bool:
        """Consume a landed registration fetch: unpack, gate, and apply the
        graph mutation (the tail of Backend::localRegisterFrame,
        backend.cpp:614-722)."""
        root_id, ids, fut = self._pending_reg
        self._pending_reg = None
        g = self.graph
        if root_id not in g.vertices:
            return False
        matched_ids, matched_obs, matched_levels, T_new = \
            self._match_and_align_finish(ids, fut.result())
        if matched_ids is None or len(matched_ids) < g.covis_thr:
            self.counters["reg_match_failed"] += 1
            return False

        # per-anchor strength + quadrant coverage filter (backend.cpp:614-722)
        anchors_l = []
        keep = np.zeros(len(matched_ids), bool)
        for i, p in enumerate(matched_ids):
            pt = g.points.get(int(p))
            anchors_l.append(pt.anchor_id if pt is not None else -1)
            keep[i] = pt is not None
        anchors = np.asarray(anchors_l)
        matched_ids = matched_ids[keep]
        matched_obs = matched_obs[keep]
        matched_levels = matched_levels[keep]
        anchors = anchors[keep]
        strengths = {}
        w, h = self.cam.size
        for f in set(anchors.tolist()):
            if f < 0:
                continue
            sel = anchors == f
            uv = matched_obs[sel][:, :2]
            qx = (uv[:, 0] > w / 2).astype(int)
            qy = (uv[:, 1] > h / 2).astype(int)
            quads = np.unique(qy * 2 + qx)
            if int(sel.sum()) >= g.covis_thr and len(quads) >= 2:
                strengths[int(f)] = int(sel.sum())
        if not strengths:
            self.counters["reg_coverage_failed"] += 1
            return False

        tracked = [
            (int(pid), matched_obs[i], int(matched_levels[i]))
            for i, pid in enumerate(matched_ids)
            if int(anchors[i]) in strengths
        ]
        self.counters["reg_edges_added"] += len(strengths)
        g.register_keyframes(root_id, T_new, strengths, tracked)
        if g.prepare_for_optimization(root_id):
            g.optimize(num_iters=2, huber=3.0, sync=False)
        return True

    # -- D: global loop closure -------------------------------------------- #
    def global_loop_closure(self, loop: DetectedLoop) -> bool:
        """Parity: Backend::globalLoopClosure (backend.cpp:829-1001): verify
        the appearance loop by re-matching the loop keyframe's points in the
        query frame at the proposed pose; on success insert an APPEARANCE
        edge and optimize with the loop vertex teleported."""
        with self._on_stream():
            return self._global_loop_closure(loop)

    def _global_loop_closure(self, loop: DetectedLoop) -> bool:
        g = self.graph
        q, l = loop.query_id, loop.loop_id
        self.counters["glc_attempts"] += 1
        if q not in g.vertices or l not in g.vertices:
            self.counters["glc_unknown_vertex"] += 1
            return False
        if g.find_edge(q, l) is not None:
            # already connected — usually because METRIC local registration
            # reconnected first; a correct outcome
            self.counters["glc_already_connected"] += 1
            return False
        # skip if the loop kf is INNER (no information gain)
        if g.double_window.get(l) == INNER:
            self.counters["glc_loop_kf_inner"] += 1
            return False
        if q not in self.keyframe_snapshots or self._last_tables is None:
            self.counters["glc_no_snapshot"] += 1
            return False
        points_tab, poses_tab = self._last_tables

        # candidate points anchored at/near the loop keyframe
        cand_ids = [
            pid for pid in g.vertices[l].feature_table
            if pid in g.points and g.points[pid].anchor_id == l
        ]
        for nbr in g.vertices[l].neighbor_strengths:
            for pid in g.vertices[nbr].feature_table:
                if pid in g.points and g.points[pid].anchor_id == nbr:
                    cand_ids.append(pid)
        cand_ids = np.asarray(sorted(set(cand_ids))[:CAND_CAP], np.int64)
        if len(cand_ids) < MIN_LOOP_MATCHES:
            self.counters["glc_too_few_candidates"] += 1
            return False

        # proposed query pose in the LOOP's metric frame:
        # T_query_from_world' = T_query_from_loop * T_loop_from_world
        T_q_proposed = PoseRT.from_any(loop.T_query_from_loop) @ g.vertices[l].T
        snap = self.keyframe_snapshots[q]
        matched_ids, matched_obs, matched_levels, T_new = self._match_and_align(
            snap, T_q_proposed, cand_ids, points_tab, poses_tab
        )
        if matched_ids is None or len(matched_ids) < MIN_LOOP_MATCHES:
            self.counters["glc_match_failed"] += 1
            return False
        # quadrant coverage (backend.cpp:959-961)
        w, h = self.cam.size
        uv = matched_obs[:, :2]
        quads = np.unique(
            (uv[:, 1] > h / 2).astype(int) * 2 + (uv[:, 0] > w / 2).astype(int)
        )
        if len(quads) < 2:
            self.counters["glc_coverage_failed"] += 1
            return False

        # teleport LOOP vertex into the query's metric frame:
        # T_loop_from_world' = T_loop_from_query_new * T_query_from_world
        T_loop_new = (g.vertices[l].T @ T_q_proposed.inverse()) @ T_new
        tracked = [
            (int(pid), matched_obs[i], int(matched_levels[i]))
            for i, pid in enumerate(matched_ids)
        ]
        # observations are added on the LOOP vertex in the reference
        self.counters["glc_accepted"] += 1
        g.add_loop_closure(q, l, T_loop_new, tracked)
        self.monitor.pushClosedLoop((q, l))
        if g.prepare_for_optimization(q, loop_id=l):
            g.optimize(num_iters=2, huber=3.0, sync=False)
        return True

    # -- shared match+align ------------------------------------------------ #
    def _match_and_align_dispatch(self, snap, T_init, cand_ids,
                                  points_tab, poses_tab):
        """Dispatch the fused two-pass match + align (parity:
        Backend::matchAndAlign, backend.cpp:725-784) and start its packed
        download. Returns (padded ids, Fetch of the packed vector)."""
        pyr = snap["pyr"]
        disp = snap["disp"]
        dev = disp.device
        ids = np.full(CAND_CAP, -1, np.int64)
        n = min(len(cand_ids), CAND_CAP)
        ids[:n] = cand_ids[:n]
        ids_t = _upload(ids, dev)
        T0 = PoseRT.from_any(T_init)
        T0 = to_device_pose(np.asarray(T0.R, np.float32),
                            np.asarray(T0.t, np.float32), dev)
        packed = self._register_program(dev)(pyr, disp, T0.R, T0.t, ids_t,
                                             poses_tab, points_tab)
        return ids, Fetch(packed)

    def _register_program(self, dev):
        """The registration's device program: `_register_from_tables` on
        the fused program, as a CUDA graph replay on a card."""
        cam_key = tuple(
            (float(c.focal), float(c.pp[0]), float(c.pp[1]),
             float(c.baseline), int(c.size[0]), int(c.size[1]))
            for c in self.cams
        )
        key = (cam_key, 0.18, float(self.cfg.ui.max_reproj_error) * 2.0)
        fn = partial(_register_from_tables, _build_register_packed(*key))
        if dev.type != "cuda":
            return fn
        return self._register_graphs.setdefault((key, dev), GraphedFn(fn))

    def _capture_register_program(self):
        """Capture the registration's graph on the constructing thread, on
        empty tables and blank images of the frame step's shapes (a capture
        on the backend's thread would be broken by a device-wide
        synchronization on any other)."""
        dev = self.device
        w, h = self.cam.size
        img = torch.zeros((h, w), dtype=torch.float32, device=dev)
        self._register_program(dev)(
            build_pyramid(img, self.levels), img,
            torch.eye(3, dtype=torch.float32, device=dev),
            torch.zeros(3, dtype=torch.float32, device=dev),
            torch.full((CAND_CAP,), -1, dtype=torch.int64, device=dev),
            PoseTable.empty(device=dev), PointTable.empty(device=dev))

    @staticmethod
    def _match_and_align_finish(ids, packed):
        """Unpack a landed match+align fetch -> (ids, obs, levels, T) or
        Nones on a failed pass (either pass gating < 10 matches)."""
        C = CAND_CAP
        g1 = packed[0]
        gate = packed[1:1 + C] > 0.5
        obs_all = packed[1 + C:1 + 4 * C].reshape(C, 3)
        levels_arr = packed[1 + 4 * C:1 + 5 * C].astype(np.int64)
        R_new = packed[1 + 5 * C:1 + 5 * C + 9].reshape(3, 3)
        t_new = packed[1 + 5 * C + 9:1 + 5 * C + 12]
        if g1 < 10 or gate.sum() < 10:
            return None, None, None, None
        T_est = PoseRT(R_new.copy(), t_new.copy())
        sel = np.flatnonzero(gate)
        return ids[sel], obs_all[sel], levels_arr[sel], T_est

    def _match_and_align(self, snap, T_init, cand_ids, points_tab,
                         poses_tab):
        """Synchronous dispatch+finish (loop-closure verification)."""
        ids, fut = self._match_and_align_dispatch(
            snap, T_init, cand_ids, points_tab, poses_tab)
        return self._match_and_align_finish(ids, fut.result())


def _register_from_tables(fn, pyr, disp, R0, t0, ids_t, poses_tab,
                          points_tab):
    """The device side of one registration: the candidates materialized
    from the tables (ids padded with -1), then the fused program `fn`
    (`_build_register_packed`'s)."""
    xyz_w, R_aw, t_aw, patches, ok = materialize_points(poses_tab, points_tab,
                                                        ids_t)
    lvl_ids = points_tab.level[
        ids_t.clamp(0, points_tab.level.shape[0] - 1)].to(torch.int32)
    return fn(pyr, disp, R0, t0, xyz_w, R_aw, t_aw, patches, ok, lvl_ids,
              ids_t >= 0)


@lru_cache(maxsize=8)
def _build_register_packed(cam_key, zmssd_thr, reject_thresh):
    """The fused registration program for a camera pyramid (cached per
    camera): BOTH refine passes of matchAndAlign — per-level corner
    re-detection (prefiltered, mirroring the frame step), guided matching,
    and robust motion-only BA on its fixed-trip device loop — returning ONE
    packed vector [pass-1 gate count, gate, obs (uvu), point levels, R, t].

    ``cam_key`` is a tuple of per-level (focal, ppx, ppy, baseline, w, h).
    The second pass runs even when pass 1 failed (the host checks the pass-1
    gate count and discards the result): no host sync inside."""
    levels = len(cam_key)
    f0, ppx0, ppy0, b0, w0, h0 = cam_key[0]
    cam0 = StereoCamera.create(f0, (ppx0, ppy0), (w0, h0), b0)

    def fn(pyr, disp, R0, t0, xyz_w, R_aw, t_aw, patches, ok, lvl_ids,
           valid_ids):
        C = xyz_w.shape[0]
        dev = xyz_w.device
        T_est = SE3(R0, t0)
        lvl_w = 0.25 ** lvl_ids.to(torch.float32)
        # the corners depend on the image only: detected once, used by both
        # passes (the twin detects per pass; the corners are the same)
        buckets_l = [
            corner_buckets_prefiltered(
                pyr[lvl],
                threshold=10.0 / 255.0,
                cells_y=max(cam_key[lvl][5] // 8, 4),
                cells_x=max(cam_key[lvl][4] // 8, 4),
                per_cell=4,
            )
            for lvl in range(levels)
        ]
        for p, radius in enumerate((15.0, 6.0)):
            obs_dev = torch.zeros((C, 3), dtype=torch.float32, device=dev)
            matched_dev = torch.zeros(C, dtype=torch.bool, device=dev)
            for lvl in range(levels):
                fl, ppxl, ppyl, bl, wl, hl = cam_key[lvl]
                buckets = buckets_l[lvl]
                res = _match_level(
                    (fl, ppxl, ppyl, bl), (wl, hl),
                    pyr[lvl], T_est.R, T_est.t,
                    xyz_w, R_aw, t_aw, patches,
                    ok & (lvl_ids == lvl) & valid_ids,
                    buckets["uv"], buckets["valid"],
                    disp, lvl, zmssd_thr, radius,
                )
                obs_dev = torch.where(res.matched[:, None], res.obs_uvu,
                                      obs_dev)
                matched_dev = matched_dev | res.matched
            ba = motion_only_ba_robust(
                cam0, T_est, xyz_w, obs_dev, lvl_w * matched_dev,
                matched_dev, reject_thresh=reject_thresh,
            )
            T_est = ba.T
            gate = (matched_dev & ba.inlier_mask
                    & (torch.amax(torch.abs(ba.residuals), dim=-1)
                       < reject_thresh))
            if p == 0:
                g1_count = gate.sum().to(torch.float32)
        return torch.cat([
            g1_count[None], gate.to(torch.float32), obs_dev.reshape(-1),
            lvl_ids.to(torch.float32), T_est.R.reshape(-1), T_est.t,
        ])

    return fn
