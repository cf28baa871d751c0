"""Covisibility SLAM graph with Double Window Optimization (DWO) (port of
scavislam_tpu.models.slam_graph).

Each optimization touches only an inner window (full point BA) plus an outer
window (pose graph), with everything else frozen behind marginalized
relative constraints, so the per-keyframe cost is bounded.

Division of labour, as in the twin:
- the graph TOPOLOGY (vertices, covisibility edges, constraints, BFS
  windowing, marginalization bookkeeping, pose reinitialization) lives on the
  host in numpy and dicts, ported verbatim (same containers, same operation
  order, so both sides assign the same BA slots);
- the numerical SOLVE is the Schur BA of models.ba_solver on the device,
  over ONE packed f32 upload (the int32 section rides as a bit view) and ONE
  packed download.

``optimize(sync=False)`` returns after dispatch; the packed result comes
home through a :class:`Fetch` (pinned copy behind a CUDA event) and is
written back at the next ``adopt_pending()``. ``solve_log`` records each
adopted solve's device milliseconds, from a CUDA event recorded at dispatch
to the fetch's event (host wall time on the CPU). With ``solve_mesh`` (a
parallel.mesh.Mesh) the solve shards its observation axis over the mesh's
"sp" axis (models.ba_solver's ``sp_axis``): one packed upload to the first
"sp" device, one chunk of the observations per shard.

Deviation kept from the twin: the ROOT pose is fixed during each solve.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from scavislam_tpu_torch import resolve_device
from scavislam_tpu_torch.core.camera import StereoCamera
from scavislam_tpu_torch.core.lie import PoseRT
from scavislam_tpu_torch.models.ba_solver import BAProblem, solve_ba
from scavislam_tpu_torch.models.host_frontend import Fetch
from scavislam_tpu_torch.models.step_graph import GraphedFn

INNER = 1
OUTER = 2

LOCAL = 0
METRIC = 1
APPEARANCE = 2


def _se3_np(T):
    """Accept an SE3, a PoseRT or an (R, t) pair: float64 numpy (R, t)."""
    T = PoseRT.from_any(T)
    return np.asarray(T.R, np.float64), np.asarray(T.t, np.float64)


def _compose_np(R1, t1, R2, t2):
    """T1 * T2 in numpy."""
    return R1 @ R2, R1 @ t2 + t1


def _rel_np(R1, t1, R2, t2):
    """T1 * T2^-1 in numpy."""
    R = R1 @ R2.T
    return R, t1 - R @ t2


class FeatureTable(dict):
    """point_id -> (uvu, level) with a write-version counter so cached
    numpy views (GraphVertex.feat_arrays) invalidate on ANY write —
    including same-key overwrites, which len() alone would miss
    (register_keyframes can re-observe a point already in the table)."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.version = 0

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        self.version += 1


@dataclass
class GraphVertex:
    """Parity: SlamGraph::Vertex (slam_graph.hpp:65-97)."""

    own_id: int
    R: np.ndarray  # T_me_from_world
    t: np.ndarray
    feature_table: dict = field(default_factory=FeatureTable)
    neighbor_strengths: dict = field(default_factory=dict)  # nbr_id -> strength

    @property
    def T(self) -> PoseRT:
        """The pose at float32, as a host PoseRT (the twin's f32 SE3)."""
        return _pose_f32(self.R, self.t)

    def set_T(self, T):
        self.R, self.t = _se3_np(T)

    def feat_arrays(self):
        """(ids, uvu, level) of the feature table as numpy arrays, cached
        until the table's version changes (rebuilt O(K); the per-obs python
        loop this replaces in optimize() cost ~8 ms/keyframe)."""
        ft = self.feature_table
        ver = getattr(ft, "version", None)
        cache = getattr(self, "_feat_cache", None)
        if cache is None or ver is None or cache[0] != ver:
            n = len(ft)
            ids = np.fromiter(ft.keys(), np.int64, n)
            uvu = (np.stack([v[0] for v in ft.values()])
                   if n else np.zeros((0, 3), np.float64))
            lvl = np.fromiter((v[1] for v in ft.values()), np.int64, n)
            cache = (ver, ids, uvu, lvl)
            self._feat_cache = cache
        return cache[1], cache[2], cache[3]


@dataclass
class GraphPoint:
    """Parity: SlamGraph::Point (slam_graph.hpp:102-137)."""

    own_id: int
    psi: np.ndarray  # inverse-depth in anchor frame
    anchor_id: int
    level: int
    vis_set: set = field(default_factory=set)


@dataclass
class GraphEdge:
    """Parity: SlamGraph::Edge (slam_graph.hpp:143-190). Constraint stores
    T_1_from_2 for the ORDERED pair (id1 < id2) plus its information."""

    id1: int
    id2: int
    strength: int
    edge_type: int
    # marginalized constraint; None while the edge is inside the inner window
    R_1_from_2: Optional[np.ndarray] = None
    t_1_from_2: Optional[np.ndarray] = None
    Lambda: Optional[np.ndarray] = None

    def is_marginalized(self):
        return self.R_1_from_2 is not None


@dataclass
class _PendingSolve:
    """One in-flight device BA solve (optimize(sync=False)). The packed
    result comes home through a `_SolveFetch`; `pose_pre`/`psi_pre` snapshot
    the float64 state at dispatch so late adoption after a rebase can be
    applied as a correction instead of a stale overwrite."""

    future: object  # _SolveFetch -> (packed float32 result, solve seconds)
    slot_of: dict  # kf_id -> pose slot
    pslot: dict  # point_id -> point slot
    pose_pre: dict  # kf_id -> (R(3,3) f64, t(3,) f64) at dispatch
    psi_pre: dict  # point_id -> psi(3,) f64 at dispatch
    dims: tuple  # (P, L)
    t_dispatch: float
    n_vertices: int  # map size at dispatch (constant-time evidence axis)


class SlamGraph:
    def __init__(
        self,
        cam: StereoCamera,
        covis_thr: int = 15,
        inner_window_size: int = 15,
        double_window_size: int = 115,
        ba_capacity=(128, 2048, 8192, 512),
        solve_device=None,
        solve_mesh=None,
        device=None,
    ):
        self.cam = cam
        # where the DWO solve runs: `solve_device` (a torch device, e.g. a
        # sibling card) when given, else `device` (the card by default; a
        # RuntimeError without one unless device="cpu")
        self.device = resolve_device(device)
        self.solve_device = (torch.device(solve_device)
                             if solve_device is not None else None)
        # a Mesh: shard the solve's observation axis over its "sp" axis
        # (_sharded_packed_solver). Mutually exclusive with solve_device.
        self.solve_mesh = solve_mesh
        self.covis_thr = covis_thr
        self.inner_window_size = inner_window_size
        self.double_window_size = double_window_size
        self.vertices: dict[int, GraphVertex] = {}
        self.points: dict[int, GraphPoint] = {}
        self.edges: dict[tuple, GraphEdge] = {}
        self.double_window: dict[int, int] = {}
        self.active_points: set = set()
        self.outer_points: set = set()
        self._caps = ba_capacity
        self.stats = {"calc_time": 0.0, "chi2_init": 0.0, "chi2_final": 0.0}
        # every adopted solve appends (n_vertices_at_dispatch, solve_ms):
        # solve_ms is the device time from a CUDA event recorded at dispatch
        # to the result fetch's event (queue + solve + download) —
        # independent of when the backend polls adopt_pending(). On the CPU
        # it is the host time of the (synchronous) solve.
        self.solve_log: list = []
        # why the last prepare_for_optimization returned False (observability
        # for the constant-time benchmark; reference's prepare cannot fail)
        self.last_prepare_fail = ""
        # async-solve state: at most ONE solve in flight (see optimize)
        self._pending: Optional[_PendingSolve] = None
        self.last_problem = None
        # the single-device solve on a card as a CUDA graph, captured here,
        # on the constructing thread: a capture on the backend's thread
        # would be broken by a device-wide synchronization on any other
        self._solve_graph = GraphedFn(_solve_packed_flat)
        dev = self.solve_device or self.device
        if dev.type == "cuda" and solve_mesh is None:
            self._solve_graph(
                self._cam_params(),
                torch.zeros(_problem_len(self._caps), device=dev),
                self._caps, 2, 3.0)

    def _cam_params(self):
        return (self.cam.focal, self.cam.pp[0], self.cam.pp[1],
                self.cam.baseline)

    # -- edge table (parity: EdgeTable, slam_graph.hpp:197-363) ---------- #
    @staticmethod
    def _key(a, b):
        return (a, b) if a < b else (b, a)

    def find_edge(self, a, b) -> Optional[GraphEdge]:
        return self.edges.get(self._key(a, b))

    def insert_edge(self, a, b, strength, edge_type):
        k = self._key(a, b)
        assert k not in self.edges
        self.edges[k] = GraphEdge(k[0], k[1], strength, edge_type)

    def set_constraint(self, a, b, T_a_from_b, Lambda: np.ndarray):
        """Store constraint in the ordered direction (id1_from_id2).
        ``T_a_from_b`` is a numpy (R, t) pair (host math stays off-device)."""
        k = self._key(a, b)
        e = self.edges[k]
        R, t = _se3_np(T_a_from_b)
        if a != k[0]:
            R, t = R.T, -(R.T @ t)
        e.R_1_from_2, e.t_1_from_2 = R, t
        e.Lambda = np.asarray(Lambda, np.float64)

    def unmarginalize(self, a, b):
        e = self.edges[self._key(a, b)]
        e.R_1_from_2 = None
        e.t_1_from_2 = None
        e.Lambda = None

    def get_constraint(self, id1, id2):
        """Numpy (R, t) of T_id1_from_id2 if the edge is marginalized."""
        e = self.find_edge(id1, id2)
        if e is None or not e.is_marginalized():
            return None
        R, t = e.R_1_from_2, e.t_1_from_2
        if id1 == e.id1:
            return R, t
        return R.T, -(R.T @ t)

    # -- graph construction --------------------------------------------- #
    def add_first_keyframe(self, kf_id: int, T_kw=None):
        assert not self.vertices
        if T_kw is None:
            T_kw = (np.eye(3), np.zeros(3))
        v = GraphVertex(kf_id, *_se3_np(T_kw))
        self.vertices[kf_id] = v

    def add_keyframe(
        self,
        kf_id: int,
        T_kw,
        new_points: list,  # [(point_id, psi(3,), level, uvu(3,))]
        tracked: list,  # [(point_id, uvu(3,), level)]
        strengths: dict,  # neighbor kf_id -> shared count
        oldkey_id: int,
    ):
        """Parity: addKeyframe (slam_graph.cpp:143-186)."""
        self.finish_pending()
        v = GraphVertex(kf_id, *_se3_np(T_kw))
        strengths = dict(strengths)
        # floor the strength to oldkey (slam_graph.cpp:168-175)
        strengths[oldkey_id] = max(strengths.get(oldkey_id, 0), self.covis_thr)

        # new points anchored here (addNewPointsToMap, 358-397).
        # np.asarray on an already-f64 row view is a no-op reference — the
        # backend bulk-converts (add_keyframe_packet), so this loop does no
        # per-element array construction on the hot insert path.
        for pid, psi, level, uvu in new_points:
            self.points[pid] = GraphPoint(
                pid, np.asarray(psi, np.float64), kf_id, int(level), {kf_id}
            )
            v.feature_table[pid] = (np.asarray(uvu, np.float64), int(level))

        # observations of old points (addNewObsToOldPoints, 400-420)
        for pid, uvu, level in tracked:
            if pid in self.points:
                self.points[pid].vis_set.add(kf_id)
                v.feature_table[pid] = (np.asarray(uvu, np.float64), int(level))

        self.vertices[kf_id] = v

        # edges + immediate constraint marginalization (addNewEdges, 423-464)
        for nbr, s in strengths.items():
            if nbr not in self.vertices or s < self.covis_thr:
                continue
            v.neighbor_strengths[nbr] = s
            self.vertices[nbr].neighbor_strengths[kf_id] = s
            if self.find_edge(kf_id, nbr) is None:
                self.insert_edge(kf_id, nbr, s, LOCAL)
                T_c, Lam = self._compute_constraint(kf_id, nbr)
                self.set_constraint(kf_id, nbr, T_c, Lam)

    def register_keyframes(self, root_id: int, T_newroot_from_w,
                           strengths: dict, tracked: list):
        """Metric local registration (slam_graph.cpp:188-205): add obs + METRIC
        edges with the root temporarily teleported to its re-registered pose."""
        self.finish_pending()
        v = self.vertices[root_id]
        saved = (v.R.copy(), v.t.copy())
        v.R, v.t = _se3_np(T_newroot_from_w)
        for pid, uvu, level in tracked:
            if pid in self.points:
                self.points[pid].vis_set.add(root_id)
                v.feature_table[pid] = (np.asarray(uvu, np.float64), int(level))
        for nbr, s in strengths.items():
            if nbr not in self.vertices or s < self.covis_thr:
                continue
            v.neighbor_strengths[nbr] = max(
                v.neighbor_strengths.get(nbr, 0), s
            )
            self.vertices[nbr].neighbor_strengths[root_id] = (
                v.neighbor_strengths[nbr]
            )
            if self.find_edge(root_id, nbr) is None:
                self.insert_edge(root_id, nbr, s, METRIC)
                T_c, Lam = self._compute_constraint(root_id, nbr)
                self.set_constraint(root_id, nbr, T_c, Lam)
        v.R, v.t = saved

    def add_loop_closure(self, root_id: int, loop_id: int,
                         T_newloop_from_w, tracked: list):
        """Appearance loop closure (slam_graph.cpp:207-251): constraint
        computed with the loop vertex teleported into the query's metric
        frame."""
        self.finish_pending()
        strength = len(tracked)
        v_loop = self.vertices[loop_id]
        v_root = self.vertices[root_id]
        for pid, uvu, level in tracked:
            if pid in self.points:
                self.points[pid].vis_set.add(loop_id)
                v_loop.feature_table[pid] = (
                    np.asarray(uvu, np.float64), int(level)
                )
        v_loop.neighbor_strengths[root_id] = strength
        v_root.neighbor_strengths[loop_id] = strength
        if self.find_edge(root_id, loop_id) is None:
            self.insert_edge(root_id, loop_id, strength, APPEARANCE)
        saved = (v_loop.R.copy(), v_loop.t.copy())
        v_loop.R, v_loop.t = _se3_np(T_newloop_from_w)
        T_c, Lam = self._compute_constraint(loop_id, root_id)
        self.set_constraint(loop_id, root_id, T_c, Lam)
        v_loop.R, v_loop.t = saved

    # -- constraint heuristic -------------------------------------------- #
    def _compute_constraint(self, id1, id2):
        """Parity: computeConstraint (slam_graph.cpp:785-846):
        T_1_from_2 from current estimates; Lambda = strength * diag(
        (350*|t|/median_depth)^2 * I3, 100^2 * I3)."""
        v1, v2 = self.vertices[id1], self.vertices[id2]
        R12, t12 = _rel_np(v1.R, v1.t, v2.R, v2.t)
        depths = []
        for pid in v1.feature_table:
            if pid not in v2.feature_table or pid not in self.points:
                continue
            p = self.points[pid]
            T_aw = self._pose_of(p.anchor_id)
            xyz_a = _invert_depth_np(p.psi)
            xyz_w = _apply_np(_inv_np(T_aw), xyz_a)
            xyz_1 = _apply_np((v1.R, v1.t), xyz_w)
            depths.append(np.linalg.norm(xyz_1))
        visibility = max(len(depths), 1)
        med = float(np.median(depths)) if depths else 1.0
        med = max(med, 1e-6)
        norm_dist = float(np.linalg.norm(t12)) / med
        Lam = np.eye(6) * visibility
        Lam[:3, :3] *= (350.0 * norm_dist) ** 2
        Lam[3:, 3:] *= 100.0**2
        return (R12, t12), Lam

    def _pose_of(self, kf_id):
        if kf_id in self.vertices:
            v = self.vertices[kf_id]
            return (v.R, v.t)
        raise KeyError(kf_id)

    # -- windows ---------------------------------------------------------- #
    def _compute_double_window(self, root_id):
        """BFS by covis strength (strongest first), first `inner` become
        INNER (slam_graph.cpp:555-596)."""
        dw = {}
        q = deque([root_id])
        while q and len(dw) < self.double_window_size:
            vid = q.popleft()
            if vid in dw or vid not in self.vertices:
                continue
            dw[vid] = INNER if len(dw) < self.inner_window_size else OUTER
            v = self.vertices[vid]
            for nbr in sorted(v.neighbor_strengths,
                              key=lambda k: -v.neighbor_strengths[k]):
                q.append(nbr)
        return dw

    def _active_points(self):
        """Active points + outer-window extension to anchors
        (slam_graph.cpp:599-663)."""
        active, outer_pts = set(), set()
        extend = {}
        for fid, wtype in self.double_window.items():
            v = self.vertices[fid]
            if wtype == INNER:
                for pid in v.feature_table:
                    if pid in active or pid not in self.points:
                        continue
                    p = self.points[pid]
                    if p.anchor_id in self.double_window:
                        active.add(pid)
                    elif self.find_edge(fid, p.anchor_id) is not None:
                        active.add(pid)
                        extend[p.anchor_id] = OUTER
            else:
                for pid in v.feature_table:
                    outer_pts.add(pid)
        self.double_window.update(extend)
        self.active_points = active
        self.outer_points = outer_pts - active

    def _reinitialize_poses(self, root_id, old_window, loop_id=-1):
        """BFS from root; poses newly entering the window (or downstream of
        the loop vertex) are re-chained through relative constraints
        (slam_graph.cpp:665-725)."""
        q = deque([(root_id, -1, None, False)])
        visited = set()
        while q:
            own, parent, T_parent, mark = q.popleft()
            if own in visited or own not in self.double_window:
                continue
            visited.add(own)
            v = self.vertices[own]
            reinit_childs = mark or own == loop_id
            if parent > -1 and (reinit_childs or own not in old_window):
                R_rel, t_rel = self._relative_pose(own, parent)
                Rp, tp = T_parent
                v.R, v.t = _compose_np(R_rel, t_rel, Rp, tp)
            for nbr in sorted(v.neighbor_strengths,
                              key=lambda k: -v.neighbor_strengths[k]):
                q.append((nbr, own, (v.R, v.t), reinit_childs))

    def _relative_pose(self, id1, id2):
        """Numpy (R, t) of T_1_from_2 from the marginalized constraint if
        present, else from current estimates (slam_graph.cpp:270-286)."""
        T = self.get_constraint(id1, id2)
        if T is not None:
            return T
        v1, v2 = self.vertices[id1], self.vertices[id2]
        return _rel_np(v1.R, v1.t, v2.R, v2.t)

    def _unmarginalize_inner(self):
        for i in self.double_window:
            if self.double_window[i] != INNER:
                continue
            for j in self.double_window:
                if i == j or self.double_window[j] != INNER:
                    continue
                e = self.find_edge(i, j)
                if e is not None and e.is_marginalized():
                    self.unmarginalize(i, j)

    def _marginalize_leaving(self, old_window):
        """Edges whose both ends were INNER but are no longer both INNER get a
        fresh constraint (slam_graph.cpp:848-904)."""
        for i, w1 in old_window.items():
            if w1 != INNER:
                continue
            for j, w2 in old_window.items():
                if i == j or w2 != INNER:
                    continue
                e = self.find_edge(i, j)
                if e is None:
                    continue
                now_i = self.double_window.get(i) == INNER
                now_j = self.double_window.get(j) == INNER
                if not (now_i and now_j) and not e.is_marginalized():
                    T_c, Lam = self._compute_constraint(i, j)
                    self.set_constraint(i, j, T_c, Lam)

    def prepare_for_optimization(self, root_id: int, loop_id: int = -1) -> bool:
        """Parity: prepareForOptimization (slam_graph.cpp:288-310)."""
        self.finish_pending()
        old_window = dict(self.double_window)
        self.double_window = self._compute_double_window(root_id)
        self._active_points()
        self._reinitialize_poses(root_id, old_window, loop_id)
        if len(self.double_window) < 2:
            # only failure mode: the BFS from root reached nothing — either
            # the map has a single vertex, or root has no covis links yet
            # (a query racing its own keyframe's edge insertion)
            ns = len(self.vertices[root_id].neighbor_strengths) \
                if root_id in self.vertices else -1
            self.last_prepare_fail = (
                "single_vertex_map" if len(self.vertices) < 2
                else "root_has_no_covis_links" if ns == 0
                else f"window_degenerate(nbrs={ns})")
            self.double_window = old_window
            return False
        self.last_prepare_fail = ""
        self._unmarginalize_inner()
        self._marginalize_leaving(old_window)
        self._root_id = root_id
        return True

    def _select_window_overflow(self, window_ids, P):
        """Strongest-first selection at P-overflow (the outer anchor
        extension in `_active_points` can push the window past the BA pose
        cap): root first, then INNER in BFS order (already strongest-first,
        slam_graph.cpp:555-596), then OUTER ranked by its strongest covis
        link into the inner set. Points anchored at a dropped vertex fall
        out of the active set in `optimize`."""
        root = getattr(self, "_root_id", window_ids[0])
        inner = [k for k in window_ids
                 if self.double_window[k] == INNER and k != root]
        outer = [k for k in window_ids
                 if self.double_window[k] != INNER and k != root]
        inner_set = set(inner) | {root}

        def link_strength(k):
            ns = self.vertices[k].neighbor_strengths
            return max((ns.get(i, 0) for i in inner_set), default=0)

        outer.sort(key=link_strength, reverse=True)
        head = [root] if root in self.double_window else []
        return (head + inner + outer)[:P]

    # -- optimization ------------------------------------------------------ #
    def optimize(self, num_iters: int = 2, huber: float = 3.0,
                 sync: bool = True):
        """Build the static-shape BAProblem from the current double window and
        run the device Schur solver; write results back.
        Parity: optimize + copyDataToG2o (slam_graph.cpp:319-355, 907-1080).

        With ``sync=False`` the call returns right after dispatch: the device
        solve and the result download overlap with whatever the caller does
        next, and the write-back happens at the next `adopt_pending()` (on
        the CPU the solve itself runs inside this call) — the backend adopts
        one poll later,
        which matches the reference's information flow (the optimized poses
        only reach the frontend through the NEXT neighborhood answer,
        backend.cpp:173-189). Graph-mutating methods force-adopt first, so
        asynchrony never reorders graph updates."""
        self.finish_pending()
        P, L, O, E = self._caps
        window_ids = list(self.double_window.keys())
        if len(window_ids) < 2:
            return
        if len(window_ids) > P:
            window_ids = self._select_window_overflow(window_ids, P)
        slot_of = {kf: i for i, kf in enumerate(window_ids)}

        R = np.zeros((P, 3, 3), np.float32)
        R[:, 0, 0] = R[:, 1, 1] = R[:, 2, 2] = 1.0
        t = np.zeros((P, 3), np.float32)
        pose_valid = np.zeros(P, bool)
        pose_fixed = np.zeros(P, bool)
        for kf, i in slot_of.items():
            v = self.vertices[kf]
            R[i] = v.R
            t[i] = v.t
            pose_valid[i] = True
        root = getattr(self, "_root_id", window_ids[0])
        pose_fixed[slot_of.get(root, 0)] = True

        psi = np.zeros((L, 3), np.float32)
        anchor_slot = np.zeros(L, np.int32)
        point_valid = np.zeros(L, bool)
        active = [
            pid for pid in self.active_points
            if self.points[pid].anchor_id in slot_of
        ]
        active = active[:L]
        pslot = {}
        for i, pid in enumerate(active):
            p = self.points[pid]
            psi[i] = p.psi
            anchor_slot[i] = slot_of[p.anchor_id]
            point_valid[i] = True
            pslot[pid] = i

        obs_pose = np.zeros(O, np.int32)
        obs_point = np.zeros(O, np.int32)
        obs_uvu = np.zeros((O, 3), np.float32)
        obs_w = np.ones(O, np.float32)
        obs_valid = np.zeros(O, bool)
        # vectorized per-vertex assembly from the cached feature arrays
        # (the per-observation python loop cost ~8 ms/keyframe at 6k obs)
        pid_cap = (max(active) + 1) if active else 1
        pslot_arr = np.full(pid_cap, -1, np.int32)
        if active:
            pslot_arr[np.fromiter(active, np.int64, len(active))] = (
                np.arange(len(active), dtype=np.int32))
        n_obs = 0
        for kf, slot in slot_of.items():
            if n_obs >= O:
                break
            ids, uvus, lvls = self.vertices[kf].feat_arrays()
            if not len(ids):
                continue
            sl = np.where(ids < pid_cap,
                          pslot_arr[np.minimum(ids, pid_cap - 1)], -1)
            sel = np.nonzero(sl >= 0)[0][: O - n_obs]
            k = len(sel)
            if not k:
                continue
            obs_pose[n_obs:n_obs + k] = slot
            obs_point[n_obs:n_obs + k] = sl[sel]
            obs_uvu[n_obs:n_obs + k] = uvus[sel]
            obs_w[n_obs:n_obs + k] = 0.25 ** lvls[sel]
            obs_valid[n_obs:n_obs + k] = True
            n_obs += k

        e_i = np.zeros(E, np.int32)
        e_j = np.zeros(E, np.int32)
        e_R = np.zeros((E, 3, 3), np.float32)
        e_R[:, 0, 0] = e_R[:, 1, 1] = e_R[:, 2, 2] = 1.0
        e_t = np.zeros((E, 3), np.float32)
        e_info = np.zeros((E, 6, 6), np.float32)
        e_valid = np.zeros(E, bool)
        n_e = 0
        # relative-pose edges where either end is OUTER
        # (copyContraintsToG2o, slam_graph.cpp:937-981)
        for (a, b), e in self.edges.items():
            if a not in slot_of or b not in slot_of or n_e >= E:
                continue
            w1 = self.double_window[a]
            w2 = self.double_window[b]
            if w1 != OUTER and w2 != OUTER:
                continue
            if not e.is_marginalized():
                continue
            # our BA edge stores T_j_from_i for pair (i=a, j=b);
            # edge constraint holds T_id1_from_id2 = T_a_from_b
            Rba, tba = self.get_constraint(b, a)
            e_i[n_e] = slot_of[a]
            e_j[n_e] = slot_of[b]
            e_R[n_e] = Rba
            e_t[n_e] = tba
            e_info[n_e] = e.Lambda
            e_valid[n_e] = True
            n_e += 1

        # sort observations by (observer slot, point), as the twin packs
        # them; the anchor-stream permutation rides in the same buffer (the
        # twin's sorted-scatter hint, accepted and unused by the port's
        # solver), so one buffer feeds both frameworks.
        order = np.lexsort((obs_point, obs_pose))
        obs_pose, obs_point = obs_pose[order], obs_point[order]
        obs_uvu, obs_w, obs_valid = obs_uvu[order], obs_w[order], obs_valid[order]
        aperm = np.lexsort((obs_point, anchor_slot[obs_point])).astype(np.int32)

        # pack the whole problem into ONE upload instead of BAProblem's 18
        # arrays. The int32 section is appended bit for bit (f32 view; the
        # device reads it back as an int32 view).
        ibuf = np.concatenate([
            anchor_slot, obs_pose, obs_point, e_i, e_j, aperm
        ]).astype(np.int32)
        buf = np.concatenate([
            R.reshape(-1), t.reshape(-1),
            pose_valid.astype(np.float32), pose_fixed.astype(np.float32),
            psi.reshape(-1), point_valid.astype(np.float32),
            obs_uvu.reshape(-1), obs_w, obs_valid.astype(np.float32),
            e_R.reshape(-1), e_t.reshape(-1), e_info.reshape(-1),
            e_valid.astype(np.float32),
            ibuf.view(np.float32),
        ])
        cam_params = self._cam_params()

        dev = (self.solve_mesh.axis("sp").devices[0]
               if self.solve_mesh is not None
               else self.solve_device or self.device)
        t0 = time.perf_counter()
        start = None
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            buf_dev = torch.from_numpy(buf).pin_memory().to(
                dev, non_blocking=True)
        else:
            buf_dev = torch.from_numpy(buf).to(dev)
        # the last problem dispatched, kept for timing the solve alone
        self.last_problem = (cam_params, buf_dev, (P, L, O, E))
        if self.solve_mesh is not None:
            solver = _sharded_packed_solver(
                self.solve_mesh, cam_params, (P, L, O, E), num_iters, huber)
            packed_dev = _pack_solution(*solver(buf_dev))
        else:  # a graph replay on a card (models/step_graph.py)
            solve = (self._solve_graph if dev.type == "cuda"
                     else _solve_packed_flat)
            packed_dev = solve(cam_params, buf_dev, (P, L, O, E), num_iters,
                               huber)
        self._pending = _PendingSolve(
            future=_SolveFetch(packed_dev, start, t0),
            slot_of=slot_of,
            pslot=pslot,
            pose_pre={kf: (self.vertices[kf].R.copy(),
                           self.vertices[kf].t.copy())
                      for kf in slot_of},
            psi_pre={pid: self.points[pid].psi.copy() for pid in pslot},
            dims=(P, L),
            t_dispatch=t0,
            n_vertices=len(self.vertices),
        )
        if sync:
            self.finish_pending()

    # -- async-solve adoption ---------------------------------------------- #
    def solve_pending(self) -> bool:
        return self._pending is not None

    def solve_ready(self) -> bool:
        return self._pending is not None and self._pending.future.done()

    def finish_pending(self):
        self.adopt_pending(force=True)

    def adopt_pending(self, force: bool = False) -> bool:
        """Write back the in-flight solve if its fetch has landed (or wait for
        it when ``force``). Write back (restoreDataFromG2o,
        slam_graph.cpp:1035-1080) is exact when nothing moved since dispatch —
        guaranteed inside the backend, whose graph-mutating entry points all
        force-adopt first; poses rebased in between (defensive path) receive
        the solve as a left-multiplied correction instead."""
        p = self._pending
        if p is None or (not force and not p.future.done()):
            return False
        self._pending = None
        packed, solve_wall = p.future.result()
        P, L = p.dims
        R_new = packed[: P * 9].reshape(P, 3, 3)
        t_new = packed[P * 9: P * 12].reshape(P, 3)
        psi_new = packed[P * 12: P * 12 + L * 3].reshape(L, 3)
        self.stats["calc_time"] = solve_wall
        if len(self.solve_log) < 65536:
            self.solve_log.append((p.n_vertices, solve_wall * 1e3))
        self.stats["chi2_init"] = float(packed[-2])
        self.stats["chi2_final"] = float(packed[-1])

        for kf, i in p.slot_of.items():
            v = self.vertices.get(kf)
            if v is None:
                continue
            R_pre, t_pre = p.pose_pre[kf]
            if np.array_equal(v.R, R_pre) and np.array_equal(v.t, t_pre):
                v.R = R_new[i].astype(np.float64)
                v.t = t_new[i].astype(np.float64)
            else:
                # T_corr = T_solved * T_pre^-1, applied LEFT of the current
                # pose; re-orthonormalized (composed f32-sourced rotations
                # drift — measured in the pipelined rebase path)
                Rc = R_new[i].astype(np.float64) @ R_pre.T
                tc = t_new[i].astype(np.float64) - Rc @ t_pre
                u, _, vt = np.linalg.svd(Rc @ v.R)
                v.t = Rc @ v.t + tc
                v.R = u @ vt
        for pid, i in p.pslot.items():
            pt = self.points.get(pid)
            if pt is None:
                continue
            psi_pre = p.psi_pre[pid]
            if np.array_equal(pt.psi, psi_pre):
                pt.psi = psi_new[i].astype(np.float64)
            else:
                pt.psi = pt.psi + (psi_new[i].astype(np.float64) - psi_pre)
        return True

    # -- queries ----------------------------------------------------------- #
    def compute_absolute_pose(self, kf_id: int) -> PoseRT:
        """Chain marginalized relative constraints from the double window to
        `kf_id` (slam_graph.cpp:762-782)."""
        self.adopt_pending()  # free freshness if the async fetch landed
        if kf_id in self.double_window:
            return self.vertices[kf_id].T
        # BFS from kf_id to the window
        q = deque([kf_id])
        parent = {kf_id: None}
        hit = None
        while q:
            vid = q.popleft()
            if vid in self.double_window:
                hit = vid
                break
            for nbr in self.vertices[vid].neighbor_strengths:
                if nbr not in parent:
                    parent[nbr] = vid
                    q.append(nbr)
        if hit is None:
            return self.vertices[kf_id].T
        # chain from the window vertex back to kf_id
        chain = [hit]
        while parent[chain[-1]] is not None:
            chain.append(parent[chain[-1]])
        # chain = [window vertex, ..., kf_id]; fold T_k_from_{k-1} left-to-right
        v0 = self.vertices[hit]
        R, t = v0.R.copy(), v0.t.copy()
        for k in range(1, len(chain)):
            Rr, tr = self._relative_pose(chain[k], chain[k - 1])
            R, t = _compose_np(Rr, tr, R, t)
        return _pose_f32(R, t)

    def frames_in_neighborhood(self, root_id: int, max_frames: int):
        """BFS by strength limited to max_frames (slam_graph.cpp:105-140)."""
        out = []
        q = deque([root_id])
        seen = set()
        while q and len(out) < max_frames:
            vid = q.popleft()
            if vid in seen or vid not in self.vertices:
                continue
            seen.add(vid)
            out.append(vid)
            v = self.vertices[vid]
            for nbr in sorted(v.neighbor_strengths,
                              key=lambda k: -v.neighbor_strengths[k]):
                q.append(nbr)
        return out


class _SolveFetch:
    """The packed solve result in flight: ``done()`` / ``result()`` ->
    (packed f32 numpy, solve seconds). On a card the seconds are device
    time between the dispatch event and the download's event; on the CPU,
    where the solve ran synchronously, the host time of the dispatch."""

    def __init__(self, packed: torch.Tensor, start, t0: float):
        self._fetch = Fetch(packed, timed=start is not None)
        self._start = start
        self._cpu_s = time.perf_counter() - t0

    def done(self) -> bool:
        return self._fetch.done()

    def result(self):
        out = self._fetch.result()
        if self._start is None:
            return out, self._cpu_s
        return out, self._start.elapsed_time(self._fetch.event) / 1e3


def _problem_len(caps) -> int:
    """The f32 length of one packed problem at capacities `caps` (the
    layout `_unpack_problem` reads)."""
    P, L, O, E = caps
    return 14 * P + 5 * L + 8 * O + 51 * E


def _unpack_problem(buf: torch.Tensor, caps):
    """Unpack the single transfer buffer into a (BAProblem, anchor_perm) on
    its device. The int32 section rides the same f32 buffer bit for bit
    (the host packs with ``.view(np.float32)``; read back as a bit view)."""
    P, L, O, E = caps
    n_int = L + 3 * O + 2 * E
    fbuf = buf[: buf.shape[0] - n_int]
    ibuf = buf[buf.shape[0] - n_int:].view(torch.int32)
    o = 0

    def take(n, shape=None):
        nonlocal o
        v = fbuf[o:o + n]
        o += n
        return v.reshape(shape) if shape else v

    R = take(P * 9, (P, 3, 3))
    t = take(P * 3, (P, 3))
    pose_valid = take(P) > 0.5
    pose_fixed = take(P) > 0.5
    psi = take(L * 3, (L, 3))
    point_valid = take(L) > 0.5
    obs_uvu = take(O * 3, (O, 3))
    obs_w = take(O)
    obs_valid = take(O) > 0.5
    e_R = take(E * 9, (E, 3, 3))
    e_t = take(E * 3, (E, 3))
    e_info = take(E * 36, (E, 6, 6))
    e_valid = take(E) > 0.5
    oi = 0

    def takei(n):
        nonlocal oi
        v = ibuf[oi:oi + n]
        oi += n
        return v

    anchor_slot = takei(L)
    obs_pose = takei(O)
    obs_point = takei(O)
    e_i = takei(E)
    e_j = takei(E)
    aperm = takei(O)
    prob = BAProblem(
        R, t, pose_valid, pose_fixed, psi, anchor_slot, point_valid,
        obs_pose, obs_point, obs_uvu, obs_w, obs_valid,
        e_i, e_j, e_R, e_t, e_info, e_valid,
    )
    return prob, aperm


def _solve_packed(cam_params, buf, caps, num_iters, huber):
    """Single-device packed DWO solve (see _unpack_problem)."""
    prob, aperm = _unpack_problem(buf, caps)
    return solve_ba(cam_params, prob, iters=num_iters, huber=huber,
                    anchor_perm=aperm)


def _pack_solution(R_new, t_new, psi_new, stats):
    """A solve's results as ONE vector, for one download:
    [R, t, psi, chi2_initial, chi2_final]."""
    return torch.cat([
        R_new.reshape(-1), t_new.reshape(-1), psi_new.reshape(-1),
        torch.stack([stats.chi2_initial, stats.chi2_final]),
    ])


def _solve_packed_flat(cam_params, buf, caps, num_iters, huber):
    """`_solve_packed` with its results packed (`_pack_solution`)."""
    return _pack_solution(*_solve_packed(cam_params, buf, caps, num_iters,
                                         huber))


def _sharded_packed_solver(mesh, cam_params, caps, num_iters, huber,
                           axis="sp"):
    """Mesh-sharded twin of `_solve_packed`: the packed problem buffer is
    uploaded once (to the axis's first device) and unpacked there; each
    shard takes its chunk of the OBSERVATION axis, builds partial normal
    equations, and their sum in shard order assembles the full Schur
    system, which is factorized on the first device. The twin's sorted
    anchor-scatter permutation is global to the obs axis and does not
    survive per-shard slicing, so the sharded path scatters unsorted (the
    port does so on every path). Returns solver(buf)."""
    group = mesh.axis(axis)
    n = group.size
    O_ = caps[2]
    if O_ % n:
        raise ValueError(
            f"obs capacity {O_} must divide the {axis}-axis size {n}")

    def solver(buf):
        prob, _ = _unpack_problem(buf, caps)
        return solve_ba(cam_params, prob, iters=num_iters, huber=huber,
                        sp_axis=group)

    return solver


def _pose_f32(R, t) -> PoseRT:
    return PoseRT(np.asarray(R, np.float32), np.asarray(t, np.float32))


# -- small numpy SE3 helpers ------------------------------------------------ #

def _invert_depth_np(psi):
    return np.array([psi[0] / psi[2], psi[1] / psi[2], 1.0 / psi[2]])


def _apply_np(Rt, x):
    R, t = Rt
    return R @ x + t


def _inv_np(Rt):
    R, t = Rt
    return (R.T, -R.T @ t)
