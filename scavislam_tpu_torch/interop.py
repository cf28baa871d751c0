"""Carry SLAM state across from numpy arrays.

A SLAM system has no weights: its state is the pose and point tables, the
camera, the rolling dense-tracking state (per-level clouds, intensities,
valid masks and template Jacobians), the host bookkeeping of the frontend
and the backend's graph, and the place recognizer's vocabulary and index. These functions build the port's objects from that state given as
numpy arrays — the form a test gets from the JAX package with ``np.asarray``
— so both frameworks can be put in the same state and stepped side by side.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from scavislam_tpu_torch.core.camera import StereoCamera
from scavislam_tpu_torch.models.ba_solver import BAProblem
from scavislam_tpu_torch.models.map_store import PointTable, PoseTable
from scavislam_tpu_torch.models.placerec import Place, PlaceRecognizer
from scavislam_tpu_torch.models.slam_graph import (
    FeatureTable,
    GraphEdge,
    GraphPoint,
    GraphVertex,
)


def tensor(x, device=None, dtype=None) -> torch.Tensor:
    """numpy (or anything np.asarray takes) -> tensor on `device`."""
    return torch.as_tensor(np.array(x, copy=True), dtype=dtype, device=device)


def camera(focal, pp, size, baseline) -> StereoCamera:
    """StereoCamera from scalars (f32-rounded, as the JAX camera holds them)."""
    return StereoCamera.create(float(np.asarray(focal)), np.asarray(pp),
                               (int(size[0]), int(size[1])),
                               float(np.asarray(baseline)))


def pose_table(R, t, valid, device=None) -> PoseTable:
    """PoseTable from (K, 3, 3) R, (K, 3) t, (K,) valid."""
    return PoseTable(tensor(R, device, torch.float32),
                     tensor(t, device, torch.float32),
                     tensor(valid, device, torch.bool))


def point_table(psi, anchor, level, patch, uv0, valid, device=None) -> PointTable:
    """PointTable from the twin's fields (map_store.PointTable)."""
    return PointTable(tensor(psi, device, torch.float32),
                      tensor(anchor, device, torch.int32),
                      tensor(level, device, torch.int32),
                      tensor(patch, device, torch.float32),
                      tensor(uv0, device, torch.float32),
                      tensor(valid, device, torch.bool))


def dense_state(clouds, intens, valids, J, device=None):
    """Per-level rolling dense state: tuples (clouds, intens, valids, J)."""
    return (tuple(tensor(c, device, torch.float32) for c in clouds),
            tuple(tensor(i, device, torch.float32) for i in intens),
            tuple(tensor(v, device, torch.bool) for v in valids),
            tuple(tensor(j, device, torch.float32) for j in J))


def _load_map(fe, poses, points, R_cw, t_cw, actkey_id, next_kf, next_point,
              kf_point_ids, covis, pose_np, meta_anchor, meta_level,
              frame_id):
    """The state both frontends keep (``host_frontend.HostFrontend``): the
    device tables, the world pose of the chain (to be uploaded again), the
    keyframe bookkeeping and the point metadata."""
    fe.poses = poses
    fe.points = points
    fe._R_cw = np.asarray(R_cw, np.float32).copy()
    fe._t_cw = np.asarray(t_cw, np.float32).copy()
    fe._dev_R_cw = None
    fe._dev_t_cw = None
    fe.actkey_id = int(actkey_id)
    fe.next_kf = int(next_kf)
    fe.next_point = int(next_point)
    fe.kf_point_ids = {int(k): np.asarray(v, np.int64).copy()
                       for k, v in kf_point_ids.items()}
    fe.covis = {int(k): {int(a): int(c) for a, c in v.items()}
                for k, v in covis.items()}
    fe.pose_np = {int(k): (np.asarray(v[0], np.float32).copy(),
                           np.asarray(v[1], np.float32).copy())
                  for k, v in pose_np.items()}
    fe._meta_anchor = np.asarray(meta_anchor, np.int64).copy()
    fe._meta_level = np.asarray(meta_level, np.int64).copy()
    fe.frame_id = int(frame_id)
    fe._cand_np = None


def load_frontend_state(fe, *, poses, points, dense, R_cw, t_cw, R_cak, t_cak,
                        actkey_id, next_kf, next_point, kf_point_ids, covis,
                        pose_np, meta_anchor, meta_level, frame_id):
    """Put a port StereoFrontend into a given state: device tables (`poses`,
    `points` as PoseTable/PointTable), the dense state tuple from
    :func:`dense_state`, the world / actkey-relative pose, and the host
    bookkeeping (ids, covisibility, keyframe poses, point metadata)."""
    _load_map(fe, poses, points, R_cw, t_cw, actkey_id, next_kf, next_point,
              kf_point_ids, covis, pose_np, meta_anchor, meta_level,
              frame_id)
    (fe._prev_clouds, fe._prev_intens, fe._prev_valids, fe._prev_J) = dense
    fe._R_cak = np.asarray(R_cak, np.float32).copy()
    fe._t_cak = np.asarray(t_cak, np.float32).copy()
    return fe


def load_mono_state(fe, *, poses, points, Lam, R_cw, t_cw, actkey_id,
                    next_kf, next_point, kf_point_ids, kf_obs, covis,
                    pose_np, meta_anchor, meta_level, frame_id,
                    edge_constraints=None, kf_epoch=0, map_gen=0,
                    trajectory=None):
    """Put a port MonoFrontend into a given state: the device tables
    (`poses`, `points` as PoseTable/PointTable, `Lam` a (P, 3, 3) array),
    the world pose of the chain, and the host fields (ids, per-keyframe
    observations, covisibility, keyframe poses, point metadata, the
    counters, the frozen DWO constraints and the trajectory as
    (frame id, (R, t)) pairs)."""
    from scavislam_tpu_torch.core.lie import PoseRT

    dev = fe.device
    _load_map(fe, PoseTable(*(x.to(dev) for x in poses)),
              PointTable(*(x.to(dev) for x in points)), R_cw, t_cw,
              actkey_id, next_kf, next_point, kf_point_ids, covis, pose_np,
              meta_anchor, meta_level, frame_id)
    fe.Lam = tensor(Lam, dev, torch.float32)
    fe.kf_obs = {int(k): (np.asarray(v[0], np.int64).copy(),
                          np.asarray(v[1], np.float32).copy())
                 for k, v in kf_obs.items()}
    fe.edge_constraints = {
        (int(a), int(b)): tuple(np.asarray(x, np.float32).copy() for x in c)
        for (a, b), c in (edge_constraints or {}).items()}
    fe._kf_epoch = int(kf_epoch)
    fe._map_gen = int(map_gen)
    fe.trajectory = [(int(f), PoseRT.from_any(T))
                     for f, T in (trajectory or [])]
    fe._pending.clear()
    fe._pending_ba = None
    return fe


_BA_DTYPES = {
    "anchor_slot": torch.int32, "obs_pose": torch.int32,
    "obs_point": torch.int32, "edge_i": torch.int32, "edge_j": torch.int32,
    "pose_valid": torch.bool, "pose_fixed": torch.bool,
    "point_valid": torch.bool, "obs_valid": torch.bool,
    "edge_valid": torch.bool,
}


def ba_problem(device=None, **fields) -> BAProblem:
    """The port's BAProblem from the twin's fields as numpy arrays (every
    field of models.ba_solver.BAProblem, by name)."""
    return BAProblem(**{
        k: tensor(fields[k], device, _BA_DTYPES.get(k, torch.float32))
        for k in BAProblem._fields})


def load_graph_state(graph, vertices, points, edges, double_window,
                     active_points, outer_points):
    """Copy a twin SlamGraph's host state (its `vertices`, `points`,
    `edges`, `double_window`, `active_points` and `outer_points`, all numpy
    and dicts) into a port SlamGraph, keeping every container's order (the
    BA slots follow it), so that the same `optimize` runs side by side."""
    graph.vertices = {}
    for k, v in vertices.items():
        ft = FeatureTable()
        for pid, (uvu, lvl) in v.feature_table.items():
            ft[pid] = (np.array(uvu, np.float64), int(lvl))
        graph.vertices[k] = GraphVertex(
            int(v.own_id), np.array(v.R, np.float64),
            np.array(v.t, np.float64), ft, dict(v.neighbor_strengths))
    graph.points = {
        k: GraphPoint(int(p.own_id), np.array(p.psi, np.float64),
                      int(p.anchor_id), int(p.level), set(p.vis_set))
        for k, p in points.items()}
    graph.edges = {
        k: GraphEdge(
            e.id1, e.id2, e.strength, e.edge_type,
            None if e.R_1_from_2 is None else np.array(e.R_1_from_2),
            None if e.t_1_from_2 is None else np.array(e.t_1_from_2),
            None if e.Lambda is None else np.array(e.Lambda))
        for k, e in edges.items()}
    graph.double_window = dict(double_window)
    graph.active_points = set(active_points)
    graph.outer_points = set(outer_points)
    return graph


def vocabulary(vocab, device=None) -> torch.Tensor:
    """A (K, 128) BoW vocabulary (e.g. the ``vocab`` array of
    ``scavislam_tpu/data/vocabulary.npz``) as an f32 tensor on `device`."""
    return tensor(np.asarray(vocab, np.float32), device, torch.float32)


def _place(p) -> Place:
    return Place(
        int(p.kf_id), np.array(p.words, np.int64), np.array(p.desc, np.float32),
        np.array(p.uvd, np.float32), np.array(p.xyz, np.float32),
        {int(k) for k in p.exclude},
        padded=None if p.padded is None else (
            np.array(p.padded[0], np.float32), np.array(p.padded[1], np.float32),
            np.array(p.padded[2], bool)))


def place_recognizer(cam, vocab, location_map, inverted_index,
                     word_doc_count, device=None, **kwargs) -> PlaceRecognizer:
    """A port PlaceRecognizer holding a twin recognizer's index: its
    `location_map` (kf id -> Place with words, desc, uvd, xyz, exclude and
    the padded views), `inverted_index` (word -> {kf id: count}) and
    `word_doc_count`, all numpy and dicts, keeping every container's order;
    `kwargs` go to the constructor (monitor, thresholds, idf_mode)."""
    pr = PlaceRecognizer(cam, vocabulary(vocab, device), device=device,
                         **kwargs)
    pr.location_map = {int(k): _place(p) for k, p in location_map.items()}
    pr.inverted_index = defaultdict(dict, {
        int(w): {int(k): int(c) for k, c in post.items()}
        for w, post in inverted_index.items()})
    pr.word_doc_count = defaultdict(int, {
        int(w): int(c) for w, c in word_doc_count.items()})
    return pr
