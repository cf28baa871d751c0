"""Map, system and trajectory checkpoints (port of
scavislam_tpu.utils.serialization).

The reference has no persistence (its g2o read/write methods are
assert(false) stubs, anchored_points.cpp:61-74); the twin saves and
restores the whole SLAM state as one compressed .npz, and this module does
the same with the twin's npz keys and JSON layout, so a file written by
either package loads in the other:

- ``save_graph`` / ``load_graph``: a SlamGraph (keyframe poses, anchored
  points with their observations, covisibility edges with marginalized
  constraints);
- ``save_system`` / ``load_system``: a SlamSystem (the graph under ``g_``
  keys, the frontend's device tables and host mirrors, the place
  recognizer's index and vocabulary); a loaded system starts in `lost`
  mode and localizes against the loaded map;
- ``save_mono_system`` / ``load_mono_system``: a MonoFrontend (the point,
  Lambda and pose tables, the host mirrors, the per-keyframe observations
  of the window BA, the trajectory, the scale-gauge parameters);
- ``save_trajectory_tum``: ``timestamp tx ty tz qx qy qz qw`` (T_wc) rows.

Tables are downloaded with ``.cpu()`` and uploaded to the loading object's
device.
"""

from __future__ import annotations

import io
import json

import numpy as np
import torch

from scavislam_tpu_torch.models.slam_graph import (
    GraphEdge,
    GraphPoint,
    GraphVertex,
    SlamGraph,
)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_graph(graph: SlamGraph, path):
    """Serialize a SlamGraph to .npz (arrays) + embedded JSON (topology)."""
    graph.finish_pending()  # adopt any in-flight solve first
    kf_ids = sorted(graph.vertices)
    R = (np.stack([graph.vertices[k].R for k in kf_ids]) if kf_ids
         else np.zeros((0, 3, 3)))
    t = (np.stack([graph.vertices[k].t for k in kf_ids]) if kf_ids
         else np.zeros((0, 3)))

    pt_ids = sorted(graph.points)
    psi = (np.stack([graph.points[p].psi for p in pt_ids]) if pt_ids
           else np.zeros((0, 3)))
    anchor = np.asarray([graph.points[p].anchor_id for p in pt_ids], np.int64)
    level = np.asarray([graph.points[p].level for p in pt_ids], np.int64)

    # observations: (kf, point, uvu, level)
    obs_kf, obs_pt, obs_uvu, obs_lvl = [], [], [], []
    for k in kf_ids:
        for pid, (uvu, lvl) in graph.vertices[k].feature_table.items():
            obs_kf.append(k)
            obs_pt.append(pid)
            obs_uvu.append(uvu)
            obs_lvl.append(lvl)

    edges = []
    e_R, e_t, e_lam = [], [], []
    for (a, b), e in sorted(graph.edges.items()):
        marg = e.is_marginalized()
        edges.append((a, b, e.strength, e.edge_type, int(marg)))
        if marg:
            e_R.append(e.R_1_from_2)
            e_t.append(e.t_1_from_2)
            e_lam.append(e.Lambda)
        else:
            e_R.append(np.eye(3))
            e_t.append(np.zeros(3))
            e_lam.append(np.zeros((6, 6)))

    meta = {
        "kf_ids": kf_ids,
        "pt_ids": pt_ids,
        "vis_sets": {str(p): sorted(graph.points[p].vis_set) for p in pt_ids},
        "strengths": {
            str(k): graph.vertices[k].neighbor_strengths for k in kf_ids},
        "covis_thr": graph.covis_thr,
        "inner_window_size": graph.inner_window_size,
        "double_window_size": graph.double_window_size,
    }
    np.savez_compressed(
        path,
        meta=json.dumps(meta),
        R=R, t=t, psi=psi, anchor=anchor, level=level,
        obs_kf=np.asarray(obs_kf, np.int64),
        obs_pt=np.asarray(obs_pt, np.int64),
        obs_uvu=np.asarray(obs_uvu, np.float64).reshape(-1, 3),
        obs_lvl=np.asarray(obs_lvl, np.int64),
        edges=np.asarray(edges, np.int64).reshape(-1, 5),
        e_R=np.asarray(e_R, np.float64).reshape(-1, 3, 3),
        e_t=np.asarray(e_t, np.float64).reshape(-1, 3),
        e_lam=np.asarray(e_lam, np.float64).reshape(-1, 6, 6),
    )


def load_graph(path, cam, device=None) -> SlamGraph:
    """A SlamGraph from ``save_graph``'s file, on `device` (the card by
    default)."""
    z = np.load(path, allow_pickle=False)
    meta = json.loads(str(z["meta"]))
    g = SlamGraph(cam, covis_thr=meta["covis_thr"],
                  inner_window_size=meta["inner_window_size"],
                  double_window_size=meta["double_window_size"],
                  device=device)
    for i, k in enumerate(meta["kf_ids"]):
        v = GraphVertex(int(k), z["R"][i].copy(), z["t"][i].copy())
        v.neighbor_strengths = {
            int(a): int(s) for a, s in meta["strengths"][str(k)].items()}
        g.vertices[int(k)] = v
    for i, p in enumerate(meta["pt_ids"]):
        g.points[int(p)] = GraphPoint(
            int(p), z["psi"][i].copy(), int(z["anchor"][i]),
            int(z["level"][i]), set(meta["vis_sets"][str(p)]))
    for kf, pt, uvu, lvl in zip(z["obs_kf"], z["obs_pt"], z["obs_uvu"],
                                z["obs_lvl"]):
        g.vertices[int(kf)].feature_table[int(pt)] = (uvu.copy(), int(lvl))
    for i, (a, b, s, et, marg) in enumerate(z["edges"]):
        e = GraphEdge(int(a), int(b), int(s), int(et))
        if marg:
            e.R_1_from_2 = z["e_R"][i].copy()
            e.t_1_from_2 = z["e_t"][i].copy()
            e.Lambda = z["e_lam"][i].copy()
        g.edges[(int(a), int(b))] = e
    return g


def save_trajectory_tum(trajectory, path: str):
    """TUM format: timestamp tx ty tz qx qy qz qw (T_wc), the interchange
    format of ATE evaluation tools."""
    from scavislam_tpu_torch.core.lie import PoseRT

    rows = []
    for fid, T_cw in trajectory:
        T_wc = PoseRT.from_any(T_cw).inverse()
        R = np.asarray(T_wc.R, np.float64)
        t = np.asarray(T_wc.t, np.float64)
        q = _quat_from_R(R)
        rows.append([float(fid), *t, q[1], q[2], q[3], q[0]])
    np.savetxt(path, np.asarray(rows), fmt="%.6f")


def _quat_from_R(R):
    """(w, x, y, z) from a rotation matrix (numerically safe branch set)."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        return np.array([
            0.25 * s,
            (R[2, 1] - R[1, 2]) / s,
            (R[0, 2] - R[2, 0]) / s,
            (R[1, 0] - R[0, 1]) / s,
        ])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
    q = np.zeros(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def _host_meta(fe) -> dict:
    """The frontend's host bookkeeping as JSON-ready values."""
    return {
        "next_kf": fe.next_kf,
        "next_point": fe.next_point,
        "actkey_id": fe.actkey_id,
        "kf_point_ids": {str(k): np.asarray(v).tolist()
                         for k, v in fe.kf_point_ids.items()},
        "covis": {str(k): {str(a): int(s) for a, s in d.items()}
                  for k, d in fe.covis.items()},
        "pose_np": {str(k): [np.asarray(R).tolist(), np.asarray(t).tolist()]
                    for k, (R, t) in fe.pose_np.items()},
    }


def _load_host_meta(fe, meta):
    fe.next_kf = int(meta["next_kf"])
    fe.next_point = int(meta["next_point"])
    fe.actkey_id = int(meta["actkey_id"])
    fe.kf_point_ids = {int(k): np.asarray(v, np.int64)
                       for k, v in meta["kf_point_ids"].items()}
    fe.covis = {int(k): {int(a): int(s) for a, s in d.items()}
                for k, d in meta["covis"].items()}
    fe.pose_np = {int(k): (np.asarray(R, np.float32), np.asarray(t, np.float32))
                  for k, (R, t) in meta["pose_np"].items()}


def _point_table(z, prefix, device):
    from scavislam_tpu_torch.models.map_store import PointTable

    def up(key, dtype):
        return torch.as_tensor(np.array(z[prefix + key]), dtype=dtype,
                               device=device)

    return PointTable(up("psi", torch.float32), up("anchor", torch.int32),
                      up("level", torch.int32), up("patch", torch.float32),
                      up("uv0", torch.float32), up("valid", torch.bool))


def _pose_table(z, prefix, device):
    from scavislam_tpu_torch.models.map_store import PoseTable

    return PoseTable(
        torch.as_tensor(np.array(z[prefix + "R"]), dtype=torch.float32,
                        device=device),
        torch.as_tensor(np.array(z[prefix + "t"]), dtype=torch.float32,
                        device=device),
        torch.as_tensor(np.array(z[prefix + "valid"]), dtype=torch.bool,
                        device=device))


# -- full-system checkpoint / resume ---------------------------------------- #

def save_system(system, path):
    """Checkpoint a SlamSystem: the backend graph, the frontend's device
    tables and host mirrors, and the place-recognition index, as one
    compressed .npz. Keyframe images are not saved: loaded keyframes cannot
    serve as re-match targets of the backend's registration."""
    fe = system.frontend
    buf = io.BytesIO()
    save_graph(system.backend.graph, buf)
    buf.seek(0)
    gz = np.load(buf, allow_pickle=False)
    arrays = {f"g_{k}": gz[k] for k in gz.files}

    arrays.update(
        fp_psi=_np(fe.points.psi),
        fp_anchor=_np(fe.points.anchor),
        fp_level=_np(fe.points.level),
        fp_patch=_np(fe.points.patch).astype(np.float32),
        fp_uv0=_np(fe.points.uv0),
        fp_valid=_np(fe.points.valid),
        po_R=_np(fe.poses.R),
        po_t=_np(fe.poses.t),
        po_valid=_np(fe.poses.valid),
        meta_anchor=fe._meta_anchor,
        meta_level=fe._meta_level,
    )
    arrays["f_meta"] = np.asarray(json.dumps(_host_meta(fe)))

    pr = system.place_recognizer
    if pr is not None and pr.location_map:
        ids = sorted(pr.location_map)
        places = [pr.location_map[k] for k in ids]
        arrays.update(
            pr_ids=np.asarray(ids, np.int64),
            pr_words=np.concatenate(
                [np.asarray(p.words, np.int64) for p in places]),
            pr_word_off=np.cumsum([0] + [len(p.words) for p in places])[:-1],
            pr_desc_p=np.stack([p.padded[0] for p in places]),
            pr_xyz_p=np.stack([p.padded[1] for p in places]),
            pr_valid_p=np.stack([p.padded[2] for p in places]),
            pr_vocab=_np(pr.vocab).astype(np.float32),
        )
    np.savez_compressed(path, **arrays)


def load_system(path, cam, cfg=None, **system_kw):
    """Restore a SlamSystem from ``save_system`` (`system_kw` go to the
    constructor, `device` among them). The system starts in `lost` mode
    when it has a place recognizer: the first processed frame relocalizes
    against the loaded map through the BoW index."""
    from scavislam_tpu_torch.models.placerec import Place
    from scavislam_tpu_torch.pipeline.slam_system import SlamSystem

    z = np.load(path, allow_pickle=False)
    vocab = z["pr_vocab"] if "pr_vocab" in z.files else None
    system = SlamSystem(cam, cfg, vocabulary=vocab, **system_kw)
    fe = system.frontend
    dev = fe.device

    fe.points = _point_table(z, "fp_", dev)
    fe.poses = _pose_table(z, "po_", dev)
    fe._meta_anchor = z["meta_anchor"].copy()
    fe._meta_level = z["meta_level"].copy()
    _load_host_meta(fe, json.loads(str(z["f_meta"])))

    # the graph: the g_ arrays re-packed into an npz stream for load_graph
    buf = io.BytesIO()
    np.savez(buf, **{k[2:]: z[k] for k in z.files if k.startswith("g_")})
    buf.seek(0)
    old = system.backend.graph
    graph = load_graph(buf, cam, device=old.device)
    graph.solve_device = old.solve_device  # the config-resolved one
    system.backend.graph = graph
    system.backend.prev_kf_id = max(graph.vertices, default=None)

    pr = system.place_recognizer
    if pr is not None and "pr_ids" in z.files:
        offs = list(z["pr_word_off"]) + [len(z["pr_words"])]
        for i, kf in enumerate(z["pr_ids"]):
            words = z["pr_words"][offs[i]:offs[i + 1]]
            padded = (z["pr_desc_p"][i].copy(), z["pr_xyz_p"][i].copy(),
                      z["pr_valid_p"][i].copy())
            valid = padded[2]
            place = Place(int(kf), words, padded[0][valid], None,
                          padded[1][valid], set(), padded=padded)
            pr.location_map[int(kf)] = place
            for w, c in zip(*np.unique(words, return_counts=True)):
                pr.inverted_index[int(w)][int(kf)] = int(c)
                pr.word_doc_count[int(w)] += 1

    # a fresh dense-tracking state (the relocalization step's run rebuilds
    # the real cloud from its own frame)
    h, w = cam.size[1], cam.size[0]
    (fe._prev_clouds, fe._prev_intens, fe._prev_valids,
     fe._prev_J) = fe._empty_prev_state((h, w))

    # a loaded map has no live tracking state: localize first
    system.lost = system.place_recognizer is not None
    return system


def save_mono_system(fe, path):
    """Checkpoint a MonoFrontend: device tables (points, Lambda, poses),
    host mirrors (keyframe bookkeeping, per-keyframe observations of the
    window BA), the trajectory and the scale-gauge parameters, as one
    compressed .npz."""
    fmeta = _host_meta(fe)
    fmeta.update(
        prior_idepth=fe.prior_idepth,
        conv_q_info=fe.conv_q_info,
        prior_weight=fe.prior_weight,
        traj_fids=[int(f) for f, _T in fe.trajectory],
    )
    # the twin's key order (the JSON text is the same for the same state)
    order = ("next_kf", "next_point", "actkey_id", "prior_idepth",
             "conv_q_info", "prior_weight", "kf_point_ids", "covis",
             "pose_np", "traj_fids")
    fmeta = {k: fmeta[k] for k in order}
    traj_R = (np.stack([np.asarray(T.R) for _f, T in fe.trajectory])
              if fe.trajectory else np.zeros((0, 3, 3)))
    traj_t = (np.stack([np.asarray(T.t) for _f, T in fe.trajectory])
              if fe.trajectory else np.zeros((0, 3)))
    obs_kf, obs_ids, obs_uv = [], [], []
    for k in sorted(fe.kf_obs):
        ids, uv = fe.kf_obs[k]
        obs_kf.extend([k] * len(ids))
        obs_ids.extend(np.asarray(ids).tolist())
        obs_uv.append(np.asarray(uv, np.float32).reshape(-1, 2))
    np.savez_compressed(
        path,
        m_meta=np.asarray(json.dumps(fmeta)),
        mp_psi=_np(fe.points.psi),
        mp_anchor=_np(fe.points.anchor),
        mp_level=_np(fe.points.level),
        mp_patch=_np(fe.points.patch).astype(np.float32),
        mp_uv0=_np(fe.points.uv0),
        mp_valid=_np(fe.points.valid),
        mp_lam=_np(fe.Lam),
        mo_R=_np(fe.poses.R),
        mo_t=_np(fe.poses.t),
        mo_valid=_np(fe.poses.valid),
        meta_anchor=fe._meta_anchor,
        meta_level=fe._meta_level,
        traj_R=traj_R,
        traj_t=traj_t,
        obs_kf=np.asarray(obs_kf, np.int64),
        obs_ids=np.asarray(obs_ids, np.int64),
        obs_uv=(np.concatenate(obs_uv) if obs_uv
                else np.zeros((0, 2), np.float32)),
    )


def load_mono_system(path, cam, cfg=None, **fe_kw):
    """Restore a MonoFrontend from ``save_mono_system`` (`fe_kw` go to the
    constructor, `device` among them): tracking resumes from the
    checkpointed pose with the filtered map, the Lambda state and the
    window-BA observation history."""
    from scavislam_tpu_torch.core.lie import PoseRT
    from scavislam_tpu_torch.models.mono_frontend import MonoFrontend

    z = np.load(path, allow_pickle=False)
    meta = json.loads(str(z["m_meta"]))
    fe = MonoFrontend(cam, cfg, prior_idepth=meta["prior_idepth"],
                      conv_q_info=meta["conv_q_info"],
                      prior_weight=meta["prior_weight"], **fe_kw)
    dev = fe.device
    fe.points = _point_table(z, "mp_", dev)
    fe.Lam = torch.as_tensor(np.array(z["mp_lam"]), dtype=torch.float32,
                             device=dev)
    fe.poses = _pose_table(z, "mo_", dev)
    fe._meta_anchor = z["meta_anchor"].astype(np.int64)
    fe._meta_level = z["meta_level"].astype(np.int64)
    _load_host_meta(fe, meta)
    fe.trajectory = [
        (fid, PoseRT(z["traj_R"][i].astype(np.float64),
                     z["traj_t"][i].astype(np.float64)))
        for i, fid in enumerate(meta["traj_fids"])
    ]
    obs_kf = z["obs_kf"]
    for k in np.unique(obs_kf):
        sel = obs_kf == k
        fe.kf_obs[int(k)] = (z["obs_ids"][sel],
                             z["obs_uv"][sel].astype(np.float32))
    if fe.trajectory:
        last = fe.trajectory[-1][1]
        fe._R_cw = np.asarray(last.R, np.float32)
        fe._t_cw = np.asarray(last.t, np.float32)
        fe.frame_id = fe.trajectory[-1][0]
    return fe
