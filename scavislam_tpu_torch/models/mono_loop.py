"""Monocular loop closure: Sim3 constraints and scale-drift-aware correction
(port of scavislam_tpu.models.mono_loop).

Given two keyframes whose filtered maps overlap, estimate the 7-dof Sim3
between them from patch-matched converged points (the reference's MONO-gated
Sim3Model RANSAC, ransac_models.cpp:85-136), then distribute the drift over
the keyframe chain with the Sim3 pose graph
(models.sim3_graph.optimize_sim3_pose_graph) and re-gauge every anchored
inverse depth to the corrected poses.

Device work: the all-pairs ZMSSD patch scores (one matmul) and the Sim3
RANSAC (ops.ransac.ransac_sim3 on hypotheses drawn from a seeded
``torch.Generator``). Host work: correspondence selection, the Umeyama
refit, edge assembly and the pose write-back (numpy).

Random numbers: ``estimate_sim3`` takes its RANSAC hypotheses from
``hypotheses(n)`` when given (a callable: the seam through which a caller
replays the twin's draws), else from a fresh ``torch.Generator`` seeded
with `seed` on the frontend's device. The twin draws from a fresh
``jax.random.PRNGKey(seed)``, whose stream no torch generator reproduces.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from scavislam_tpu_torch.core.lie import Sim3, umeyama_sim3
from scavislam_tpu_torch.models.frontend import Fetch
from scavislam_tpu_torch.models.map_store import MAX_POINTS
from scavislam_tpu_torch.models.placerec import (
    NUM_HYPOTHESES,
    SCORE_THR,
    PlaceRecognizer,
)
from scavislam_tpu_torch.models.sim3_graph import optimize_sim3_pose_graph
from scavislam_tpu_torch.ops.ransac import draw_hypotheses, ransac_sim3

MATCH_CAP = 256  # padded correspondence capacity per loop check


def _zmssd_all_pairs(pa, pb, va, vb):
    """All-pairs zero-mean SSD between two patch stacks (Na, 16, 16) x
    (Nb, 16, 16): |a|^2 + |b|^2 - 2 a b^T, one matmul. Returns (Na, Nb)."""
    a = pa.reshape(pa.shape[0], -1)
    b = pb.reshape(pb.shape[0], -1)
    a = a - torch.mean(a, dim=-1, keepdim=True)
    b = b - torch.mean(b, dim=-1, keepdim=True)
    s = (torch.sum(a * a, -1)[:, None] + torch.sum(b * b, -1)[None, :]
         - 2.0 * (a @ b.T))
    return torch.where(va[:, None] & vb[None, :], s,
                       torch.full_like(s, float("inf")))


def seeded_hypotheses(n: int, seed: int, device) -> torch.Tensor:
    """(NUM_HYPOTHESES, 3) raw RANSAC draws in [0, n) from a fresh
    generator seeded with `seed` (the twin draws from a fresh
    PRNGKey(seed) per check)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return draw_hypotheses(n, NUM_HYPOTHESES, gen, device)


def _kf_points_padded(fe, kf_id, cap=MATCH_CAP):
    """Converged anchored points of a keyframe, padded to a fixed capacity
    (one shape for every device gather). Returns (ids (cap,), valid
    (cap,)) as numpy."""
    ids = np.asarray(fe.kf_point_ids.get(kf_id, np.zeros(0, np.int64)))
    ids = ids[fe._meta_anchor[np.clip(ids, 0, MAX_POINTS - 1)] == kf_id]
    ids_pad = np.zeros(cap, np.int64)
    val = np.zeros(cap, bool)
    n = min(len(ids), cap)
    ids_pad[:n] = ids[:n]
    val[:n] = True
    idx = torch.as_tensor(ids_pad, device=fe.device)
    lam_qq = Fetch(fe.Lam[idx][:, 2, 2]).result()
    val &= lam_qq > fe.conv_q_info
    return ids_pad, val


def match_keyframes(fe, kf_a: int, kf_b: int, zmssd_thr: float = 0.18,
                    ratio: float = 0.8):
    """Mutual-best ZMSSD patch matching between the converged anchored
    points of two keyframes. Returns (ids_a, ids_b) correspondences (host
    numpy; the score matrix is one fixed-shape device program and one
    download)."""
    ids_a, va = _kf_points_padded(fe, kf_a)
    ids_b, vb = _kf_points_padded(fe, kf_b)
    if va.sum() < 3 or vb.sum() < 3:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    dev = fe.device
    pa = fe.points.patch[torch.as_tensor(ids_a, device=dev)]
    pb = fe.points.patch[torch.as_tensor(ids_b, device=dev)]
    score = Fetch(_zmssd_all_pairs(
        pa, pb, torch.as_tensor(va, device=dev),
        torch.as_tensor(vb, device=dev))).result()
    best_b = score.argmin(1)
    best_s = score.min(1)
    second = np.partition(score, 1, axis=1)[:, 1]
    mutual = score.argmin(0)[best_b] == np.arange(len(ids_a))
    # per-pixel ZMSSD threshold (16x16 patches in [0, 1])
    keep = (va & mutual & np.isfinite(best_s)
            & (best_s < zmssd_thr * 256) & (best_s < ratio * second))
    return ids_a[keep], ids_b[best_b[keep]]


def _anchored_xyz_padded(fe, ids):
    """Anchor-frame xyz for `ids`, zero-padded to MATCH_CAP (fixed-shape
    device gather). Returns (xyz (MATCH_CAP, 3) numpy, count)."""
    ids_pad = np.zeros(MATCH_CAP, np.int64)
    n = min(len(ids), MATCH_CAP)
    ids_pad[:n] = ids[:n]
    psi = Fetch(fe.points.psi[torch.as_tensor(ids_pad, device=fe.device)]
                ).result()
    q = np.maximum(psi[:, 2:3], 1e-9)
    return np.concatenate([psi[:, :2] / q, 1.0 / q], axis=1), n


def estimate_sim3(fe, kf_a: int, kf_b: int, inlier_thr: float = 1.5,
                  min_inliers: int = 12, seed: int = 0, hypotheses=None):
    """Sim3 S_a_from_b between two keyframes from matched converged points
    (anchor-frame 3-D on both sides): 3-point RANSAC, then a closed-form
    Umeyama refit over all inliers. Returns (Sim3 of host tensors,
    n_inliers), or (None, n) when the geometric check fails (the mono
    analogue of the reference's > 30-inlier SE3 acceptance,
    placerecognizer.cpp:174-202). `inlier_thr` is in pixels.

    `hypotheses(n)` -> (M, 3) raw draws in [0, n) replaces the seeded
    generator (see the module docstring)."""
    ids_a, ids_b = match_keyframes(fe, kf_a, kf_b)
    if len(ids_a) < max(3, min_inliers // 2):
        return None, 0
    xa, n = _anchored_xyz_padded(fe, ids_a)
    xb, _ = _anchored_xyz_padded(fe, ids_b)
    valid = np.zeros(MATCH_CAP, bool)
    valid[:n] = True
    dev = fe.device
    idx = (seeded_hypotheses(MATCH_CAP, seed, dev) if hypotheses is None
           else hypotheses(MATCH_CAP))
    idx = torch.as_tensor(idx if isinstance(idx, torch.Tensor)
                          else np.asarray(idx), device=dev)
    cam0 = fe.cams[0]
    _s, _R, _t, inl, cnt = ransac_sim3(
        idx, torch.as_tensor(xb, dtype=torch.float32, device=dev),
        torch.as_tensor(xa, dtype=torch.float32, device=dev),
        torch.as_tensor(valid, device=dev),
        (cam0.focal, cam0.pp[0], cam0.pp[1], cam0.baseline),
        inlier_thr=inlier_thr)
    out = Fetch(torch.cat([cnt.reshape(1).to(torch.float32),
                           inl.to(torch.float32)])).result()
    cnt = int(out[0])
    if cnt < min_inliers:
        return None, cnt
    keep = (out[1:] > 0.5) & valid
    s_r, R_r, t_r = umeyama_sim3(xb[keep], xa[keep])
    return Sim3(torch.as_tensor(R_r, dtype=torch.float32),
                torch.as_tensor(t_r, dtype=torch.float32),
                torch.tensor(s_r, dtype=torch.float32)), cnt


def close_loop_sim3(fe, kf_query: int, kf_loop: int, S_q_from_l: Sim3,
                    iters: int = 12):
    """Distribute the loop residual over the keyframe chain and re-gauge.

    Graph: one Sim3 node per keyframe (node-from-world, scale 1 from VO),
    consecutive-keyframe odometry edges from the CURRENT poses, and the
    measured loop edge; node 0 is the gauge. Write-back per keyframe k with
    corrected (R*, t*, s*): T_kw <- SE3(R*, t* / s*), and every psi
    anchored at k re-gauges q <- q * s* (the same world point, the anchor
    frame re-scaled; cf. slam_graph.cpp:207-251). Returns {kf_id: scale}
    of the applied re-gauges."""
    if hasattr(fe, "invalidate_pending_ba"):
        # a re-gauge makes any in-flight window solve inapplicable
        fe.invalidate_pending_ba()
    dev = fe.device
    kf_ids = sorted(fe.pose_np.keys())
    n = len(kf_ids)
    idx = {k: i for i, k in enumerate(kf_ids)}

    def up(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    nodes = Sim3(up(np.stack([fe.pose_np[k][0] for k in kf_ids])),
                 up(np.stack([fe.pose_np[k][1] for k in kf_ids])),
                 torch.ones(n, dtype=torch.float32, device=dev))
    ei, ej, eR, et, es = [], [], [], [], []
    for a, b in zip(kf_ids[:-1], kf_ids[1:]):
        Ra, ta = fe.pose_np[a]
        Rb, tb = fe.pose_np[b]
        # S_a_from_b = S_aw S_bw^-1 at unit scales
        R_ab = Ra @ Rb.T
        ei.append(idx[a])
        ej.append(idx[b])
        eR.append(R_ab)
        et.append(ta - R_ab @ tb)
        es.append(1.0)
    ei.append(idx[kf_query])
    ej.append(idx[kf_loop])
    eR.append(np.asarray(S_q_from_l.R))
    et.append(np.asarray(S_q_from_l.t))
    es.append(float(S_q_from_l.s))
    edges = Sim3(up(np.stack(eR)), up(np.stack(et)), up(np.asarray(es)))
    out, _hist = optimize_sim3_pose_graph(
        nodes, torch.as_tensor(ei, device=dev),
        torch.as_tensor(ej, device=dev), edges,
        torch.ones(len(ei), dtype=torch.bool, device=dev), iters=iters)
    pk = Fetch(torch.cat([out.R.reshape(-1), out.t.reshape(-1), out.s])
               ).result()
    Rs = pk[: 9 * n].reshape(n, 3, 3)
    ts = pk[9 * n: 12 * n].reshape(n, 3)
    ss = pk[12 * n:]

    # the query keyframe's correction, captured BEFORE write-back: the
    # tracking chain rebases through it (current frame = query-relative)
    Rq_old, tq_old = fe.pose_np[kf_query]
    R_cq = fe._R_cw @ Rq_old.T
    t_cq = fe._t_cw - R_cq @ tq_old

    scales = {}
    new_R = np.zeros((n, 3, 3), np.float32)
    new_t = np.zeros((n, 3), np.float32)
    for k in kf_ids:
        i = idx[k]
        s = float(ss[i])
        R = Rs[i].astype(np.float32)
        t = (ts[i] / s).astype(np.float32)
        fe.pose_np[k] = (R, t)
        new_R[i] = R
        new_t[i] = t
        scales[k] = s
    # one device scatter for all keyframe poses
    fe.poses = fe.poses.set_many(
        torch.as_tensor(np.asarray(kf_ids, np.int64), device=dev),
        up(new_R), up(new_t))
    # re-gauge anchored depths: q <- q * s_anchor (one whole-table pass)
    s_per_point = np.ones(MAX_POINTS, np.float32)
    for k, s in scales.items():
        s_per_point[fe._meta_anchor == k] = s
    fe.points = fe.points._replace(
        psi=_regauge_psi(fe.points.psi, up(s_per_point)))
    # the chain continues from the corrected world pose: the current
    # frame's query-relative delta through the CORRECTED query pose
    Rq_new, tq_new = fe.pose_np[kf_query]
    fe._R_cw = (R_cq @ Rq_new).astype(np.float32)
    fe._t_cw = (R_cq @ tq_new + t_cq).astype(np.float32)
    fe._dev_R_cw = None
    fe._dev_t_cw = None
    return scales


def _regauge_psi(psi, s_per_point):
    one = torch.ones_like(s_per_point)
    return psi * torch.stack([one, one, s_per_point], dim=-1)


# --------------------------------------------------------------------- #
# loop DETECTION for mono: BoW retrieval + Sim3 verification
# --------------------------------------------------------------------- #


@dataclass
class MonoDetectedLoop:
    """The mono analogue of DetectedLoop: the constraint is a Sim3 (scale
    dof included), not an SE3."""

    query_id: int
    loop_id: int
    S_query_from_loop: Sim3
    inliers: int


class MonoPlaceRecognizer(PlaceRecognizer):
    """The stereo recognizer's retrieval path (corner descriptors -> words
    -> TF-IDF over the inverted index with covis exclusion,
    placerecognizer.cpp:130-172, 249-298) on keyframe images WITHOUT depth
    (``describe(img, None)``), with the geometric check replaced by the
    mono Sim3 verification over the keyframes' filtered maps
    (:func:`estimate_sim3`). Each check's RANSAC draws come from
    ``hypotheses``: a fresh generator seeded 0, as the twin's check draws
    from PRNGKey(0); the seam a caller replaces to replay the twin's
    draws."""

    def __init__(self, fe, vocabulary=None, score_thr: float = SCORE_THR,
                 min_inliers: int = 12):
        super().__init__(fe.cam, vocabulary, score_thr=score_thr,
                         min_inliers=min_inliers, device=fe.device)
        self.fe = fe

    def hypotheses(self, n: int) -> torch.Tensor:
        return seeded_hypotheses(n, 0, self.device)

    def _geometric_check(self, query, cand):
        S, n_inl = estimate_sim3(self.fe, query.kf_id, cand.kf_id,
                                 min_inliers=self.min_inliers,
                                 hypotheses=self.hypotheses)
        if S is None:
            return None
        return MonoDetectedLoop(query.kf_id, cand.kf_id, S, n_inl)


def make_mono_place_recognizer(fe, vocabulary=None, score_thr=None,
                               min_inliers: int = 12) -> MonoPlaceRecognizer:
    """BoW loop detection for the mono frontend: feed it
    ``add_location({"kf_id": k, "img": level0_image, "disp": None,
    "exclude": covis_ids})`` per keyframe (or use
    :func:`add_keyframe_to_recognizer`) and apply the detected loops with
    :func:`close_loop_sim3`."""
    return MonoPlaceRecognizer(
        fe, vocabulary, score_thr=SCORE_THR if score_thr is None else score_thr,
        min_inliers=min_inliers)


def add_keyframe_to_recognizer(pr, fe, kf_id: int, img):
    """Index a mono keyframe and return a MonoDetectedLoop if retrieval and
    the Sim3 verification fire (the keyframe's covisible neighborhood is
    excluded, as the reference's exclude_set, placerecognizer.cpp:249-298)."""
    exclude = set(fe.covis.get(kf_id, {})) | {kf_id}
    return pr.add_location(
        {"kf_id": kf_id, "img": img, "disp": None, "exclude": exclude})
