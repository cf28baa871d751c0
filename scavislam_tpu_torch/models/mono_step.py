"""The per-frame MONOCULAR frontend step (port of
scavislam_tpu.models.mono_step).

One call per frame runs, in order:

    preprocess -> FAST corner buckets (3 levels)
    -> candidate materialization from the device map tables
    -> guided ZMSSD matching (uv observations, no disparity)
    -> robust motion-only BA over uv residuals, twice (converged points at
       full weight, unconverged candidates at a small prior weight, so the
       bootstrap frames are held by the inverse-depth prior)
    -> the batched information-filter depth update of every gated
       candidate (filterSingleFeatureOnly, pose_optimizer.h:300-422, all
       landmarks at once)
    -> the filtered psi / Lambda written back into new tables

and returns one packed f32 vector for the host policy, in the twin's
layout (``MonoStepOut.packed``).

Depth and scale: candidates spawn with a prior inverse depth, the global
scale gauge (mono trajectories are defined up to one similarity; evaluate
with the Sim3-aligned ATE). The anchor observation pins the bearing (large
Lambda on the first two psi components); depth information accrues with
parallax only.

The step reads nothing back to the host: both LMs are fixed-trip device
loops, the write-backs are masked scatters, the active keyframe is a device
scalar. Every shape follows from (H, W, levels, C, P), so one call can be
captured as a CUDA graph. The tables it returns are new tensors; the
caller's tables are left as they were (``MonoFrontend.relocalize`` restores
them from such references).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from scavislam_tpu_torch.core.lie import SE3
from scavislam_tpu_torch.models.frontend_step import (
    FAST_THRESHOLD,
    _device_index,
    _extract_bucket_patches,
    _match_one_level,
    level_sections,
    normalize_frames,
)
from scavislam_tpu_torch.models.map_store import PointTable, PoseTable, scatter_psi
from scavislam_tpu_torch.models.matcher import _patch_offsets
from scavislam_tpu_torch.models.pose_optimizer import (
    filter_points_info,
    motion_only_ba_uv,
)
from scavislam_tpu_torch.ops.fast import detect_corners_grid
from scavislam_tpu_torch.ops.image import bilinear_sample, binomial3, build_pyramid

SOURCE_PATCH = 16

# bearing prior: the anchor observation fixes the first two psi components
# to sub-pixel accuracy; 1e4 px^2 information pins them while depth stays
# free (Lambda_qq starts at 0 = fully unobserved)
BEARING_INFO = 1e4

# the twin's guided-match window radius for mono (level pixels)
MONO_SEARCH_RADIUS_PX = 12.0
# tracking floor of the chain guard (MonoFrontend.MIN_TRACK_OBS)
_MIN_BA_OBS = 15


class MonoStepOut(NamedTuple):
    packed: torch.Tensor  # the one host download per frame
    R_cw: torch.Tensor
    t_cw: torch.Tensor
    gate: torch.Tensor  # (C,)
    obs_uv: torch.Tensor  # (C, 2)
    points: PointTable  # psi updated by the filter
    Lam: torch.Tensor  # (P, 3, 3) updated information table
    pyr: tuple  # device-resident (spawn input)


def mono_step(
    img,  # (H, W) f32 in [0, 1] or uint8
    R_cw_prev, t_cw_prev,  # previous frame's world pose (the motion seed:
    # mono has no dense tracker, guided matching searches around the
    # previous pose's predictions)
    actkey_id,  # device int scalar
    poses: PoseTable,
    points: PointTable,
    Lam,  # (P, 3, 3) per-point information (filter state)
    cand_ids,  # (C,) int, -1 padded, in per-level sections
    conv_q_info,  # Lambda_qq above which a point is depth-CONVERGED
    prior_weight,  # BA weight of unconverged candidates (<< 1)
    cam_params,  # per-level (focal, ppx, ppy) floats
    cam_statics,  # per-level (w, h)
    levels: int = 3,
    max_reproj_err: float = 2.0,
    zmssd_thr: float = 0.18,
) -> MonoStepOut:
    f32 = torch.float32
    # -- 1. preprocess (uint8 as a multiply by the f32 reciprocal)
    img = normalize_frames(img)
    pyr = build_pyramid(img, levels)

    # -- 2. materialize candidates from the device tables
    P_cap = points.psi.shape[0]
    K_cap = poses.R.shape[0]
    safe = cand_ids.clamp(0, P_cap - 1).long()
    psi = points.psi[safe]
    q = psi[:, 2:3]
    q_safe = torch.where(torch.abs(q) < 1e-9, torch.full_like(q, 1e-9), q)
    xyz_a = torch.cat([psi[:, :2], torch.ones_like(q)], dim=-1) / q_safe
    a_idx = points.anchor[safe].clamp(0, K_cap - 1).long()
    R_aw = poses.R[a_idx]
    t_aw = poses.t[a_idx]
    xyz_w = torch.einsum("nji,nj->ni", R_aw, xyz_a - t_aw)
    patches = points.patch[safe]
    cand_levels = points.level[safe]
    cand_uv0 = points.uv0[safe]
    lam_c = Lam[safe]
    lam_qq = lam_c[:, 2, 2]
    ok = ((cand_ids >= 0) & points.valid[safe] & poses.valid[a_idx]
          & (q[:, 0] > 1e-9))

    # -- 3. guided matching per level (uv observations; the stereo step's
    # per-level section layout)
    C = cand_ids.shape[0]
    caps = level_sections(levels, C)
    sec_off = 0
    obs_secs, matched_secs = [], []
    for l in range(levels):
        focal, ppx, ppy = cam_params[l]
        w_l, h_l = cam_statics[l]
        cells_y = max(h_l // 16, 4)
        cells_x = max(w_l // 16, 4)
        uvb, _, validb = detect_corners_grid(
            binomial3(pyr[l]), FAST_THRESHOLD, cells_y, cells_x, 4)
        buckets_uv = uvb.reshape(cells_y, cells_x, 4, 2)
        buckets_valid = validb.reshape(cells_y, cells_x, 4)
        bucket_patches, bucket_patch_ok = _extract_bucket_patches(
            pyr[l], buckets_uv, buckets_valid)
        sl = slice(sec_off, sec_off + caps[l])
        sec_off += caps[l]
        lvl_ok = ok[sl] & (cand_levels[sl] == l)
        obs_l, m_l = _match_one_level(
            {"focal": focal, "ppx": ppx, "ppy": ppy, "size": (w_l, h_l)},
            pyr[l], R_cw_prev, t_cw_prev, xyz_w[sl], R_aw[sl], t_aw[sl],
            patches[sl], lvl_ok, buckets_uv, buckets_valid, bucket_patches,
            bucket_patch_ok, None, l, zmssd_thr, MONO_SEARCH_RADIUS_PX)
        obs_secs.append(obs_l)
        matched_secs.append(m_l)
    obs_uv = torch.cat(obs_secs, dim=0)[:, :2]
    matched_all = torch.cat(matched_secs, dim=0)
    n_matched = torch.sum(matched_all.to(torch.int32))

    # -- 4. robust motion-only BA over uv residuals: converged points at
    # full weight, unconverged candidates at `prior_weight`
    cam0 = tuple(cam_params[0])
    converged = lam_qq > conv_q_info
    conf = torch.where(converged, 1.0, prior_weight)
    weights = (0.25 ** cand_levels.to(f32)) * conf * matched_all
    res = motion_only_ba_uv(cam0, SE3(R_cw_prev, t_cw_prev), xyz_w, obs_uv,
                            weights, matched_all, 1.0)
    keep = (matched_all & res.inlier_mask
            & (torch.amax(torch.abs(res.residuals), dim=-1)
               < max_reproj_err * 2.0))
    res = motion_only_ba_uv(cam0, res.T, xyz_w, obs_uv, weights, keep, 1.0)

    # -- 5. gating (per-level reprojection bound, uv only)
    lvl_scale = (2.0 ** cand_levels).to(f32)
    resid = res.residuals
    gate = (matched_all & res.inlier_mask
            & (torch.abs(resid[:, 0]) < max_reproj_err * lvl_scale)
            & (torch.abs(resid[:, 1]) < max_reproj_err * lvl_scale))
    n_gated = torch.sum(gate.to(torch.int32))
    # a BA below the mono tracking floor must not move the chained pose,
    # judged on the final gate (the host treats the frame as failed)
    ba_ok = (n_matched >= _MIN_BA_OBS) & (n_gated >= _MIN_BA_OBS)
    R_cw = torch.where(ba_ok, res.T.R, R_cw_prev)
    t_cw = torch.where(ba_ok, res.T.t, t_cw_prev)
    n_conv_gated = torch.sum((gate & converged).to(torch.int32))

    # -- 6. information-filter depth update of every gated candidate with
    # the refined pose
    R_ca = torch.einsum("ij,nkj->nik", R_cw, R_aw)  # R_cw @ R_aw^T
    t_ca = t_cw[None, :] - torch.einsum("nij,nj->ni", R_ca, t_aw)
    filt = filter_points_info(cam0, R_ca, t_ca, psi, lam_c, obs_uv, gate,
                              iters=5)
    # masked write-backs (non-gated rows dropped): new tables, the
    # caller's are untouched
    upd_ids = torch.where(gate, cand_ids.long(), P_cap)
    points = points._replace(psi=scatter_psi(points.psi, upd_ids, filt.psi))
    new_lam = scatter_psi(Lam, upd_ids, filt.Lambda)
    lam_qq_new = filt.Lambda[:, 2, 2]

    # -- 7. keyframe-policy statistics (quadrant coverage + track length,
    # stereo_frontend.cpp:512-528; t_norm in prior-scale units)
    w0, h0 = cam_statics[0]
    qx = (obs_uv[:, 0] > w0 / 2).to(torch.int64)
    qy = (obs_uv[:, 1] > h0 / 2).to(torch.int64)
    quad_counts = torch.sum(
        F.one_hot(qy * 2 + qx, 4).to(torch.int32)
        * gate[:, None].to(torch.int32), dim=0)
    # index_select: indexing by a 0-dim tensor would read it on the host
    ak = _device_index(actkey_id, img.device)
    R_akw = poses.R.index_select(0, ak)[0]
    t_akw = poses.t.index_select(0, ak)[0]
    R_cak = R_cw @ R_akw.T
    t_cak = t_cw - R_cak @ t_akw
    t_norm = torch.linalg.norm(t_cak)
    own = gate & (a_idx == ak)
    track_len = torch.linalg.norm(obs_uv - cand_uv0, dim=-1)
    n_own = torch.clamp(torch.sum(own.to(f32)), min=1.0)
    mean_track_len = torch.sum(
        torch.where(own, track_len, torch.zeros_like(track_len))) / n_own

    # the layout PackedMonoStep reads
    packed = torch.cat([
        R_cw.reshape(-1), t_cw,                      # 0:9, 9:12
        R_cak.reshape(-1), t_cak,                    # 12:21, 21:24
        torch.stack([
            n_matched.to(f32),                       # 24
            n_gated.to(f32),                         # 25
            n_conv_gated.to(f32),                    # 26
            t_norm, mean_track_len, res.chi2,        # 27, 28, 29
        ]),
        quad_counts.to(f32),                         # 30:34
        gate.to(f32),                                # 34:34+C
        matched_all.to(f32),                         # +C
        obs_uv.reshape(-1),                          # +2C
        lam_qq_new,                                  # +C (post-update info)
    ])
    return MonoStepOut(packed, R_cw, t_cw, gate, obs_uv, points, new_lam, pyr)


class PackedMonoStep(NamedTuple):
    """A downloaded ``MonoStepOut.packed`` on the host, by field: numpy
    views of the vector, the statistics as numpy scalars and the gate as
    booleans."""

    R_cw: np.ndarray  # (3, 3)
    t_cw: np.ndarray
    n_matched: np.float32
    n_gated: np.float32
    n_conv: np.float32  # gated candidates that were depth-converged
    t_norm: np.float32  # |t_cur_from_actkey|, prior-scale units
    mean_track_len: np.float32
    quad_counts: np.ndarray  # (4,)
    gate: np.ndarray  # (C,) bool
    obs_uv: np.ndarray  # (C, 2)
    lam_qq: np.ndarray  # (C,) inverse-depth information after the update

    @classmethod
    def read(cls, pk: np.ndarray) -> "PackedMonoStep":
        C = (len(pk) - 34) // 5
        return cls(pk[0:9].reshape(3, 3), pk[9:12], *pk[24:29], pk[30:34],
                   pk[34:34 + C] > 0.5,
                   pk[34 + 2 * C:34 + 4 * C].reshape(C, 2),
                   pk[34 + 4 * C:34 + 5 * C])


def spawn_points_mono(
    pyr,  # tuple of level images (from mono_step's output)
    tracked_uv0,  # (T, 2) level-0 positions of gated observations (padded)
    tracked_valid,  # (T,)
    points: PointTable,
    Lam,  # (P, 3, 3)
    start_indices,  # per-level block starts (host ints)
    kf_id: int,
    prior_q: float,  # prior inverse depth (the scale gauge)
    cam_params,
    cam_statics,
    levels: int = 3,
    caps: tuple = (192, 64, 32),
    clearance: float = 2.0,
):
    """Monocular point spawning: corners per level, clearance-gated against
    the tracked observations, psi = (bearing of the pixel, prior inverse
    depth), bearing-pinned Lambda, 16x16 source patches. Returns (new point
    table, new Lambda table, one packed payload [psi | uv0 | ok] per
    level)."""
    dev = pyr[0].device
    payloads = []
    offs = _patch_offsets(SOURCE_PATCH, dev)
    lam_init = torch.diag(torch.tensor([BEARING_INFO, BEARING_INFO, 0.0],
                                       dtype=torch.float32)).to(dev)
    P_cap = Lam.shape[0]
    for l in range(levels):
        cap = caps[l]
        focal, ppx, ppy = cam_params[l]
        uv, score, valid = detect_corners_grid(
            binomial3(pyr[l]), FAST_THRESHOLD, 3, 3, -(-cap // 9))
        s = float(2**l)
        uv0 = (uv + 0.5) * s - 0.5
        d2 = torch.sum((uv0[:, None, :] - tracked_uv0[None, :, :]) ** 2, dim=-1)
        d2 = torch.where(tracked_valid[None, :], d2,
                         torch.full_like(d2, float("inf")))
        cl = float(np.float32(clearance) * np.float32(s))
        ok = valid & (torch.amin(d2, dim=-1) > cl * cl)
        rank_score = torch.where(ok, score, torch.full_like(score, -1.0))
        top_idx = torch.argsort(-rank_score, stable=True)[:cap]
        uv_k = uv[top_idx]
        uv0_k = uv0[top_idx]
        ok_k = ok[top_idx] & (rank_score[top_idx] > 0)

        # psi: bearing from the (level-camera) pixel, depth = the prior
        psi = torch.stack(
            [(uv_k[:, 0] - ppx) / focal, (uv_k[:, 1] - ppy) / focal,
             torch.full_like(uv_k[:, 0], prior_q)], dim=-1)
        coords = uv_k[:, None, :] + offs[None, :, :]
        pvals, p_ok = bilinear_sample(pyr[l], coords)
        ok_k = ok_k & torch.all(p_ok, dim=-1)
        patches = pvals.reshape(-1, SOURCE_PATCH, SOURCE_PATCH)

        points = points.insert_block(
            start_indices[l], psi, kf_id,
            torch.full((cap,), l, dtype=torch.int32, device=dev),
            patches, uv0_k, ok_k)
        # the Lambda block at the same clamped start as insert_block's
        st = max(0, min(int(start_indices[l]), P_cap - cap))
        Lam = Lam.clone()
        Lam[st:st + cap] = lam_init
        payloads.append(torch.cat(
            [psi.reshape(-1), uv0_k.reshape(-1), ok_k.to(torch.float32)]))
    return points, Lam, torch.cat(payloads)
