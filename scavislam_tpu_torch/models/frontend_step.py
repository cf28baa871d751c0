"""The per-frame frontend step (port of scavislam_tpu.models.frontend_step).

One call per frame runs, in order:

    preprocess -> block-matching stereo -> FAST corner buckets (3 levels)
    -> dense photometric tracking (coarse-to-fine inverse-compositional LM)
    -> candidate materialization from the device map tables
    -> guided ZMSSD matching (3 levels)
    -> robust motion-only BA (LM + rejection round)
    -> reprojection gating + keyframe-policy statistics
    -> next frame's dense point-cloud state

and returns one packed f32 vector for the host policy, in the twin's layout
(``FrontendStepOut.packed``), plus device-resident state.

Stereo, runtime-selectable as the reference's four methods: method 2 (the
default) runs the hand-written block-matching kernel through
``ops.stereo_bm`` (its plain version on the CPU); method 1 runs the
cost-volume twin ``ops.stereo.block_matching_disparity``; method 3
hierarchical belief propagation and method 4 constant-space BP
(``ops.stereo_bp``, with ``stereo_opts = (iters, levels, nr_plane)``); an
external disparity plane replaces them all.

Index hygiene: JAX clamps out-of-range gather indices silently and the
twin relies on it (padded candidate ids, bucket neighbourhoods, patch
corners); every such gather here clamps explicitly.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from scavislam_tpu_torch.core.camera import StereoCamera
from scavislam_tpu_torch.core.lie import SE3
from scavislam_tpu_torch.models.dense_tracker import (
    _lm_level_ic,
    template_jacobian,
)
from scavislam_tpu_torch.models.map_store import PointTable, PoseTable
from scavislam_tpu_torch.models.matcher import (
    SOURCE_PATCH,
    _patch_offsets_int,
    _warp_from_source,
    qpack_patches,
)
from scavislam_tpu_torch.models.pose_optimizer import motion_only_ba
from scavislam_tpu_torch.ops.descriptors import bow_describe
from scavislam_tpu_torch.ops.fast import detect_corners_grid
from scavislam_tpu_torch.ops.image import (
    bilinear_sample,
    binomial3,
    build_pyramid,
    float_to_index,
    nearest_sample,
    sobel_xy,
)
from scavislam_tpu_torch.ops.patches import PATCH, affine_from_geometry
from scavislam_tpu_torch.ops.stereo import block_matching_disparity
from scavislam_tpu_torch.ops.stereo_bm import block_matching_disparity_bm
from scavislam_tpu_torch.ops.stereo_bp import (
    belief_propagation_disparity,
    constant_space_bp_disparity,
)

# guided-match window radius in level pixels: the most the 3x3 bucket
# neighbourhood of 16 px cells can guarantee to cover
MATCH_SEARCH_RADIUS_PX = 16.0

# per-level extra subsampling of the dense-tracking cloud (on top of the
# pyramid's 2^l)
DENSE_SUBS = (2, 2, 1)
# the multistream step's density: levels 0-1 at every 4th pixel (the
# reference's CPU tracker density); the coarse level stays full
DENSE_SUBS_BATCHED = (4, 4, 1)
# dense-tracking samplers accepted for API parity; both run the exact f32
# bilinear sampler ("matmul" names the twin's bf16 matrix-unit sampler,
# which the port does not reproduce)
DENSE_SAMPLERS = ("qpack", "matmul")

FAST_THRESHOLD = 10.0 / 255.0
# uint8 -> [0, 1] as a multiply by the f32 reciprocal: the twin's compiled
# step computes `u8 / 255.0` that way (XLA rewrites the division), which
# differs from a true division on 126 of the 256 byte values
_U8_SCALE = float(np.float32(1.0 / 255.0))
ZMSSD_THR = 0.18  # zero-mean SSD acceptance threshold


def level_sections(levels: int, C: int) -> tuple:
    """Fixed per-level candidate capacities: cand_ids is split into
    contiguous per-level sections so each level's matcher only does work for
    its own candidates."""
    frac = {1: (), 2: (0.25,), 3: (0.25, 1.0 / 12.0)}.get(
        levels, tuple(4.0 ** -l for l in range(1, levels)))
    caps = [max(32, int(C * f) // 32 * 32) for f in frac]
    return (C - sum(caps), *caps)


class FrontendStepOut(NamedTuple):
    # `packed` is the one host-fetched array per frame: every scalar/mask the
    # host policy needs, concatenated into a single f32 vector
    packed: torch.Tensor
    R_cw: torch.Tensor
    t_cw: torch.Tensor
    R_cak: torch.Tensor  # T_cur_from_actkey
    t_cak: torch.Tensor
    gate: torch.Tensor  # (C,) bool gated matches
    matched: torch.Tensor  # (C,) bool raw matches
    obs_uvu: torch.Tensor  # (C, 3)
    n_matched: torch.Tensor
    n_gated: torch.Tensor
    quad_counts: torch.Tensor  # (4,)
    t_norm: torch.Tensor  # |t_cur_from_actkey|
    mean_track_len: torch.Tensor
    dense_chi2: torch.Tensor
    ba_chi2: torch.Tensor
    # device-resident outputs (not fetched)
    pyr: tuple
    dx: tuple
    dy: tuple
    disp: torch.Tensor
    clouds: tuple
    cloud_valids: tuple
    intens: tuple
    cloud_J: tuple  # per-level (N, 6) template Jacobians


def normalize_frames(frames: torch.Tensor) -> torch.Tensor:
    """uint8 frames -> f32 in [0, 1] (as the twin's compiled step does);
    float frames pass through."""
    if frames.dtype == torch.uint8:
        return frames.to(torch.float32) * _U8_SCALE
    return frames


def _extract_bucket_patches(img, buckets_uv, buckets_valid):
    """8x8 patches at INTEGER bucket-corner positions: (cy, cx, K, 64) in
    (ov, ou) raster order, plus the all-inside mask."""
    h, w = img.shape
    half = PATCH // 2
    u0 = float_to_index(buckets_uv[..., 0])
    v0 = float_to_index(buckets_uv[..., 1])
    ut, vt = u0 - half, v0 - half  # patch top-left
    ok = ((ut >= 0) & (ut + PATCH <= w) & (vt >= 0) & (vt + PATCH <= h)
          & buckets_valid)
    utc = ut.clamp(0, w - PATCH)
    vtc = vt.clamp(0, h - PATCH)
    r = torch.arange(PATCH, device=img.device)
    offs = (r[:, None] * w + r[None, :]).reshape(-1)  # (64,)
    base = (vtc * w + utc).long()[..., None]
    return img.reshape(-1)[base + offs], ok


def _subpixel_delta(tmpl, patch):
    """One inverse-compositional LK translation step on an 8x8 patch pair:
    the sub-pixel offset of `patch` relative to `tmpl`. Returns (N, 2)
    du/dv, clamped to +-1 px, zero where ill-conditioned; the caller
    SUBTRACTS it from the corner."""
    n = tmpl.shape[0]
    t2 = tmpl.reshape(n, PATCH, PATCH)
    p2 = patch.reshape(n, PATCH, PATCH)
    t2 = t2 - torch.mean(t2, dim=(-2, -1), keepdim=True)
    p2 = p2 - torch.mean(p2, dim=(-2, -1), keepdim=True)
    gx = torch.zeros_like(t2)
    gx[:, :, 1:-1] = 0.5 * (t2[:, :, 2:] - t2[:, :, :-2])
    gy = torch.zeros_like(t2)
    gy[:, 1:-1, :] = 0.5 * (t2[:, 2:, :] - t2[:, :-2, :])
    r = p2 - t2
    h00 = torch.sum(gx * gx, dim=(-2, -1))
    h01 = torch.sum(gx * gy, dim=(-2, -1))
    h11 = torch.sum(gy * gy, dim=(-2, -1))
    b0 = torch.sum(gx * r, dim=(-2, -1))
    b1 = torch.sum(gy * r, dim=(-2, -1))
    det = h00 * h11 - h01 * h01
    ok = det > 1e-8
    det_safe = torch.where(ok, det, torch.ones_like(det))
    du = (h11 * b0 - h01 * b1) / det_safe
    dv = (h00 * b1 - h01 * b0) / det_safe
    d = torch.stack([du, dv], dim=-1)
    d = torch.where(ok[:, None], d, torch.zeros_like(d))
    return torch.clamp(d, -1.0, 1.0)


def _match_one_level(cam_l, img_level, R_cw, t_cw, xyz_w, R_aw, t_aw,
                     source_patches, point_valid, buckets_uv, buckets_valid,
                     bucket_patches, bucket_patch_ok, disp0, level, zmssd_thr,
                     search_radius, source_patches_q=None):
    """Guided matching for one level's candidates: predict, gather the 3x3
    corner-bucket neighbourhood, warp the source patch, ZMSSD-score, refine
    sub-pixel, and build the level-0 uvu observation from the disparity.
    With `disp0` None (monocular) the observation is (u0, v0, 0) and no
    disparity gate applies."""
    focal, ppx, ppy = cam_l["focal"], cam_l["ppx"], cam_l["ppy"]
    w, h = cam_l["size"]
    N = xyz_w.shape[0]
    cy, cx, K, _ = buckets_uv.shape
    cell_h = -(-h // cy)
    cell_w = -(-w // cx)

    xyz_c = xyz_w @ R_cw.T + t_cw
    z_c = xyz_c[:, 2]
    z_safe = torch.where(torch.abs(z_c) < 1e-6, torch.full_like(z_c, 1e-6), z_c)
    u = xyz_c[:, 0] / z_safe * focal + ppx
    v = xyz_c[:, 1] / z_safe * focal + ppy
    pred_uv = torch.stack([u, v], dim=-1)
    in_img = (u >= 0) & (u < w) & (v >= 0) & (v < h) & (z_c > 0.1)

    xyz_a = torch.einsum("nij,nj->ni", R_aw, xyz_w) + t_aw
    z_a = xyz_a[:, 2]
    ratio = z_a / z_safe
    depth_ok = (ratio < 3.0) & (ratio > 1.0 / 3.0) & (z_a > 0.1)
    cand_ok = point_valid & in_img & depth_ok

    pc_y = float_to_index(torch.div(v, cell_h, rounding_mode="floor")).clamp(0, cy - 1)
    pc_x = float_to_index(torch.div(u, cell_w, rounding_mode="floor")).clamp(0, cx - 1)
    d3 = torch.arange(-1, 2, dtype=torch.int32, device=u.device)
    ny = (pc_y[:, None] + d3[None, :]).clamp(0, cy - 1)
    nx = (pc_x[:, None] + d3[None, :]).clamp(0, cx - 1)
    gy = torch.repeat_interleave(ny, 3, dim=1).long()
    gx = nx.repeat(1, 3).long()
    c_uv = buckets_uv[gy, gx].reshape(N, 9 * K, 2)
    c_val = buckets_valid[gy, gx].reshape(N, 9 * K)
    dist2 = torch.sum((c_uv - pred_uv[:, None, :]) ** 2, dim=-1)
    c_val = c_val & (dist2 <= search_radius * search_radius)

    R_ca = torch.einsum("ij,nkj->nik", R_cw, R_aw)
    A_a2c = affine_from_geometry(focal, focal, R_ca, xyz_a, xyz_c)
    det = A_a2c[:, 0, 0] * A_a2c[:, 1, 1] - A_a2c[:, 0, 1] * A_a2c[:, 1, 0]
    det_ok = torch.abs(det) > 1e-4
    det_safe = torch.where(det_ok, det, torch.ones_like(det))
    A_c2a = torch.stack(
        [
            torch.stack([A_a2c[:, 1, 1], -A_a2c[:, 0, 1]], dim=-1),
            torch.stack([-A_a2c[:, 1, 0], A_a2c[:, 0, 0]], dim=-1),
        ],
        dim=-2,
    ) / det_safe[:, None, None]
    # offsets built on the device (a host array here would be a copy that
    # waits on the stream)
    ref_patch, warp_ok = _warp_from_source(
        source_patches, A_c2a, source_q=source_patches_q)
    cand_ok = cand_ok & det_ok & warp_ok

    cand_patches = bucket_patches[gy, gx].reshape(N, 9 * K, 64)
    patch_ok = bucket_patch_ok[gy, gx].reshape(N, 9 * K)

    a = ref_patch - torch.mean(ref_patch, dim=-1, keepdim=True)
    b = cand_patches - torch.mean(cand_patches, dim=-1, keepdim=True)
    score = (
        torch.sum(a * a, dim=-1)[:, None]
        + torch.sum(b * b, dim=-1)
        - 2.0 * torch.einsum("np,nmp->nm", a, b)
    )
    score = torch.where(c_val & patch_ok, score,
                        torch.full_like(score, float("inf")))
    best = torch.argmin(score, dim=-1)
    best_score = torch.gather(score, 1, best[:, None])[:, 0]
    corner = torch.gather(c_uv, 1, best[:, None, None].expand(-1, 1, 2))[:, 0, :]
    matched = cand_ok & torch.isfinite(best_score) & (best_score < zmssd_thr)

    best_patch = torch.gather(
        cand_patches, 1, best[:, None, None].expand(-1, 1, 64))[:, 0, :]
    corner = corner - _subpixel_delta(ref_patch, best_patch)

    s = float(2**level)
    uv0 = (corner + 0.5) * s - 0.5
    if disp0 is None:  # monocular: uv observation, no disparity gate
        return torch.cat([uv0, torch.zeros_like(uv0[:, :1])], dim=-1), matched
    disp_val, disp_ok = nearest_sample(disp0, uv0)
    matched = matched & disp_ok & (disp_val > 0)
    obs = torch.stack([uv0[:, 0], uv0[:, 1], uv0[:, 0] - disp_val], dim=-1)
    return obs, matched


def _disparity(img_s, right_s, external_disp, use_external_disp, stereo_method,
               num_disp, stereo_opts):
    if use_external_disp:
        return external_disp
    iters, levels, nr_plane = stereo_opts
    if stereo_method == 3:
        return belief_propagation_disparity(
            img_s, right_s, num_disp=num_disp, iters=max(5, iters),
            levels=max(4, levels))
    if stereo_method == 4:
        return constant_space_bp_disparity(
            img_s, right_s, num_disp=num_disp, iters=iters, levels=levels,
            nr_plane=nr_plane)
    if stereo_method == 1:
        return block_matching_disparity(img_s, right_s, num_disp=num_disp,
                                        radius=5)
    return block_matching_disparity_bm(img_s, right_s, num_disp=num_disp,
                                       radius=5)


def frontend_step(
    frames_stacked,  # (2 or 3, H, W): left, right[, external disparity]
    prev_clouds, prev_intens, prev_valids, prev_J,
    R_cw_prev, t_cw_prev,  # previous frame's world pose (chain seed)
    actkey_id: int,  # keyframe-policy statistics only
    poses: PoseTable,
    points: PointTable,
    cand_ids,  # (C,) int tensor, -1 padded
    cam_params,  # per-level (focal, ppx, ppy, baseline) f32-valued floats
    cam_statics,  # per-level (w, h)
    levels: int = 3,
    num_disp: int = 64,
    use_external_disp: bool = False,
    max_reproj_err: float = 2.0,
    stereo_method: int = 2,  # 1/2 block matching, 3 BP, 4 CSBP
    stereo_opts: tuple = (4, 4, 4),  # (iters, levels, nr_plane) of BP/CSBP
    *,
    dense_subs: tuple = DENSE_SUBS,  # dense-cloud per-level subsampling
    dense_sample: str = "qpack",  # one of DENSE_SAMPLERS (both exact)
) -> FrontendStepOut:
    if dense_sample not in DENSE_SAMPLERS:
        raise ValueError(f"dense_sample {dense_sample!r} not in "
                         f"{DENSE_SAMPLERS}")
    dev = frames_stacked.device
    f32 = torch.float32
    # -- 1. unpack + preprocess (uint8 frames normalized on device)
    frames_f = normalize_frames(frames_stacked)
    img = frames_f[0]
    right = frames_f[1]
    external_disp = frames_f[2] if use_external_disp else frames_f[0]
    # sensor-noise prefilter on the stereo and corner inputs only; dense
    # tracking and ZMSSD patches use the raw pyramid
    img_s, right_s = binomial3(img), binomial3(right)
    pyr = build_pyramid(img, levels)
    dxs, dys = [], []
    for p in pyr:
        dx_, dy_ = sobel_xy(p)
        dxs.append(dx_)
        dys.append(dy_)
    dxs, dys = tuple(dxs), tuple(dys)

    # -- 2. disparity
    disp = _disparity(img_s, right_s, external_disp, use_external_disp,
                      stereo_method, num_disp, stereo_opts)

    K_cap = poses.R.shape[0]
    R_akw = poses.R[actkey_id]
    t_akw = poses.t[actkey_id]

    # -- 3. dense tracking, coarse to fine, anchored at the previous frame
    R_d = torch.eye(3, dtype=f32, device=dev)
    t_d = torch.zeros(3, dtype=f32, device=dev)
    dense_chi2 = torch.zeros((), dtype=f32, device=dev)
    for level in range(levels - 1, -1, -1):
        focal, ppx, ppy, baseline = cam_params[level]
        cam_l = StereoCamera(focal, (ppx, ppy), cam_statics[level], baseline)
        R_d, t_d, chi2_l, _ = _lm_level_ic(
            cam_l, pyr[level],
            prev_clouds[level], prev_intens[level], prev_J[level],
            prev_valids[level], R_d, t_d,
        )
        dense_chi2 = chi2_l

    # -- 4. pose estimate in world frame
    R_cw = R_d @ R_cw_prev
    t_cw = R_d @ t_cw_prev + t_d

    # -- 5. materialize candidates from the device tables
    P_cap = points.psi.shape[0]
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
    ok = ((cand_ids >= 0) & points.valid[safe] & poses.valid[a_idx]
          & (q[:, 0] > 1e-9))

    # -- 6. guided matching per level, each on its own candidate section
    C = cand_ids.shape[0]
    caps = level_sections(levels, C)
    sec_off = 0
    obs_secs, matched_secs = [], []
    for l in range(levels):
        focal, ppx, ppy, baseline = cam_params[l]
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
        sec_patches = patches[sl]
        lvl_ok = ok[sl] & (cand_levels[sl] == l)
        obs_l, m_l = _match_one_level(
            {"focal": focal, "ppx": ppx, "ppy": ppy, "size": (w_l, h_l)},
            pyr[l], R_cw, t_cw, xyz_w[sl], R_aw[sl], t_aw[sl], sec_patches,
            lvl_ok, buckets_uv, buckets_valid, bucket_patches,
            bucket_patch_ok, disp, l, ZMSSD_THR, MATCH_SEARCH_RADIUS_PX,
            source_patches_q=qpack_patches(sec_patches),
        )
        obs_secs.append(obs_l)
        matched_secs.append(m_l)
    obs_all = torch.cat(obs_secs, dim=0)
    matched_all = torch.cat(matched_secs, dim=0)
    n_matched = torch.sum(matched_all.to(torch.int32))

    # -- 7. robust motion-only BA (2 rounds with rejection)
    focal0, ppx0, ppy0, baseline0 = cam_params[0]
    cam0 = StereoCamera(focal0, (ppx0, ppy0), cam_statics[0], baseline0)
    weights = (0.25 ** cand_levels.to(f32)) * matched_all
    res = motion_only_ba(cam0, SE3(R_cw, t_cw), xyz_w, obs_all, weights,
                         matched_all, 1.0)
    keep = (matched_all & res.inlier_mask
            & (torch.amax(torch.abs(res.residuals), dim=-1)
               < max_reproj_err * 2.0))
    res = motion_only_ba(cam0, res.T, xyz_w, obs_all, weights, keep, 1.0)

    # -- 8. gating + policy statistics
    lvl_scale = (2.0 ** cand_levels).to(f32)
    resid = res.residuals
    gate = (
        matched_all & res.inlier_mask
        & (torch.abs(resid[:, 0]) < max_reproj_err * lvl_scale)
        & (torch.abs(resid[:, 1]) < max_reproj_err * lvl_scale)
        & (torch.abs(resid[:, 0] - resid[:, 2]) < 6.0)
    )
    n_gated = torch.sum(gate.to(torch.int32))
    # a BA below the tracking floor must not move the pose chain: keep the
    # dense-tracking pose (the host still treats the frame as failed)
    ba_ok = (n_matched >= 20) & (n_gated >= 20)
    R_cw = torch.where(ba_ok, res.T.R, R_cw)
    t_cw = torch.where(ba_ok, res.T.t, t_cw)

    w0, h0 = cam_statics[0]
    qx = (obs_all[:, 0] > w0 / 2).to(torch.int64)
    qy = (obs_all[:, 1] > h0 / 2).to(torch.int64)
    quad = qy * 2 + qx
    quad_counts = torch.sum(
        F.one_hot(quad, 4).to(torch.int32) * gate[:, None].to(torch.int32),
        dim=0)

    # T_cur_from_actkey (statistics / host policy)
    R_cak_new = R_cw @ R_akw.T
    t_cak_new = t_cw - R_cak_new @ t_akw
    t_norm = torch.linalg.norm(t_cak_new)

    own = gate & (points.anchor[safe] == actkey_id)
    track_len = torch.linalg.norm(obs_all[:, :2] - cand_uv0, dim=-1)
    n_own = torch.clamp(torch.sum(own.to(f32)), min=1.0)
    mean_track_len = torch.sum(
        torch.where(own, track_len, torch.zeros_like(track_len))) / n_own

    # -- 9. next frame's dense state, anchored at THIS frame
    clouds, valids, intens, cloud_J = _cloud_state(
        pyr, disp, torch.eye(3, dtype=f32, device=dev),
        torch.zeros(3, dtype=f32, device=dev), cam_params, levels, dxs, dys,
        dense_subs=dense_subs)

    packed = torch.cat([
        R_cw.reshape(-1), t_cw,                      # 0:9, 9:12
        R_cak_new.reshape(-1), t_cak_new,            # 12:21, 21:24
        torch.stack([
            n_matched.to(f32),                       # 24
            n_gated.to(f32),                         # 25
            t_norm, mean_track_len,                  # 26, 27
            dense_chi2, res.chi2,                    # 28, 29
        ]),
        quad_counts.to(f32),                         # 30:34
        gate.to(f32),                                # 34:34+C
        matched_all.to(f32),                         # +C
        obs_all.reshape(-1),                         # +3C
    ])
    return FrontendStepOut(
        packed,
        R_cw, t_cw, R_cak_new, t_cak_new,
        gate, matched_all, obs_all,
        n_matched, n_gated, quad_counts, t_norm, mean_track_len,
        dense_chi2, res.chi2,
        pyr, dxs, dys, disp,
        clouds, valids, intens, cloud_J,
    )


def _cloud_state(pyr, disp, R_cak, t_cak, cam_params, levels, dxs=None,
                 dys=None, dense_subs=DENSE_SUBS):
    """Back-project the disparity map into the ACTKEY frame per level,
    subsampled per `dense_subs`. With the frame's Sobel pyramids (dxs/dys)
    also returns the per-level inverse-compositional template Jacobians
    (valid for the identity anchor only)."""
    clouds, valids, intens, Js = [], [], [], []
    dev = disp.device
    for level in range(levels):
        s = 2**level
        sub = dense_subs[level] if level < len(dense_subs) else 1
        focal, ppx, ppy, baseline = cam_params[level]
        d_l = disp[:: s * sub, :: s * sub]
        hh, ww = d_l.shape
        v_idx = torch.arange(hh, dtype=torch.float32, device=dev)[:, None] * sub
        u_idx = torch.arange(ww, dtype=torch.float32, device=dev)[None, :] * sub
        valid = d_l > 0.0
        d_safe = torch.where(valid, d_l, torch.ones_like(d_l))
        # f*b is level-invariant: the level-0 disparity value gives the
        # depth directly with the level camera
        fb = float(np.float32(focal) * np.float32(baseline))
        z = fb / d_safe
        x = (u_idx - ppx) / focal * z
        y = (v_idx - ppy) / focal * z
        xyz = torch.stack([x.reshape(-1), y.reshape(-1), z.reshape(-1)], -1)
        xyz_ak = (xyz - t_cak[None, :]) @ R_cak
        clouds.append(xyz_ak)
        valids.append(valid.reshape(-1))
        intens.append(pyr[level][::sub, ::sub].reshape(-1))
        if dxs is not None:
            Js.append(template_jacobian(
                focal, xyz,  # pre-rebase xyz: the template frame's coords
                dxs[level][::sub, ::sub].reshape(-1),
                dys[level][::sub, ::sub].reshape(-1),
                valid.reshape(-1),
            ))
    if dxs is not None:
        return tuple(clouds), tuple(valids), tuple(intens), tuple(Js)
    return tuple(clouds), tuple(valids), tuple(intens)


def rebuild_cloud_state(pyr, disp, R_cak, t_cak, cam_params, levels=3,
                        dense_subs=DENSE_SUBS):
    """Re-express the dense-tracking reference state relative to a new
    actkey."""
    return _cloud_state(pyr, disp, R_cak, t_cak, cam_params, levels,
                        dense_subs=dense_subs)


# -- new-keyframe point spawning ------------------------------------------------


def spawn_points_step(
    pyr,  # tuple of level images (from frontend_step output)
    disp,  # level-0 disparity
    tracked_uv0,  # (T, 2) level-0 positions of gated tracked obs (padded)
    tracked_valid,  # (T,)
    points: PointTable,
    start_indices,  # per-level block starts in the point table (host ints)
    kf_id: int,
    cam_params,
    cam_statics,
    levels: int = 3,
    caps: tuple = (320, 96, 32),
    clearance: float = 2.0,
    pr_vocab=None,  # (K, 128) BoW vocabulary: append the place-recognition
    # describe block of this keyframe to the payload
):
    """Detect corners per level, gate by disparity + clearance from tracked
    observations, back-project to anchored psi, capture 16x16 source
    patches, and write all blocks into the point table (parity:
    addMorePoints). With `pr_vocab` the payload also carries the keyframe's
    ``bow_describe`` block (BOW_KEYPOINTS x BOW_COLS, row-major), so the
    place recognizer indexes it with no device work of its own (the describe
    half of placerecognizer.cpp:222-246). Returns (new_points_table, one
    packed payload vector)."""
    payloads = []
    offs = torch.as_tensor(_patch_offsets_int(SOURCE_PATCH), device=disp.device)
    for l in range(levels):
        cap = caps[l]
        focal, ppx, ppy, baseline = cam_params[l]
        uv, score, valid = detect_corners_grid(
            binomial3(pyr[l]), FAST_THRESHOLD, 3, 3, -(-cap // 9))
        s = float(2**l)
        uv0 = (uv + 0.5) * s - 0.5
        dval, dok = nearest_sample(disp, uv0)
        ok = valid & dok & (dval > 0.5)
        d2 = torch.sum((uv0[:, None, :] - tracked_uv0[None, :, :]) ** 2, dim=-1)
        d2 = torch.where(tracked_valid[None, :], d2,
                         torch.full_like(d2, float("inf")))
        min_d2 = torch.amin(d2, dim=-1)
        cl = float(np.float32(clearance) * np.float32(s))
        ok = ok & (min_d2 > cl * cl)
        rank_score = torch.where(ok, score, torch.full_like(score, -1.0))
        top_idx = torch.sort(-rank_score, stable=True).indices[:cap]
        uv_k = uv[top_idx]
        uv0_k = uv0[top_idx]
        d_k = dval[top_idx]
        ok_k = ok[top_idx] & (rank_score[top_idx] > 0)

        d_safe = torch.where(ok_k, d_k, torch.ones_like(d_k))
        fb = float(np.float32(focal) * np.float32(baseline))
        z = fb / d_safe
        x = (uv_k[:, 0] - ppx) / focal * z
        y = (uv_k[:, 1] - ppy) / focal * z
        psi = torch.stack([x / z, y / z, 1.0 / z], dim=-1)

        coords = uv_k[:, None, :] + offs[None, :, :]
        pvals, p_ok = bilinear_sample(pyr[l], coords)
        ok_k = ok_k & torch.all(p_ok, dim=-1)
        patches = pvals.reshape(-1, SOURCE_PATCH, SOURCE_PATCH)

        uvu0 = torch.stack([uv0_k[:, 0], uv0_k[:, 1], uv0_k[:, 0] - d_k], dim=-1)
        points = points.insert_block(
            start_indices[l], psi, kf_id,
            torch.full((cap,), l, dtype=torch.int32, device=disp.device),
            patches, uv0_k, ok_k,
        )
        payloads.append(torch.cat(
            [psi.reshape(-1), uvu0.reshape(-1), ok_k.to(torch.float32)]))
    if pr_vocab is not None:
        payloads.append(bow_describe(
            pyr[0], disp, pr_vocab, cam_params[0], mono=False).reshape(-1))
    return points, torch.cat(payloads)


def spawn_points_step_packed(
    pyr, disp, packed: np.ndarray, points: PointTable, cam_params,
    cam_statics, levels: int = 3, caps: tuple = (320, 96, 32),
    clearance: float = 2.0, tracked_cap: int = 1024, pr_vocab=None,
):
    """spawn_points_step behind ONE host->device upload. `packed` is the
    twin's host f32 layout [tracked_uv0.ravel() (2T) | tracked_valid (T) |
    start_indices (levels) | kf_id]; the block starts and the keyframe id
    stay on the host."""
    T = tracked_cap
    packed = np.asarray(packed, np.float32)
    dev_buf = torch.as_tensor(packed[: 3 * T], device=disp.device)
    uv0 = dev_buf[: 2 * T].reshape(T, 2)
    t_val = dev_buf[2 * T: 3 * T] > 0.5
    starts = [int(x) for x in packed[3 * T: 3 * T + levels]]
    kf_id = int(packed[3 * T + levels])
    return spawn_points_step(
        pyr, disp, uv0, t_val, points, starts, kf_id, cam_params,
        cam_statics, levels, caps, clearance, pr_vocab,
    )
