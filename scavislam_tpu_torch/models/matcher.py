"""Guided patch matching against bucketed FAST corners (port of
scavislam_tpu.models.matcher).

Each map point stores a 16x16 SOURCE patch captured at anchor time; the
matcher samples the central 8x8 of it through the local affine warp. The
twin packs each patch's 2x2 bilinear taps contiguously (``qpack_patches``)
because TPU gathers are transaction-bound; here ``qpack_patches`` is the
plain exact gather it stands for.

``match_level`` is the backend's matcher (registration and loop-closure
re-matching): it bilinear-samples the candidate patches from the image and
has no sub-pixel step, unlike the frame step's ``_match_one_level``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from scavislam_tpu_torch.core.camera import StereoCamera
from scavislam_tpu_torch.core.lie import SE3
from scavislam_tpu_torch.ops.image import (
    bilinear_sample,
    float_to_index,
    nearest_sample,
)
from scavislam_tpu_torch.ops.patches import PATCH, affine_from_geometry

SOURCE_PATCH = 16  # stored per-point source patch side
DEPTH_RATIO_MAX = 3.0  # reject depth change > 3x


class MatchResult(NamedTuple):
    obs_uvu: torch.Tensor  # (N, 3) level-0 uvu observations
    matched: torch.Tensor  # (N,) bool
    corner_uv: torch.Tensor  # (N, 2) matched corner, level-l pixel coords
    score: torch.Tensor  # (N,) best ZMSSD score
    pred_uv: torch.Tensor  # (N, 2) predicted position, level-l coords


def _patch_offsets_int(size: int) -> np.ndarray:
    """Integer offsets -size//2 .. size//2-1 in (ou, ov) raster order."""
    r = np.arange(size, dtype=np.float32) - size // 2
    ou, ov = np.meshgrid(r, r)
    return np.stack([ou.reshape(-1), ov.reshape(-1)], axis=-1)


def _patch_offsets(size: int, device) -> torch.Tensor:
    """`_patch_offsets_int` built on `device` (no host copy, no sync)."""
    r = torch.arange(size, dtype=torch.float32, device=device) - size // 2
    ov, ou = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([ou.reshape(-1), ov.reshape(-1)], dim=-1)


def capture_source_patches(img_level: torch.Tensor, uv_level: torch.Tensor):
    """Extract (N, 16, 16) source patches at anchor time (axis-aligned,
    integer offsets: grid position g is physical offset g - SOURCE_PATCH//2).
    Returns (patches, all-in-image mask)."""
    offs = _patch_offsets(SOURCE_PATCH, uv_level.device)
    coords = uv_level[:, None, :] + offs[None, :, :]
    vals, ok = bilinear_sample(img_level, coords)
    return vals.reshape(-1, SOURCE_PATCH, SOURCE_PATCH), torch.all(ok, dim=-1)


def qpack_patches(source: torch.Tensor) -> torch.Tensor:
    """(N, S, S) patches -> (N*S*S,) flat table that `_warp_from_source`
    gathers its four bilinear taps from (the twin packs the taps; the values
    read are the same)."""
    return source.reshape(-1)


def _warp_from_source(source: torch.Tensor, A: torch.Tensor, offsets=None,
                      source_q: torch.Tensor = None):
    """Sample the central 8x8 of each 16x16 source patch through affine A
    (A maps current-frame offsets to anchor-frame offsets).

    source: (N, 16, 16); A: (N, 2, 2) -> ((N, 64) values, (N,) all-in-patch)
    """
    offs = (_patch_offsets(PATCH, A.device) if offsets is None
            else torch.as_tensor(offsets, dtype=A.dtype, device=A.device))
    center = float(SOURCE_PATCH // 2)
    w_offs = torch.einsum("nij,pj->npi", A, offs)  # (N, 64, 2)
    coords = w_offs + center
    n = source.shape[0]
    S = SOURCE_PATCH
    u = coords[..., 0]
    v = coords[..., 1]
    u0 = float_to_index(torch.floor(u)).clamp(0, S - 2)
    v0 = float_to_index(torch.floor(v)).clamp(0, S - 2)
    fu = u - u0
    fv = v - v0
    ok = (u >= 0) & (v >= 0) & (u <= S - 1) & (v <= S - 1)
    base = (torch.arange(n, dtype=torch.int64, device=A.device) * (S * S))[:, None]
    flat = source_q if source_q is not None else qpack_patches(source)
    i00 = base + (v0 * S + u0).long()
    vals = (flat[i00] * (1 - fu) + flat[i00 + 1] * fu) * (1 - fv) + (
        flat[i00 + S] * (1 - fu) + flat[i00 + S + 1] * fu
    ) * fv
    return vals, torch.all(ok, dim=-1)


def match_level(
    cam_level: StereoCamera,
    img_level: torch.Tensor,
    T_cw: SE3,
    xyz_w: torch.Tensor,
    anchors: SE3,  # batched (N,) anchor poses
    source_patches: torch.Tensor,
    point_valid: torch.Tensor,
    buckets: dict,
    disp0: torch.Tensor,
    level: int,
    zmssd_thr: float = 0.18,
    search_radius: float = 10.0,
) -> MatchResult:
    """Match one level's candidate points against its corner buckets."""
    return _match_level(
        (cam_level.focal, cam_level.pp[0], cam_level.pp[1], cam_level.baseline),
        cam_level.size, img_level, T_cw.R, T_cw.t, xyz_w, anchors.R,
        anchors.t, source_patches, point_valid, buckets["uv"],
        buckets["valid"], disp0, level, zmssd_thr, search_radius,
    )


def _match_level(
    cam_params, cam_size, img_level, R_cw, t_cw, xyz_w, R_aw, t_aw,
    source_patches, point_valid, buckets_uv, buckets_valid, disp0,
    level, zmssd_thr, search_radius,
):
    """Predict each point's pixel, gather the 3x3 corner-bucket
    neighbourhood within `search_radius`, warp the stored source patch by
    the local affine map, score the bilinear-sampled candidate patches by
    ZMSSD, and build the level-0 uvu observation from the disparity."""
    focal, ppx, ppy, _ = cam_params
    w, h = cam_size
    N = xyz_w.shape[0]
    cy, cx, K, _ = buckets_uv.shape
    cell_h = -(-h // cy)
    cell_w = -(-w // cx)

    # ---- predict
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
    depth_ok = ((ratio < DEPTH_RATIO_MAX) & (ratio > 1.0 / DEPTH_RATIO_MAX)
                & (z_a > 0.1))
    cand_ok = point_valid & in_img & depth_ok

    # ---- gather 3x3 corner buckets
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

    # ---- affine warp of stored source patches
    R_ca = torch.einsum("ij,nkj->nik", R_cw, R_aw)  # R_cw @ R_aw^T
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
    ref_patch, warp_ok = _warp_from_source(source_patches, A_c2a)
    cand_ok = cand_ok & det_ok & warp_ok

    # ---- candidate patches + ZMSSD (integer offsets, same grid as warp)
    offs = _patch_offsets(PATCH, u.device)
    coords = c_uv[:, :, None, :] + offs[None, None, :, :]  # (N, M, 64, 2)
    cand_patches, patch_ok = bilinear_sample(img_level, coords)
    patch_ok = torch.all(patch_ok, dim=-1)  # (N, M)

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

    # ---- build level-0 uvu observation from the disparity map
    s = float(2**level)
    uv0 = (corner + 0.5) * s - 0.5
    disp_val, disp_ok = nearest_sample(disp0, uv0)
    matched = matched & disp_ok & (disp_val > 0)
    obs = torch.stack([uv0[:, 0], uv0[:, 1], uv0[:, 0] - disp_val], dim=-1)
    return MatchResult(obs, matched, corner, best_score, pred_uv)
