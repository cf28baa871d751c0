"""FAST-9/16 corners with per-cell budgets (port of scavislam_tpu.ops.fast).

Every pixel's FAST-9 test and contrast score come from 16 rolled copies of
the image, then 3x3 non-max suppression, then the top-K corners per grid
cell. The per-cell selection breaks score ties by the lower index, as
``jax.lax.top_k`` does (a stable descending sort).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from scavislam_tpu_torch.ops.image import binomial3

# Bresenham circle of radius 3 (the FAST-16 ring), (du, dv) offsets.
_CIRCLE = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1),
        (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1),
        (-3, 0), (-3, -1), (-2, -2), (-1, -3),
    ],
    dtype=np.int32,
)
ARC_LEN = 9  # FAST-9


def fast_score_map(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """Per-pixel FAST-9 corner response; 0 where not a corner. Score = max
    over the two polarities of the summed thresholded contrast."""
    h, w = img.shape
    ring = torch.stack(
        [torch.roll(img, (-int(dv), -int(du)), dims=(0, 1))
         for du, dv in _CIRCLE],
        dim=0,
    )
    diff = ring - img[None, :, :]
    bright = diff > threshold
    dark = diff < -threshold

    def arc_all(mask):
        acc = mask
        for k in range(1, ARC_LEN):
            acc = acc & torch.roll(mask, -k, dims=0)
        return torch.any(acc, dim=0)

    is_corner = arc_all(bright) | arc_all(dark)

    # ring sums in ring order (explicit, so the order is the twin's)
    pos = torch.clamp(diff - threshold, min=0.0)
    neg = torch.clamp(-diff - threshold, min=0.0)
    score_b, score_d = pos[0], neg[0]
    for k in range(1, 16):
        score_b = score_b + pos[k]
        score_d = score_d + neg[k]
    score = torch.maximum(score_b, score_d)

    vv = torch.arange(h, device=img.device)[:, None]
    uu = torch.arange(w, device=img.device)[None, :]
    interior = (vv >= 3) & (vv < h - 3) & (uu >= 3) & (uu < w - 3)
    return torch.where(is_corner & interior, score, torch.zeros_like(score))


def nonmax_suppress_3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep local maxima of the score map (8-neighbourhood, -inf padding)."""
    nb = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where(score >= nb, score, torch.zeros_like(score))


def detect_corners_grid(
    img: torch.Tensor,
    threshold: float = 10.0 / 255.0,
    cells_y: int = 6,
    cells_x: int = 8,
    per_cell: int = 32,
):
    """FAST-9 + NMS + per-cell top-K. Returns (uv (N, 2) float32,
    score (N,), valid (N,) bool), N = cells_y * cells_x * per_cell."""
    h, w = img.shape
    score = nonmax_suppress_3x3(fast_score_map(img, threshold))

    ch = -(-h // cells_y)
    cw = -(-w // cells_x)
    sp = F.pad(score, (0, cw * cells_x - w, 0, ch * cells_y - h))
    cells = sp.reshape(cells_y, ch, cells_x, cw).permute(0, 2, 1, 3)
    flat = cells.reshape(cells_y * cells_x, ch * cw)

    top_scores, top_idx = torch.sort(flat, dim=1, descending=True, stable=True)
    top_scores = top_scores[:, :per_cell]
    top_idx = top_idx[:, :per_cell]
    valid = top_scores > 0.0

    cell_ids = torch.arange(cells_y * cells_x, device=img.device)[:, None]
    cy = cell_ids // cells_x
    cx = cell_ids % cells_x
    vs = (cy * ch + top_idx // cw).to(torch.float32)
    us = (cx * cw + top_idx % cw).to(torch.float32)
    uv = torch.stack([us.reshape(-1), vs.reshape(-1)], dim=-1)
    return uv, top_scores.reshape(-1), valid.reshape(-1)


def corner_buckets(
    img: torch.Tensor,
    threshold: float = 10.0 / 255.0,
    cells_y: int = 24,
    cells_x: int = 32,
    per_cell: int = 8,
):
    """The corners of :func:`detect_corners_grid` organized as (cells_y,
    cells_x, per_cell) buckets, so a matcher gathers the 3x3 cell
    neighbourhood of any predicted location in O(1).

    Returns dict with "uv" (cy, cx, K, 2), "score" (cy, cx, K) and
    "valid" (cy, cx, K)."""
    uv, score, valid = detect_corners_grid(
        img, threshold, cells_y, cells_x, per_cell)
    return {
        "uv": uv.reshape(cells_y, cells_x, per_cell, 2),
        "score": score.reshape(cells_y, cells_x, per_cell),
        "valid": valid.reshape(cells_y, cells_x, per_cell),
    }


def corner_buckets_prefiltered(
    img: torch.Tensor,
    threshold: float = 10.0 / 255.0,
    cells_y: int = 24,
    cells_x: int = 32,
    per_cell: int = 8,
):
    """:func:`corner_buckets` on the 3x3-binomial-smoothed image: the
    backend's re-detection mirrors the frame step's sensor-noise prefilter,
    so it finds the frame step's corners."""
    return corner_buckets(binomial3(img), threshold, cells_y, cells_x,
                          per_cell)
