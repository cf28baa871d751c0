"""Batched 128-D gradient-histogram descriptors (port of
scavislam_tpu.ops.descriptors).

An upright SIFT-style descriptor (4x4 spatial cells x 8 orientation bins
over a 16x16 gradient patch, Gaussian weighted, L2-normalized with SIFT's
0.2 clipping) computed for all keypoints at once with batched bilinear
gathers. The twin builds the histogram from two (N, 256, 128) one-hot
tensors; here each sample's two bilinear orientation weights are
scatter-added into (N, 128), the same sums in another order.

``bow_describe`` is the whole place-recognition describe pipeline (FAST
corners -> disparity gate -> descriptors -> back-projection -> bag-of-words
quantization) returning one packed (BOW_KEYPOINTS, BOW_COLS) block; it runs
standalone (models.placerec) and inside the keyframe-spawn step
(models.frontend_step), whose payload carries the block home.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from scavislam_tpu_torch.ops.fast import detect_corners_grid
from scavislam_tpu_torch.ops.image import (bilinear_sample, nearest_sample,
                                           sobel_xy)

DESC_DIM = 128
GRID = 4  # 4x4 spatial cells
BINS = 8  # orientation bins
SUPPORT = 16  # 16x16 sample grid

# the place-recognition keypoint budget (models.placerec.MAX_KEYPOINTS
# aliases this) and the column layout of one bow_describe row:
# [word | desc(128) | u v d | x y z | valid]
BOW_KEYPOINTS = 256
BOW_COLS = DESC_DIM + 8


def _sample_offsets(scale: float = 1.0):
    r = (np.arange(SUPPORT, dtype=np.float32) - (SUPPORT - 1) / 2.0) * scale
    ou, ov = np.meshgrid(r, r)
    return np.stack([ou.reshape(-1), ov.reshape(-1)], axis=-1)  # (256, 2)


def _cell_index():
    """Spatial cell id (0..15) for each of the 256 samples."""
    idx = np.arange(SUPPORT)
    cell = np.minimum(idx * GRID // SUPPORT, GRID - 1)
    cu, cv = np.meshgrid(cell, cell)
    return (cv * GRID + cu).reshape(-1)  # (256,)


# Gaussian weighting of the support window (SIFT sigma = half window)
def _gauss_weights():
    r = np.arange(SUPPORT, dtype=np.float32) - (SUPPORT - 1) / 2.0
    g = np.exp(-(r**2) / (2 * (SUPPORT / 2) ** 2))
    return np.outer(g, g).reshape(-1)


@lru_cache(maxsize=8)
def _constants(device: torch.device):
    """The sample offsets (256, 2), Gaussian weights (1, 256) and cell ids
    (1, 256) as tensors on `device`, uploaded once per device (an upload
    from host memory per call would wait on the device)."""
    return (torch.as_tensor(_sample_offsets(), device=device),
            torch.as_tensor(_gauss_weights(), device=device)[None, :],
            torch.as_tensor(_cell_index(), device=device)[None, :])


def compute_descriptors(dx_img: torch.Tensor, dy_img: torch.Tensor,
                        uv: torch.Tensor, scale: torch.Tensor = None):
    """(N, 128) descriptors of the keypoints `uv` (N, 2) (level-0 pixels)
    on the gradient images; `scale` (N,) multiplies the sample spacing
    (default 1). Returns (desc, valid)."""
    dev = uv.device
    n = uv.shape[0]
    offs, gw, cell = _constants(dev)
    if scale is None:
        coords = uv[:, None, :] + offs[None, :, :]
    else:
        coords = uv[:, None, :] + offs[None, :, :] * scale[:, None, None]
    gx, okx = bilinear_sample(dx_img, coords)
    gy, oky = bilinear_sample(dy_img, coords)
    valid = torch.all(okx & oky, dim=-1)

    mag = torch.sqrt(gx * gx + gy * gy + 1e-12)
    ang = torch.atan2(gy, gx)  # [-pi, pi]
    binf = (ang + math.pi) * (BINS / (2.0 * math.pi))  # [0, 8)
    fl = torch.floor(binf)
    b0 = torch.remainder(fl.to(torch.int64), BINS)
    b1 = torch.remainder(b0 + 1, BINS)
    w1 = binf - fl
    w0 = 1.0 - w1

    mg = mag * gw
    hist = torch.zeros((n, DESC_DIM), dtype=torch.float32, device=dev)
    hist.scatter_add_(1, cell * BINS + b0, mg * w0)
    hist.scatter_add_(1, cell * BINS + b1, mg * w1)

    # SIFT normalization: L2 -> clip 0.2 -> L2
    norm = torch.linalg.vector_norm(hist, dim=-1, keepdim=True)
    hist = hist / torch.clamp(norm, min=1e-8)
    hist = torch.clamp(hist, max=0.2)
    norm = torch.linalg.vector_norm(hist, dim=-1, keepdim=True)
    return hist / torch.clamp(norm, min=1e-8), valid


def bow_describe(img: torch.Tensor, disp: torch.Tensor, vocab: torch.Tensor,
                 cam_params, mono: bool = False) -> torch.Tensor:
    """Corners -> disparity gate -> descriptors -> back-projection -> words,
    as ONE packed (BOW_KEYPOINTS, BOW_COLS) f32 tensor: [word | desc | u v d
    | x y z | valid] per row (parity: placerecognizer.cpp:130-152, 222-246).

    ``mono=True`` skips the depth gate and the back-projection (no right
    image): retrieval-only places, zero d and xyz; `disp` is not read."""
    focal, ppx, ppy, baseline = cam_params
    uv, _score, valid = detect_corners_grid(
        img, threshold=8.0 / 255.0, cells_y=8, cells_x=8,
        per_cell=BOW_KEYPOINTS // 64,
    )
    if mono:
        d = torch.zeros_like(uv[:, 0])
    else:
        d, dok = nearest_sample(disp, uv)
        valid = valid & dok & (d > 0.5)
    dx, dy = sobel_xy(img)
    desc, desc_ok = compute_descriptors(dx, dy, uv)
    valid = valid & desc_ok
    if mono:
        xyz = torch.zeros((uv.shape[0], 3), dtype=torch.float32,
                          device=uv.device)
    else:
        ds = torch.clamp(d, min=0.5)
        # f*b rounded to f32 once and divided as a tensor: the twin's
        # weakly typed scalar division (torch divides a Python scalar by a
        # tensor through its reciprocal)
        z = torch.full_like(ds, float(focal) * float(baseline)) / ds
        x = (uv[:, 0] - ppx) / focal * z
        y = (uv[:, 1] - ppy) / focal * z
        xyz = torch.stack([x, y, z], dim=-1)
    words = torch.argmax(desc @ vocab.T, dim=1)
    uvd = torch.stack([uv[:, 0], uv[:, 1], d], dim=-1)
    return torch.cat([
        words.to(torch.float32)[:, None], desc, uvd, xyz,
        valid.to(torch.float32)[:, None],
    ], dim=1)


def match_descriptors(desc_a: torch.Tensor, desc_b: torch.Tensor,
                      ratio: float = 0.8, valid_a: torch.Tensor = None,
                      valid_b: torch.Tensor = None):
    """Brute-force matching with Lowe's ratio test; one matmul. Returns
    (idx_b (Na,), ok (Na,)): the best match in b for each row of a
    (parity: the BFMatcher step of placerecognizer.cpp:174-202).

    `valid_a` / `valid_b` mask the padding rows of fixed-capacity tables:
    an invalid b row is never a match, an invalid a row is never ok."""
    sim = desc_a @ desc_b.T
    neg_inf = torch.full_like(sim, float("-inf"))
    if valid_b is not None:
        sim = torch.where(valid_b[None, :], sim, neg_inf)
    # distance^2 = 2 - 2 sim for unit vectors; argmax keeps the first
    # maximum, as jnp.argmax does (all -inf rows pick column 0)
    best = torch.argmax(sim, dim=1)
    s1 = torch.amax(sim, dim=1)
    rows = torch.arange(sim.shape[0], device=sim.device)
    sim_wo = sim.index_put((rows, best), neg_inf[:, 0])
    s2 = torch.amax(sim_wo, dim=1)
    d1 = torch.sqrt(torch.clamp(2.0 - 2.0 * s1, min=0.0))
    d2 = torch.sqrt(torch.clamp(2.0 - 2.0 * s2, min=1e-12))
    ok = (d1 < ratio * d2) & torch.isfinite(s1)
    if valid_a is not None:
        ok = ok & valid_a
    return best, ok
