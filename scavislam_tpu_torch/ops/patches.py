"""Patch extraction, affine warping and ZMSSD scoring, batched (port of
scavislam_tpu.ops.patches).

All functions are shape-static; invalid entries are masked, not skipped.
The frame step's guided matcher has its own fused form of these
(models.matcher, models.frontend_step); the functions here are the public
ones.
"""

from __future__ import annotations

import numpy as np
import torch

from scavislam_tpu_torch.ops.image import bilinear_sample

PATCH = 8  # patch side; the reference's halfpatch_size = 4


def _patch_offsets(size: int = PATCH) -> np.ndarray:
    """(size*size, 2) float offsets centred on the patch centre, (ou, ov)
    in raster order."""
    r = np.arange(size, dtype=np.float32) - (size - 1) / 2.0
    ou, ov = np.meshgrid(r, r)
    return np.stack([ou.reshape(-1), ov.reshape(-1)], axis=-1)


def _offsets_on(uv: torch.Tensor, size: int) -> torch.Tensor:
    return torch.as_tensor(_patch_offsets(size), dtype=uv.dtype,
                           device=uv.device)


def extract_patches(img: torch.Tensor, uv: torch.Tensor, size: int = PATCH):
    """Axis-aligned patches at centres uv (N, 2). Returns (patches
    (N, size*size), valid (N,)): valid iff every sample lies in the image."""
    coords = uv[:, None, :] + _offsets_on(uv, size)[None, :, :]
    vals, ok = bilinear_sample(img, coords)
    return vals, torch.all(ok, dim=-1)


def extract_patches_warped(img: torch.Tensor, uv: torch.Tensor,
                           A: torch.Tensor, size: int = PATCH):
    """Patches at uv with a per-patch 2x2 affine warp A (N, 2, 2): sample at
    uv + A @ offset (the reference patch warped toward the current view)."""
    w_offs = torch.einsum("nij,pj->npi", A, _offsets_on(uv, size))
    vals, ok = bilinear_sample(img, uv[:, None, :] + w_offs)
    return vals, torch.all(ok, dim=-1)


def zmssd(ref: torch.Tensor, cands: torch.Tensor) -> torch.Tensor:
    """Zero-mean SSD between each reference patch (N, P) and its candidates
    (N, M, P): (N, M) scores, lower is better. Expanded into norms and a
    cross term, the cross term one batched product."""
    a = ref - torch.mean(ref, dim=-1, keepdim=True)
    b = cands - torch.mean(cands, dim=-1, keepdim=True)
    a2 = torch.sum(a * a, dim=-1)  # (N,)
    b2 = torch.sum(b * b, dim=-1)  # (N, M)
    ab = torch.einsum("np,nmp->nm", a, b)
    return a2[:, None] + b2 - 2.0 * ab


def patch_variance(p: torch.Tensor) -> torch.Tensor:
    """Per-patch intensity variance (low-texture rejection)."""
    m = torch.mean(p, dim=-1, keepdim=True)
    return torch.mean((p - m) ** 2, dim=-1)


def affine_from_geometry(focal_ref, focal_cur, R_cur_from_anchor: torch.Tensor,
                         xyz_anchor: torch.Tensor, xyz_cur: torch.Tensor):
    """Local affine map A = d(uv_cur)/d(uv_anchor) (N, 2, 2) from the
    first-order expansion of (project o rigid o unproject-at-depth), a
    fronto-parallel local patch assumption:

      A = Jproj(xyz_cur) @ R_ca @ [z_a/f_ref * e1, z_a/f_ref * e2]
    """
    z_a = xyz_anchor[..., 2]
    z_c = xyz_cur[..., 2]
    x_c = xyz_cur[..., 0]
    y_c = xyz_cur[..., 1]
    zc2 = z_c * z_c
    zero = torch.zeros_like(z_c)
    Jp = torch.stack(
        [
            torch.stack([focal_cur / z_c, zero, -focal_cur * x_c / zc2], dim=-1),
            torch.stack([zero, focal_cur / z_c, -focal_cur * y_c / zc2], dim=-1),
        ],
        dim=-2,
    )  # (N, 2, 3)
    scale = (z_a / focal_ref)[..., None]
    du = R_cur_from_anchor[..., :, 0] * scale  # (N, 3)
    dv = R_cur_from_anchor[..., :, 1] * scale
    cols = torch.stack([du, dv], dim=-1)  # (N, 3, 2)
    return Jp @ cols
