"""Patch geometry for guided matching (port of the parts of
scavislam_tpu.ops.patches the stereo-VO slice uses)."""

from __future__ import annotations

import torch

PATCH = 8  # patch side; the reference's halfpatch_size = 4


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
