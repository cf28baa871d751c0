"""Patch warping for guided matching (port of the parts of
scavislam_tpu.models.matcher that the frame step runs).

Each map point stores a 16x16 SOURCE patch captured at anchor time; the
matcher samples the central 8x8 of it through the local affine warp. The
twin packs each patch's 2x2 bilinear taps contiguously (``qpack_patches``)
because TPU gathers are transaction-bound; here ``qpack_patches`` is the
plain exact gather it stands for.
"""

from __future__ import annotations

import numpy as np
import torch

from scavislam_tpu_torch.ops.image import float_to_index
from scavislam_tpu_torch.ops.patches import PATCH

SOURCE_PATCH = 16  # stored per-point source patch side


def _patch_offsets_int(size: int) -> np.ndarray:
    """Integer offsets -size//2 .. size//2-1 in (ou, ov) raster order."""
    r = np.arange(size, dtype=np.float32) - size // 2
    ou, ov = np.meshgrid(r, r)
    return np.stack([ou.reshape(-1), ov.reshape(-1)], axis=-1)


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
    offs = torch.as_tensor(
        offsets if offsets is not None else _patch_offsets_int(PATCH),
        dtype=A.dtype, device=A.device)  # (64, 2)
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
