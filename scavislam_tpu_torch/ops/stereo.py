"""Stereo disparity by block matching, as a (D, H, W) cost-volume tensor
program (port of scavislam_tpu.ops.stereo — the twin of the block-matching
kernel, and stereo method 1).

Semantics as the twin's: Sobel-x prefilter clipped to +-0.5, 11x11 SAD box
sums whose validity is an exact finite-sample count (a window touching a
column with no right-image counterpart is +inf), argmin, uniqueness against
the runner-up excluding d+-1, texture threshold, parabola subpixel, and the
left-right check. Invalid pixels get -1.

The hand-written kernel (ops.stereo_bm) uses the TPU kernel's BIG-constant
border bookkeeping instead; both reject the same interior pixels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from scavislam_tpu_torch.ops.image import sobel_xy


def _box_filter_1d(x: torch.Tensor, radius: int, axis: int) -> torch.Tensor:
    """Box sum of width 2r+1 along axis, same size, zero padding (prefix-sum
    difference, as the twin)."""
    k = 2 * radius + 1
    axis = axis % x.ndim
    n = x.shape[axis]
    pad = [0, 0] * x.ndim
    # F.pad lists pads from the LAST dim backwards
    j = 2 * (x.ndim - 1 - axis)
    pad[j], pad[j + 1] = radius, radius
    xp = F.pad(x, pad)
    c = torch.cumsum(xp, dim=axis)
    lead = c.narrow(axis, k - 1, n)
    zshape = list(c.shape)
    zshape[axis] = 1
    lag = torch.cat([torch.zeros(zshape, dtype=c.dtype, device=c.device),
                     c.narrow(axis, 0, n - 1)], dim=axis)
    return lead - lag


def box_filter(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Separable 2-D box sum over the last two axes."""
    return _box_filter_1d(_box_filter_1d(x, radius, -1), radius, -2)


def _sobel_x_prefilter(img: torch.Tensor, cap: float = 0.5) -> torch.Tensor:
    """OpenCV-StereoBM-style x-derivative prefilter, clipped."""
    dx, _ = sobel_xy(img)
    return torch.clamp(dx, -cap, cap)


def _cost_volume(left: torch.Tensor, right: torch.Tensor, num_disp: int):
    """(D, H, W) SAD numerators: cost[d] = |L(u,v) - R(u-d,v)|; columns with
    u < d have no counterpart and get +inf."""
    h, w = left.shape
    uu = torch.arange(w, device=left.device)[None, :]
    dd = torch.arange(num_disp, device=left.device)[:, None]
    src = uu - dd  # (D, W)
    shifted = right[:, src.clamp(0, w - 1)]  # (H, D, W)
    shifted = shifted.permute(1, 0, 2)  # (D, H, W)
    cost = torch.abs(left[None, :, :] - shifted)
    return torch.where((src >= 0)[:, None, :], cost,
                       torch.full_like(cost, float("inf")))


def block_matching_disparity(
    left: torch.Tensor,
    right: torch.Tensor,
    num_disp: int = 64,
    radius: int = 5,
    use_prefilter: bool = True,
    lr_check: bool = True,
    uniqueness_ratio: float = 1.10,
    texture_threshold: float = 0.01,
) -> torch.Tensor:
    """Dense disparity for a rectified pair. Returns float32 (H, W); invalid
    pixels get -1.0."""
    inf = float("inf")
    if use_prefilter:
        lf = _sobel_x_prefilter(left)
        rf = _sobel_x_prefilter(right)
    else:
        lf, rf = left, right

    raw = _cost_volume(lf, rf, num_disp)
    finite = torch.isfinite(raw)
    cost = box_filter(torch.where(finite, raw, torch.zeros_like(raw)), radius)
    count = box_filter(finite.to(torch.float32), radius)
    full = float((2 * radius + 1) ** 2)
    cost = torch.where(count >= full, cost, torch.full_like(cost, inf))

    best = torch.argmin(cost, dim=0)
    cmin = torch.gather(cost, 0, best[None])[0]

    # uniqueness: runner-up excluding the d-1, d+1 neighbours
    d_idx = torch.arange(num_disp, device=left.device)[:, None, None]
    near = torch.abs(d_idx - best[None, :, :]) <= 1
    c2 = torch.where(near, torch.full_like(cost, inf), cost).amin(dim=0)
    unique_ok = cmin * uniqueness_ratio <= c2

    # texture: average absolute prefiltered signal in the window
    tex = box_filter(torch.abs(lf), radius) / full
    tex_ok = tex > texture_threshold

    # subpixel parabola fit around the minimum
    bm1 = torch.clamp(best - 1, 0, num_disp - 1)
    bp1 = torch.clamp(best + 1, 0, num_disp - 1)
    c_m = torch.gather(cost, 0, bm1[None])[0]
    c_p = torch.gather(cost, 0, bp1[None])[0]
    denom = c_m + c_p - 2.0 * cmin
    interior = ((best > 0) & (best < num_disp - 1) & torch.isfinite(c_m)
                & torch.isfinite(c_p))
    delta = torch.where(
        interior & (denom > 1e-9),
        0.5 * (c_m - c_p) / torch.clamp(denom, min=1e-9),
        torch.zeros_like(denom),
    )
    disp = best.to(torch.float32) + torch.clamp(delta, -0.5, 0.5)

    valid = torch.isfinite(cmin) & unique_ok & tex_ok & (best > 0)

    if lr_check:
        # right-image costs from the same volume: cost_R(d)[v, u] =
        # cost_L(d)[v, u + d], +inf past the right edge
        h, w = left.shape
        uu = torch.arange(w, device=left.device)
        src = uu[None, :] + d_idx[:, :, 0]  # (D, W)
        cost_r = torch.gather(
            cost, 2, src.clamp(max=w - 1)[:, None, :].expand(-1, h, -1))
        cost_r = torch.where((src < w)[:, None, :], cost_r,
                             torch.full_like(cost_r, inf))
        best_r = torch.argmin(cost_r, dim=0)
        # |d_L(u) - d_R(u - d_L)| <= 1
        u_r = torch.clamp(uu[None, :] - best, 0, w - 1)
        d_r_at = torch.gather(best_r, 1, u_r)
        valid = valid & (torch.abs(best - d_r_at) <= 1)

    return torch.where(valid, disp, torch.full_like(disp, -1.0))
