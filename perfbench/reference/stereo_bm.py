# Frozen copy of the plain block matcher of scavislam_tpu_torch at commit
# 3511a3c, the benchmark's plain reference of the disparity: ops/stereo_bm.py
# (its constants, bm_plain, verbatim), and the inputs' preparation the
# step applies before it, verbatim from ops/image.py (_sep_filter_1d,
# binomial3, sobel_xy), ops/stereo.py (_sobel_x_prefilter) and
# models/frontend_step.py (the uint8 scale). It never launches the
# program's CUDA kernels. Do not edit; a later reference is a new file.
"""Block-matching stereo, plain PyTorch (the kernel's semantics): uint8
frames -> [0, 1] f32, the 3x3 binomial sensor-noise prefilter, the clipped
Sobel-x prefilter, then the cost-volume program of the kernel."""

from __future__ import annotations

import numpy as np
import torch

# uint8 -> [0, 1] as a multiply by the f32 reciprocal (the twin's compiled
# division)
U8_SCALE = float(np.float32(1.0 / 255.0))


def _sep_filter_1d(img: torch.Tensor, taps, axis: int) -> torch.Tensor:
    """Small 1-D correlation along `axis` via rolled adds (twin's order)."""
    taps = [float(t) for t in np.asarray(taps, np.float32)]
    r = len(taps) // 2
    out = None
    for i, w in enumerate(taps):
        if w == 0.0:
            continue
        term = torch.roll(img, r - i, dims=axis) * w
        out = term if out is None else out + term
    return out


_BINOMIAL3 = np.array([0.25, 0.5, 0.25], dtype=np.float32)


def binomial3(img: torch.Tensor) -> torch.Tensor:
    """3x3 binomial pre-smoothing (separable [1 2 1]/4): the sensor-noise
    prefilter of the stereo and corner-detection inputs."""
    return _sep_filter_1d(_sep_filter_1d(img, _BINOMIAL3, axis=0),
                          _BINOMIAL3, axis=1)


_SOBEL_DIFF = np.array([-1.0, 0.0, 1.0], dtype=np.float32)
_SOBEL_SMOOTH = np.array([1.0, 2.0, 1.0], dtype=np.float32)


def sobel_xy(img: torch.Tensor):
    """Sobel dx, dy with the reference's 1/8 scale (centred differences of
    a [0, 1] image)."""
    smooth_v = _sep_filter_1d(img, _SOBEL_SMOOTH, axis=0)
    dx = _sep_filter_1d(smooth_v, _SOBEL_DIFF, axis=1)
    smooth_h = _sep_filter_1d(img, _SOBEL_SMOOTH, axis=1)
    dy = _sep_filter_1d(smooth_h, _SOBEL_DIFF, axis=0)
    return dx * 0.125, dy * 0.125


def _sobel_x_prefilter(img: torch.Tensor, cap: float = 0.5) -> torch.Tensor:
    """OpenCV-StereoBM-style x-derivative prefilter, clipped."""
    dx, _ = sobel_xy(img)
    return torch.clamp(dx, -cap, cap)


BIG = 1.0e9


# -- plain PyTorch version ---------------------------------------------------

def _shift_cols(x: torch.Tensor, k: int, fill: float) -> torch.Tensor:
    """Column j reads j - k (k > 0: from the left; k < 0: from the right),
    `fill` where that column is outside the image."""
    pad = torch.full((*x.shape[:-1], abs(k)), fill, dtype=x.dtype,
                     device=x.device)
    if k > 0:
        return torch.cat([pad, x[..., :-k]], dim=-1)
    return torch.cat([x[..., -k:], pad], dim=-1)


def _box_h(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Horizontal (2r+1)-tap sum in the kernel's order u, u-1, u+1, u-2, ...
    with BIG for taps outside the image."""
    acc = x
    for k in range(1, radius + 1):
        acc = acc + _shift_cols(x, k, BIG)
        acc = acc + _shift_cols(x, -k, BIG)
    return acc


def _box_v(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Vertical (2r+1)-row sum, top row first (rows outside the image read
    0; those output rows are invalidated anyway)."""
    h = x.shape[-2]
    xp = torch.nn.functional.pad(x, (0, 0, radius, radius))
    acc = torch.zeros_like(x)
    for k in range(2 * radius + 1):
        acc = acc + xp[..., k:k + h, :]
    return acc


def bm_plain(lf: torch.Tensor, rf: torch.Tensor, num_disp: int = 64,
             radius: int = 5, uniqueness_ratio: float = 1.10,
             texture_threshold: float = 0.01) -> torch.Tensor:
    """Plain PyTorch version of the kernel on prefiltered images, as a
    (D, H, W) cost-volume program. Bit-for-bit the kernel's arithmetic."""
    h, w = lf.shape
    dev = lf.device
    D = num_disp
    col = torch.arange(w, device=dev)
    dd = torch.arange(D, device=dev)
    src = col[None, :] - dd[:, None]  # (D, W)
    rfd = rf[:, src.clamp(min=0)].permute(1, 0, 2)  # (D, H, W)
    diff = torch.where((src >= 0)[:, None, :], torch.abs(lf[None] - rfd),
                       torch.full_like(rfd, BIG))
    cost = _box_v(_box_h(diff, radius), radius)

    big = torch.full((h, w), BIG, dtype=lf.dtype, device=dev)
    best = torch.argmin(cost, dim=0)
    cmin = torch.gather(cost, 0, best[None])[0]
    has = cmin < BIG  # strict-< scan from BIG: no update leaves (0, BIG)
    best = torch.where(has, best, torch.zeros_like(best))
    cmin = torch.where(has, cmin, big)

    far = torch.abs(dd[:, None, None] - best[None]) > 1
    c2 = torch.where(far, cost, torch.full_like(cost, float("inf"))).amin(0)
    c2 = torch.minimum(c2, big)
    c_m = torch.where(
        best >= 1, torch.gather(cost, 0, (best - 1).clamp(min=0)[None])[0], big)
    c_p = torch.where(
        best <= D - 2,
        torch.gather(cost, 0, (best + 1).clamp(max=D - 1)[None])[0], big)

    tex = _box_v(_box_h(torch.abs(lf), radius), radius)
    # a tensor divisor: on a CUDA tensor PyTorch divides by a Python scalar
    # as a multiply by its reciprocal, one ulp off the kernel's IEEE
    # quotient, and the texture test compares that quotient to 0.01
    full = torch.full_like(tex, float((2 * radius + 1) ** 2))

    denom = c_m + c_p - 2.0 * cmin
    interior = (best > 0) & (best < D - 1) & (c_m < BIG) & (c_p < BIG)
    delta = torch.where(interior & (denom > 1e-9),
                        0.5 * (c_m - c_p) / torch.clamp(denom, min=1e-9),
                        torch.zeros_like(denom))
    disp = best.to(torch.float32) + torch.clamp(delta, -0.5, 0.5)

    # right-view winner: candidate for right pixel u is cost[d][u + d]
    ridx = col[None, :] + dd[:, None]  # (D, W)
    cl = torch.gather(cost, 2, ridx.clamp(max=w - 1)[:, None, :].expand(-1, h, -1))
    cl = torch.where((ridx < w)[:, None, :], cl, torch.full_like(cl, BIG))
    bestr = torch.argmin(cl, dim=0)
    bestr_c = torch.gather(cl, 0, bestr[None])[0]
    bestr = torch.where(bestr_c < BIG, bestr, torch.zeros_like(bestr))
    lr = torch.gather(bestr, 1, torch.remainder(col[None, :] - best, w))
    lr_ok = torch.abs(best - lr) <= 1

    row = torch.arange(h, device=dev)[:, None]
    in_img = (row >= radius) & (row < h - radius)
    valid = ((cmin < 1e4) & (cmin * uniqueness_ratio <= c2)
             & (tex / full > texture_threshold) & (best > 0) & in_img & lr_ok)
    return torch.where(valid, disp, torch.full_like(disp, -1.0))


def block_matching_disparity_bm(left, right, num_disp=64, radius=5,
                                uniqueness_ratio=1.10,
                                texture_threshold=0.01):
    """Prefilter, then the plain version, on the inputs' device."""
    return bm_plain(_sobel_x_prefilter(left), _sobel_x_prefilter(right),
                    num_disp, radius, uniqueness_ratio, texture_threshold)


def disparity_of_frames(frames_u8: torch.Tensor, num_disp: int = 64):
    """The disparity the frame step computes at stereo method 2 from a
    uint8 (2, H, W) stack."""
    f = frames_u8.to(torch.float32) * U8_SCALE
    return block_matching_disparity_bm(binomial3(f[0]), binomial3(f[1]),
                                       num_disp=num_disp, radius=5)
