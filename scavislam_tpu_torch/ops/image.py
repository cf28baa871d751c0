"""Image preprocessing: Gaussian pyramid, Sobel gradients, bilinear sampling
(port of scavislam_tpu.ops.image).

Images are float32 in [0, 1], shape (H, W); pyramids are tuples of
(H/2^l, W/2^l) tensors. The separable filters are rolled shifted adds with
the twin's wraparound borders: every consumer excludes a wider border
(FAST 3 px, dense tracking 2 px/level, patches 4 px, stereo its window).
"""

from __future__ import annotations

import numpy as np
import torch

NUM_PYR_LEVELS = 3


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


_PYR_K = np.array([1.0, 4.0, 6.0, 4.0, 1.0], dtype=np.float32) / 16.0


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """Gaussian blur (5-tap) + 2x decimation (cv::pyrDown)."""
    blurred = _sep_filter_1d(img, _PYR_K, axis=0)
    blurred = _sep_filter_1d(blurred, _PYR_K, axis=1)
    return blurred[::2, ::2].contiguous()


def build_pyramid(img: torch.Tensor, levels: int = NUM_PYR_LEVELS):
    """Return tuple of `levels` images, level 0 = input."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(pyr_down(pyr[-1]))
    return tuple(pyr)


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


U8_SCALE = float(np.float32(1.0 / 255.0))


def preprocess_frame(img: torch.Tensor, levels: int = NUM_PYR_LEVELS):
    """uint8 or float image -> {"pyr", "dx", "dy"}: per-level float32
    pyramid and Sobel gradients. A non-float32 image is normalized as
    ``x * f32(1/255)``, the multiply the twin's compiled division is."""
    if img.dtype != torch.float32:
        img = img.to(torch.float32) * U8_SCALE
    pyr = build_pyramid(img, levels)
    grads = [sobel_xy(lvl) for lvl in pyr]
    return {"pyr": pyr, "dx": tuple(g[0] for g in grads),
            "dy": tuple(g[1] for g in grads)}


def half_sample_disparity(disp: torch.Tensor, _unused=None,
                          factor: int = 2) -> torch.Tensor:
    """Decimate a level-0 disparity map to a coarser level without
    rescaling the values (the level cameras double the baseline, so f*b is
    level-invariant: core.camera.StereoCamera.scale_level)."""
    return disp[::factor, ::factor]


def float_to_index(x: torch.Tensor) -> torch.Tensor:
    """float -> int32 with XLA's conversion semantics: NaN -> 0, out-of-range
    values saturate (a plain ``.to(int32)`` is undefined there). Callers
    clamp the result into range before gathering, as the twin's gathers
    clamp silently."""
    x = torch.nan_to_num(x, nan=0.0, posinf=2.0e9, neginf=-2.0e9)
    return x.clamp(-2.0e9, 2.0e9).to(torch.int32)


def bilinear_sample(img: torch.Tensor, uv: torch.Tensor, *, fill=0.0):
    """Sample image at float pixel coords uv (..., 2) = (u=x, v=y).
    Out-of-bounds samples return ``fill``. Returns (values, valid_mask)."""
    h, w = img.shape
    u = uv[..., 0]
    v = uv[..., 1]
    valid = (u >= 0.0) & (v >= 0.0) & (u <= w - 1.0) & (v <= h - 1.0)
    u0c = float_to_index(torch.floor(u)).clamp(0, w - 2)
    v0c = float_to_index(torch.floor(v)).clamp(0, h - 2)
    # fractions relative to the CLIPPED base so u == w-1 samples exactly the
    # last column instead of repeating column w-2
    fu = u - u0c.to(u.dtype)
    fv = v - v0c.to(v.dtype)
    flat = img.reshape(-1)
    base = (v0c * w + u0c).long()
    i00 = flat[base]
    i01 = flat[base + 1]
    i10 = flat[base + w]
    i11 = flat[base + w + 1]
    top = i00 * (1.0 - fu) + i01 * fu
    bot = i10 * (1.0 - fu) + i11 * fu
    val = top * (1.0 - fv) + bot * fv
    return torch.where(valid, val, torch.full_like(val, fill)), valid


def nearest_sample(img: torch.Tensor, uv: torch.Tensor, *, fill=0.0):
    """Nearest-neighbour lookup (the reference's disparity lookups).
    Returns (values, valid_mask)."""
    h, w = img.shape
    u = float_to_index(torch.round(uv[..., 0]))
    v = float_to_index(torch.round(uv[..., 1]))
    valid = (u >= 0) & (v >= 0) & (u < w) & (v < h)
    uc = u.clamp(0, w - 1)
    vc = v.clamp(0, h - 1)
    val = img.reshape(-1)[(vc * w + uc).long()]
    return torch.where(valid, val, torch.full_like(val, fill)), valid
