"""Undistort + rectify maps (radial-tangential model), applied on the
device (port of scavislam_tpu.ops.rectify).

The reference's rectifier: OpenCV initUndistortRectifyMap semantics with a
5-coefficient (k1, k2, p1, p2, k3) distortion model and per-eye rectifying
rotations given as SO3 log vectors (cam.rot{x,y,z}_{left,right} in the
config). The map is built once on the host in float64 numpy; the per-frame
remap is a four-tap bilinear gather on the device (ops.image.bilinear_sample),
with the maps resident there.
"""

from __future__ import annotations

import numpy as np
import torch

from scavislam_tpu_torch import resolve_device
from scavislam_tpu_torch.core.camera import StereoCamera
from scavislam_tpu_torch.core.lie import SO3
from scavislam_tpu_torch.ops.image import U8_SCALE, bilinear_sample


def build_rectify_map(
    cam: StereoCamera,
    dist_coeffs,  # (k1, k2, p1, p2, k3)
    rot_log,  # (3,) SO3 log of the rectifying rotation
) -> np.ndarray:
    """(H, W, 2) float32 source-pixel map: destination pixel -> source
    pixel. For each destination pixel u: x = R^-1 K^-1 u (undo the
    rectification), the distortion model, then back through K. R is
    SO3.exp in float32, then cast to float64, as the twin takes it."""
    w, h = cam.size
    f = float(cam.focal)
    px, py = float(cam.pp[0]), float(cam.pp[1])
    k1, k2, p1, p2, k3 = [float(c) for c in dist_coeffs]

    R = SO3.exp(torch.as_tensor(np.asarray(rot_log, np.float32))).R
    Rinv = R.numpy().astype(np.float64).T

    us, vs = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    x = (us - px) / f
    y = (vs - py) / f
    ones = np.ones_like(x)
    vec = np.stack([x, y, ones], axis=-1) @ Rinv.T
    xn = vec[..., 0] / vec[..., 2]
    yn = vec[..., 1] / vec[..., 2]

    r2 = xn * xn + yn * yn
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = xn * radial + 2 * p1 * xn * yn + p2 * (r2 + 2 * xn * xn)
    yd = yn * radial + p1 * (r2 + 2 * yn * yn) + 2 * p2 * xn * yn

    map_u = xd * f + px
    map_v = yd * f + py
    return np.stack([map_u, map_v], axis=-1).astype(np.float32)


def remap(img: torch.Tensor, rect_map: torch.Tensor) -> torch.Tensor:
    """Apply a rectify map (bilinear; out-of-bounds -> 0)."""
    vals, _ = bilinear_sample(img, rect_map)
    return vals


def _rectify_stack(stacked: torch.Tensor, map_l: torch.Tensor,
                   map_r: torch.Tensor) -> torch.Tensor:
    """Remap the left and right planes of a stacked frame; further planes
    (external disparity) pass through untouched, as the reference
    rectifies only the images.

    dtype-preserving: a uint8 stack comes back uint8 (normalized as
    ``u8 * f32(1/255)``, bilinear in f32, then ``clip(x * 255 + 0.5)``
    truncated, which is cv::remap on 8u); so the frame step sees the same
    input type whether or not rectification is on."""
    is_u8 = stacked.dtype == torch.uint8
    f = stacked.to(torch.float32) * U8_SCALE if is_u8 else stacked
    planes = [remap(f[0], map_l)[None], remap(f[1], map_r)[None]]
    if f.shape[0] > 2:
        planes.append(f[2:])
    out = torch.cat(planes, dim=0)
    if is_u8:
        out = torch.clamp(out * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)
    return out


class Rectifier:
    """Both-eye rectifier built from a Config (the reference's
    FrameGrabber::intializeRectifier + rectifyFrame). `rectify_stacked` is
    the frame loop's entry: one remap per eye ahead of the frame step, on
    `device` (the CUDA card by default), where the maps stay; no host
    sync."""

    def __init__(self, cam: StereoCamera, cfg, device=None):
        self.enabled = bool(cfg.framepipe.rectify_frame)
        if self.enabled:
            self.device = resolve_device(device)
            self.map_left = torch.as_tensor(build_rectify_map(
                cam, cfg.cam.dist_left, cfg.cam.rot_left), device=self.device)
            self.map_right = torch.as_tensor(build_rectify_map(
                cam, cfg.cam.dist_right, cfg.cam.rot_right),
                device=self.device)

    def __call__(self, left, right):
        if not self.enabled:
            return left, right
        return remap(left, self.map_left), remap(right, self.map_right)

    def rectify_stacked(self, stacked):
        if not self.enabled:
            return stacked
        return _rectify_stack(stacked, self.map_left, self.map_right)
